"""Single dataclass config consumed by the library API and the CLI.

Same field names and validation as ``optimaltextures_tpu/config.py`` so the CLI
flags and saved configs carry over. Fields whose features are not ported yet
are accepted here and refused by :func:`require_ported` with the ROADMAP item
that ports them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional


@dataclasses.dataclass
class OptexConfig:
    # --- algorithm -----------------------------------------------------------
    size: int = 512
    passes: int = 5
    iters: int = 500
    hist_mode: str = "chol"           # sym | pca | chol | cdf | sort
    color_transfer: Optional[str] = None   # None | lum | opt
    content_strength: float = 0.01
    style_scale: float = 1.0
    mixing_alpha: float = 0.5
    mixing_weights: Optional[List[float]] = None
    no_pca: bool = False
    no_multires: bool = False
    batch: int = 1
    out_width: Optional[int] = None
    seed: Optional[int] = None

    # --- fidelity / compat ---------------------------------------------------
    compat_schedule_quirk: bool = True   # the reference's [l-1] schedule quirk
    depth: Optional[int] = None          # None = deepest available weights
    content_anchor: str = "index"        # index | depth
    tileable: bool = False

    # --- performance ---------------------------------------------------------
    conv_dtype: str = "float32"       # float32 | bfloat16
    num_devices: int = 1
    spatial_devices: int = 1
    use_pallas: bool = True           # cdf-mode kernels (not ported yet)
    cov_propagation: bool = True
    batch_chunk: int = 0
    # Route the relu1/relu2-scale codec convs of every stage roundtrip through
    # the CUDA kernels of ops/codec.py. False (the F.conv2d codec) is a CPU
    # reference and raises on a GPU (models/fastcodec.eligible).
    fast_codec: bool = True
    pca_bucket: int = 0
    pca_traced_k: bool = False

    # --- I/O -----------------------------------------------------------------
    style: List[str] = dataclasses.field(default_factory=lambda: ["style/graffiti.jpg"])
    content: Optional[str] = None
    init: Optional[str] = None
    output_dir: str = "output/"

    def validate(self) -> "OptexConfig":
        if self.hist_mode not in ("sym", "pca", "chol", "cdf", "sort"):
            raise ValueError(
                f"hist_mode must be sym|pca|chol|cdf|sort, got {self.hist_mode!r}")
        if self.color_transfer not in (None, "lum", "opt"):
            raise ValueError(f"color_transfer must be lum|opt, got {self.color_transfer!r}")
        if not 1 <= len(self.style) <= 8:
            raise ValueError("between 1 and 8 style images required")
        if self.mixing_weights is not None:
            if len(self.mixing_weights) != len(self.style):
                raise ValueError(
                    f"mixing_weights needs one weight per style "
                    f"({len(self.style)}), got {len(self.mixing_weights)}")
            if not all(math.isfinite(w) and w > 0 for w in self.mixing_weights):
                raise ValueError("mixing_weights must be finite and positive")
        if self.passes < 1 or self.iters < 1 or self.size < 32 or self.batch < 1:
            raise ValueError("passes/iters/size/batch out of range")
        if self.conv_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"conv_dtype must be float32|bfloat16, got {self.conv_dtype!r}")
        if self.pca_bucket < 0:
            raise ValueError("pca_bucket must be >= 0")
        if self.batch_chunk < 0:
            raise ValueError("batch_chunk must be >= 0")
        if self.pca_traced_k and self.pca_bucket:
            raise ValueError("pca_traced_k runs at the full channel width; "
                             "pca_bucket does not apply (set one, not both)")
        if self.pca_traced_k and self.no_pca:
            raise ValueError("pca_traced_k needs PCA enabled")
        if self.out_width is not None:
            if self.content is not None:
                raise ValueError("out_width applies to synthesis only")
            if self.out_width < 32 or self.out_width % 32:
                raise ValueError("out_width must be a multiple of 32")
        if self.content_anchor not in ("index", "depth"):
            raise ValueError(
                f"content_anchor must be index|depth, got {self.content_anchor!r}")
        return self


# (condition, feature, ROADMAP.md queue-1 item that ports it)
_NOT_PORTED = [
    (lambda c: c.hist_mode in ("cdf", "sort"), "hist_mode cdf/sort", 10),
    (lambda c: c.content is not None, "content / style transfer", 11),
    (lambda c: c.color_transfer is not None, "color transfer", 11),
    (lambda c: len(c.style) > 1, "texture mixing", 12),
    (lambda c: c.conv_dtype != "float32", "conv_dtype bfloat16", 13),
    (lambda c: c.tileable, "tileable output", 13),
    (lambda c: c.batch != 1, "batch > 1", 13),
    (lambda c: c.out_width is not None, "out_width", 13),
    (lambda c: c.init is not None, "init image", 13),
    (lambda c: c.pca_bucket != 0 or c.pca_traced_k, "pca_bucket / pca_traced_k", 13),
    (lambda c: c.batch_chunk != 0, "batch_chunk", 13),
    (lambda c: not c.cov_propagation, "the iterative (cov_propagation=False) "
     "transport loop", 13),
    (lambda c: c.num_devices != 1 or c.spatial_devices != 1,
     "multi-device runs", 15),
]


def require_ported(cfg: OptexConfig) -> OptexConfig:
    """Raise NotImplementedError for any setting outside the ported slice."""
    for bad, what, item in _NOT_PORTED:
        if bad(cfg):
            raise NotImplementedError(
                f"{what} is not ported to the torch package yet "
                f"(ROADMAP.md, queue 1 item {item})")
    return cfg
