"""Single dataclass config consumed by the library API and the CLI.

Same field names and validation as ``optimaltextures_tpu/config.py`` so the CLI
flags and saved configs carry over.

Two process knobs are read from the environment each time the code that
consumes them runs (not at import), as in the JAX package:

* ``OPTEX_PREP_PREFETCH_GB`` (:func:`prep_prefetch_bytes`): the all-pass
  style-prep budget above which ``Synthesizer.run`` switches to the
  low-memory prep (override hook: ``core.Synthesizer._PREP_PREFETCH_BYTES``);
* ``OPTEX_NO_COV_PROP=1`` (:func:`cov_propagation_env_off`): force the
  per-iteration moment loop, overriding ``OptexConfig.cov_propagation``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional

# the JAX package's default (optimaltextures_tpu/config.py), kept so that both
# packages take the same prep branch at the same sizes
_PREP_PREFETCH_GB_DEFAULT = 4.0


def prep_prefetch_bytes() -> int:
    """All-pass style-prep prefetch budget in bytes, read at call time."""
    return int(float(os.environ.get("OPTEX_PREP_PREFETCH_GB",
                                    _PREP_PREFETCH_GB_DEFAULT)) * 2 ** 30)


def cov_propagation_env_off() -> bool:
    """OPTEX_NO_COV_PROP=1 force-disables covariance propagation, read at
    call time."""
    return os.environ.get("OPTEX_NO_COV_PROP") == "1"


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
    # Route the cdf steps (hist_mode="cdf" and color_transfer="opt") through
    # the CUDA histogram and PWL-remap kernels of ops/cdf.py. False (their
    # plain versions) is a CPU reference and raises on a GPU (core.Synthesizer).
    use_pallas: bool = True
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
        if self.batch_chunk > 0:
            if self.hist_mode in ("cdf", "sort"):
                raise ValueError(
                    "batch_chunk needs a moment hist_mode (chol|pca|sym): "
                    "cdf/sort iterate over the full sample cloud and cannot "
                    "be chunked")
            if not self.cov_propagation:
                raise ValueError("batch_chunk requires cov_propagation (the "
                                 "chunked path applies the composed stage "
                                 "map)")
            if self.batch % self.batch_chunk:
                raise ValueError(
                    f"batch {self.batch} not divisible by batch_chunk "
                    f"{self.batch_chunk}")
            if self.spatial_devices > 1:
                raise ValueError("batch_chunk shards the batch axis only; "
                                 "it does not compose with spatial (H-axis) "
                                 "sharding")
            if self.num_devices > 1:
                local = self.batch // self.num_devices
                if local % self.batch_chunk:
                    raise ValueError(
                        f"per-device batch {local} (batch {self.batch} / "
                        f"num_devices {self.num_devices}) not divisible by "
                        f"batch_chunk {self.batch_chunk}")
            if self.content is not None:
                raise ValueError("batch_chunk applies to synthesis only "
                                 "(content runs are single-image)")
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
        if self.spatial_devices > 1:
            if self.num_devices > 1:
                if self.batch % self.num_devices:
                    raise ValueError(
                        f"batch {self.batch} not divisible by num_devices "
                        f"{self.num_devices} (2-D grid)")
                if self.content is not None:
                    raise ValueError("the 2-D grid is synthesis-only "
                                     "(content runs are single-image; use "
                                     "spatial_devices alone)")
            elif self.batch != 1:
                raise ValueError("spatial sharding alone runs a single "
                                 "image (batch must be 1); combine with "
                                 "num_devices > 1 for a batched 2-D grid")
        return self

