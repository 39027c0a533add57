"""High-level library API (the counterpart of ``optimaltextures_tpu/api.py``):
texture synthesis from files in one call. Style transfer, mixing and color
transfer are ROADMAP items and raise NotImplementedError."""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from . import core
from .config import OptexConfig, require_ported
from .utils import imageio


def run_files(cfg: OptexConfig, verbose: bool = False, device=None
              ) -> Tuple[np.ndarray, float, List[str]]:
    """Load the style per cfg, synthesize, save PNG(s). Returns (output
    array NHWC, seconds, written paths). ``device`` None = the GPU."""
    cfg = require_ported(cfg.validate())
    styles = imageio.load_styles(cfg.style, cfg.size, cfg.style_scale)
    out, seconds = core.synthesize(cfg, styles, verbose=verbose, device=device)
    out_np = out.cpu().numpy()
    return out_np, seconds, imageio.save_images(out_np, cfg)


def synthesize_texture(style: str, size: int = 512, device=None,
                       **overrides) -> np.ndarray:
    """Texture synthesis from noise matched to one style exemplar."""
    out, _, _ = run_files(OptexConfig(style=[style], size=size, **overrides),
                          device=device)
    return out


def config_from_args(args) -> OptexConfig:
    """Build a config from an argparse Namespace with matching field names."""
    fields = {f.name for f in dataclasses.fields(OptexConfig)}
    return OptexConfig(**{k: v for k, v in vars(args).items() if k in fields})
