"""High-level library API (the counterpart of ``optimaltextures_tpu/api.py``):
texture synthesis, style transfer, texture mixing and color transfer from
files in one call each."""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from . import core
from .config import OptexConfig, require_ported
from .utils import imageio


def run_files(cfg: OptexConfig, verbose: bool = False, device=None
              ) -> Tuple[np.ndarray, float, List[str]]:
    """Load the style (and content, and init) images per cfg, run, save
    PNG(s). Returns (output array NHWC, seconds, written paths). ``device``
    None = the GPU.

    ``cfg.init``: the starting pastiche in place of noise, loaded at
    ``size`` like a content image (``oversize=False``); with a content
    image both must load to the same shape."""
    cfg.validate()
    if cfg.init is not None and cfg.batch > 1:
        # every batch element would start identical AND share the run's
        # rotation stream -> N identical outputs for N x the device work
        raise ValueError("batch > 1 with --init produces identical images; "
                         "run batch=1")
    cfg = require_ported(cfg)
    styles = imageio.load_styles(cfg.style, cfg.size, cfg.style_scale)
    content = imageio.maybe_load_content(cfg.content, cfg.size)
    pastiche = None
    if cfg.init is not None:
        pastiche = imageio.load_image(cfg.init, cfg.size, oversize=False)
        if content is not None and pastiche.shape != content.shape:
            raise ValueError(
                f"--init image loads to {tuple(pastiche.shape)} but the "
                f"content loads to {tuple(content.shape)}; they must match")
    out, seconds = core.synthesize(cfg, styles, content, pastiche=pastiche,
                                   verbose=verbose, device=device)
    out_np = out.cpu().numpy()
    return out_np, seconds, imageio.save_images(out_np, cfg)


def synthesize_texture(style: str, size: int = 512, device=None,
                       **overrides) -> np.ndarray:
    """Texture synthesis from noise matched to one style exemplar."""
    out, _, _ = run_files(OptexConfig(style=[style], size=size, **overrides),
                          device=device)
    return out


def transfer_style(style: str, content: str, size: int = 512,
                   content_strength: float = 0.2, device=None,
                   **overrides) -> np.ndarray:
    """Style transfer: synthesis pulled toward a content image's structure."""
    out, _, _ = run_files(OptexConfig(style=[style], content=content, size=size,
                                      content_strength=content_strength,
                                      **overrides), device=device)
    return out


def mix_textures(style_a: str, style_b: str, *more_styles: str,
                 alpha: float = 0.5, weights=None, size: int = 512,
                 device=None, **overrides) -> np.ndarray:
    """Texture mixing with a random spatial mask: two styles blend by
    ``alpha`` (the reference's blend), three or more by ``weights`` (one
    positive weight per style, default uniform). ``alpha`` is keyword-only,
    so a float passed by position is refused instead of read as a path."""
    for s in (style_a, style_b, *more_styles):
        if not isinstance(s, str):
            raise TypeError(
                f"style paths must be strings, got {s!r} — if this was "
                "alpha, pass it by keyword: mix_textures(a, b, alpha=...)")
    out, _, _ = run_files(OptexConfig(style=[style_a, style_b, *more_styles],
                                      mixing_alpha=alpha,
                                      mixing_weights=weights, size=size,
                                      **overrides), device=device)
    return out


def transfer_color(style: str, content: str, mode: str = "opt",
                   size: int = 512, device=None, **overrides) -> np.ndarray:
    """Style transfer that keeps the content image's colors (lum | opt)."""
    out, _, _ = run_files(OptexConfig(style=[style], content=content,
                                      color_transfer=mode, size=size,
                                      **overrides), device=device)
    return out


def config_from_args(args) -> OptexConfig:
    """Build a config from an argparse Namespace with matching field names."""
    fields = {f.name for f in dataclasses.fields(OptexConfig)}
    return OptexConfig(**{k: v for k, v in vars(args).items() if k in fields})
