"""Host-side image I/O and the self-describing output filename (the
counterpart of ``optimaltextures_tpu/utils/imageio.py``).

Pillow is imported inside the functions that decode or encode images, so the
package imports without it. Arrays are NHWC float32 in [0, 1].
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from . import schedule


def load_image(path: str, size: int, scale: float = 1.0, oversize: bool = True
               ) -> np.ndarray:
    """Decode + Lanczos-resize one image -> (1, H, W, 3) float32 in [0, 1].

    PIL's ``img.size`` is (width, height); the reference feeds the width as
    get_size's first dim — replicated, quirk included."""
    from PIL import Image

    img = Image.open(path).convert(mode="RGB")
    w0, h0 = img.size
    tw, th = schedule.get_size(size, scale, w0, h0, oversize)
    img = img.resize((tw, th), Image.LANCZOS)
    return (np.asarray(img, dtype=np.float32) / 255.0)[None]


def load_styles(style_files: List[str], size: int, scale: float) -> List[np.ndarray]:
    """Styles load with oversize=True (capped at the source dims)."""
    return [load_image(f, size, scale, oversize=True) for f in style_files]


def maybe_load_content(content_file: Optional[str], size: int) -> Optional[np.ndarray]:
    """Content loads with oversize=False (forced to size)."""
    if content_file is None:
        return None
    return load_image(content_file, size, scale=1.0, oversize=False)


def output_name(cfg) -> str:
    """The reference's underscore-joined config-encoding filename."""
    stem = lambda p: p.split("/")[-1].split(".")[0]
    parts = [stem(s) for s in cfg.style]
    if len(cfg.style) > 1:
        if getattr(cfg, "mixing_weights", None):
            parts += ["blendw" + "-".join(str(w) for w in cfg.mixing_weights)]
        else:
            parts += ["blend" + str(cfg.mixing_alpha)]
    if cfg.content is not None:
        parts += [stem(cfg.content), "strength" + str(cfg.content_strength)]
    if getattr(cfg, "init", None):
        parts += ["init-" + stem(cfg.init)]
    parts += [cfg.hist_mode + "hist"]
    if cfg.no_pca:
        parts += ["no_pca"]
    if cfg.no_multires:
        parts += ["no_multires"]
    if cfg.style_scale != 1:
        parts += ["scale" + str(cfg.style_scale)]
    if cfg.color_transfer is not None:
        parts += [cfg.color_transfer]
    if getattr(cfg, "tileable", False):
        parts += ["tileable"]
    if getattr(cfg, "out_width", None):
        parts += [f"{cfg.size}x{cfg.out_width}"]
    else:
        parts += [str(cfg.size)]
    return "_".join(parts)


def save_images(output: np.ndarray, cfg) -> List[str]:
    """Clamp to [0, 1] and write PNG(s); batch elements get _1.._N suffixes
    when B > 1."""
    from PIL import Image

    os.makedirs(cfg.output_dir, exist_ok=True)
    name = output_name(cfg)
    paths = []
    batch = output.shape[0]
    for i in range(batch):
        arr = np.clip(np.asarray(output[i], dtype=np.float32), 0.0, 1.0)
        img = Image.fromarray((arr * 255.0 + 0.5).astype(np.uint8))
        suffix = f"_{i + 1}" if batch > 1 else ""
        path = os.path.join(cfg.output_dir, f"{name}{suffix}.png")
        img.save(path)
        paths.append(path)
    return paths
