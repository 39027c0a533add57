"""Image resizing as two GEMMs (the counterpart of
``optimaltextures_tpu/ops/resize.py``).

Each separable 1-D bicubic-antialias resampling (torch's
``interpolate(mode="bicubic", antialias=True)``, the reference's resize) is a
dense (out, in) weight matrix built on the host in float64, cached, and
applied as a matmul with the weights passed as runtime tensors.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def _bicubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    # A = -0.5: aten's antialiased bicubic (the PIL/Keys parameter)
    ax = np.abs(x)
    return np.where(
        ax <= 1.0,
        ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0,
        np.where(ax < 2.0, (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a, 0.0),
    )


@lru_cache(maxsize=256)
def resample_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 bicubic-antialias resampling matrix
    (aten's _compute_weights_aa convention: taps truncated at the border and
    renormalised)."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = in_size / out_size
    support = 2.0 * scale if scale > 1.0 else 2.0
    invscale = 1.0 / scale if scale > 1.0 else 1.0

    i = np.arange(out_size, dtype=np.float64)
    center = (i + 0.5) * scale
    xmin = np.maximum(0, (center - support + 0.5).astype(np.int64))
    xmax = np.minimum(in_size, (center + support + 0.5).astype(np.int64))

    W = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        j = np.arange(xmin[o], xmax[o])
        w = _bicubic_kernel((j - center[o] + 0.5) * invscale)
        s = w.sum()
        if s != 0.0:
            w = w / s
        W[o, j] = w
    return W.astype(np.float32)


def resample_pair(in_hw: Tuple[int, int], out_hw: Tuple[int, int]):
    """Host (wh, ww) float32 matrices for an (H, W) -> (H, W) resize."""
    return resample_matrix(in_hw[0], out_hw[0]), resample_matrix(in_hw[1], out_hw[1])


def apply_resample(x: torch.Tensor, wh: torch.Tensor,
                   ww: torch.Tensor) -> torch.Tensor:
    """NHWC x -> contract H with wh (out, in), then W with ww (out, in)."""
    y = torch.einsum("oh,nhwc->nowc", wh, x)
    return torch.einsum("ow,nhwc->nhoc", ww, y)
