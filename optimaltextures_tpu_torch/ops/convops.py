"""Conv building blocks on NHWC tensors: reflection and circular pads,
ceil-mode max-pool, nearest x2 upsample and the VALID conv.

Public functions take and return NHWC, as in ``optimaltextures_tpu/ops/
convops.py``; inside, they view the tensor as NCHW with channels-last strides
(``permute``, no copy), which is the layout cuDNN runs NHWC convs in. Weights
are OIHW, torch's layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def reflect_pad(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """Reflection-pad the two spatial dims of an NHWC tensor."""
    return to_nhwc(F.pad(to_nchw(x), (pad, pad, pad, pad), mode="reflect"))


def circular_pad(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """Circular (wrap) padding of the two spatial dims of an NHWC tensor:
    the tileable runs' padding, under which encode and decode commute with
    circular shifts (the JAX package's ``circular_pad``)."""
    return to_nhwc(F.pad(to_nchw(x), (pad, pad, pad, pad), mode="circular"))


def pad_spatial(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """``reflect`` (the reference's padding) or ``wrap`` (tileable)."""
    if mode == "reflect":
        return reflect_pad(x, pad)
    if mode == "wrap":
        return circular_pad(x, pad)
    raise ValueError(f"pad mode must be reflect|wrap, got {mode!r}")


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """VALID 2-D conv, stride 1: NHWC activations, OIHW weights.

    float32 fuses the bias into the conv. bfloat16 rounds twice, as the JAX
    package's ``conv2d_nhwc`` does: the conv's output rounds to bf16, then
    ``y + b`` is its own bf16 op."""
    if x.dtype == torch.bfloat16:
        y = to_nhwc(F.conv2d(to_nchw(x), w.to(x.dtype)))
        return y + b.to(y.dtype)
    return to_nhwc(F.conv2d(to_nchw(x), w, b))


def maxpool_2x2_ceil(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool with ceil_mode=True (the reference's pool)."""
    return to_nhwc(F.max_pool2d(to_nchw(x), 2, 2, ceil_mode=True))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample of NHWC."""
    return to_nhwc(F.interpolate(to_nchw(x), scale_factor=2, mode="nearest"))
