"""RGB <-> HLS conversion and the lightness swap of color transfer (the
counterpart of ``optimaltextures_tpu/ops/colors.py``).

Kornia's HLS convention, as the reference uses it: channel order (H, L, S)
with H in radians [0, 2*pi), L and S in [0, 1]. NHWC, elementwise, with
branchless selects.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8
TWO_PI = 2.0 * math.pi


def rgb_to_hls(rgb: torch.Tensor) -> torch.Tensor:
    """NHWC RGB in [0, 1] -> NHWC (H[rad], L, S)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    l = (maxc + minc) / 2.0
    delta = maxc - minc
    zero = torch.zeros_like(delta)

    # saturation: delta / (1 - |2l - 1|), guarded for gray and extremes
    denom = 1.0 - torch.abs(2.0 * l - 1.0)
    s = torch.where(delta > 0, delta / torch.clamp(denom, min=_EPS), zero)

    # hue sector selection
    safe_delta = torch.where(delta > 0, delta, torch.ones_like(delta))
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), zero) * TWO_PI
    return torch.stack([h, l, s], dim=-1)


def hls_to_rgb(hls: torch.Tensor) -> torch.Tensor:
    """NHWC (H[rad], L, S) -> NHWC RGB."""
    h = torch.remainder(hls[..., 0] / TWO_PI, 1.0)
    l, s = hls[..., 1], hls[..., 2]
    m2 = torch.where(l <= 0.5, l * (1.0 + s), l + s - l * s)
    m1 = 2.0 * l - m2

    def channel(hue):
        hue = torch.remainder(hue, 1.0)
        return torch.where(
            hue < 1.0 / 6.0, m1 + (m2 - m1) * hue * 6.0,
            torch.where(hue < 0.5, m2,
                        torch.where(hue < 2.0 / 3.0,
                                    m1 + (m2 - m1) * (2.0 / 3.0 - hue) * 6.0,
                                    m1)))

    return torch.stack([channel(h + 1.0 / 3.0), channel(h),
                        channel(h - 1.0 / 3.0)], dim=-1)


def swap_lightness(content_rgb: torch.Tensor,
                   pastiche_rgb: torch.Tensor) -> torch.Tensor:
    """The content's hue and saturation with the pastiche's lightness: the
    'lum' color-transfer target."""
    hls = rgb_to_hls(content_rgb)
    hls = torch.stack([hls[..., 0], rgb_to_hls(pastiche_rgb)[..., 1],
                       hls[..., 2]], dim=-1)
    return hls_to_rgb(hls)
