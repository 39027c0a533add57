"""Inputs from ``--seed``: the style exemplar, the noise pastiche and the
run key of each call, drawn on the device.

The exemplar is a frozen copy of the port's test texture
(``tools/edge_convs.style_exemplar``: smooth blobs at 8, 32 and 128 cells
plus fine grain, so every VGG depth sees structure), drawn with a
``torch.Generator`` on the card instead of numpy, so that a call's exemplar
costs no host work."""

from __future__ import annotations

import numpy as np
import torch

NOISE, STYLE, KEY = 1, 2, 3


def derive(*parts: int) -> int:
    """A 63-bit seed from integer parts (any size, negative too)."""
    ss = np.random.SeedSequence([int(p) % (2 ** 64) for p in parts])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _gen(device, *parts: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(*parts))
    return g


def style_exemplar(device, size: int, *parts: int) -> torch.Tensor:
    """A (1, size, size, 3) float32 texture in [0, 1]."""
    g = _gen(device, STYLE, *parts)
    img = torch.zeros((size, size, 3), device=device)
    for cells, amp in ((8, 0.5), (32, 0.3), (128, 0.2)):
        if cells > size:
            continue
        coarse = torch.rand((cells, cells, 3), generator=g, device=device) * 2 - 1
        rep = size // cells
        img += amp * coarse.repeat_interleave(rep, 0).repeat_interleave(rep, 1)
    img += 0.1 * torch.randn((size, size, 3), generator=g, device=device)
    return torch.clamp(0.5 + 0.5 * img, 0.0, 1.0)[None]


def noise(device, shape, *parts: int) -> torch.Tensor:
    """The noise pastiche: float32 uniforms in [0, 1)."""
    return torch.rand(tuple(shape), generator=_gen(device, NOISE, *parts),
                      device=device)


def run_key(*parts: int) -> int:
    return derive(KEY, *parts)
