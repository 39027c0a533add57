"""The pass and width schedule, frozen: the reference's multires schedule
(``util.py:68-86`` of JCBrouwer/OptimalTextures, with its ``[l-1]``
column quirk), its ``get_size`` and the exclusive 90% PCA width rule."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# per-layer iteration share ~ (channels + 64)
_LAYER_WEIGHTS = np.array([64, 128, 256, 512, 512], dtype=np.float64) + 64
# relu{d}_1 channels
CHANNELS = {1: 64, 2: 128, 3: 256, 4: 512, 5: 512}


def iters_and_sizes(size: int, iters: int, passes: int, depth: int
                    ) -> Tuple[List[List[int]], List[int]]:
    """(iters[p][l], pass sizes): layer-loop position l = 0 is the deepest
    depth; the table keeps the shallowest ``depth`` columns of the 5-layer
    split and reads column (l - 1) mod 5 at position l."""
    per_pass = np.arange(2 * passes, passes, -1, dtype=np.float64)
    per_pass = per_pass / per_pass.sum() * iters
    sizes = (32 * np.round(np.linspace(256, size, passes) / 32)).astype(
        np.int64)
    table = (per_pass[:, None] * (_LAYER_WEIGHTS / _LAYER_WEIGHTS.sum())
             [None, :]).astype(np.int64)
    table = table[:, [(l - 1) % 5 for l in range(depth)]]
    return table.tolist(), [int(s) for s in sizes]


def round32(x: int) -> int:
    return int(x + 31) & -32


def get_size(size: int, h: int, w: int) -> Tuple[int, int]:
    """The style's (h, w) at pass size ``size`` (scale 1): the first dim is
    ``size`` itself, the second follows the aspect, both rounded up to 32."""
    return round32(size), round32(int(float(w) * (size / float(h))))


def choose_k(singular_values) -> int:
    """The first index where the cumulative share of the singular values
    exceeds 0.9 (the crossing component excluded), at least 1."""
    s = np.asarray(singular_values, dtype=np.float64)
    return max(int(np.argmax(np.cumsum(s / s.sum()) > 0.9)), 1)


def pass_plan(size: int, iters: int, passes: int, depth: int, in_hw):
    """[(pass size, resized?, iters per layer position)] of a square
    synthesis from a pastiche of ``in_hw``: a pass resizes unless either
    dim already equals its size."""
    table, sizes = iters_and_sizes(size, iters, passes, depth)
    plan, cur = [], tuple(in_hw)
    for p, s in enumerate(sizes):
        rs = cur[0] != s and cur[1] != s
        if rs:
            cur = (s, s)
        plan.append((s, rs, [int(i) for i in table[p]]))
    return plan
