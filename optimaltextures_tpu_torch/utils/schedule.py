"""Static iteration/size schedules (a copy of
``optimaltextures_tpu/utils/schedule.py``; the port imports nothing from the
JAX package).

Reproduces the reference scheduler exactly (upstream ``util.py:68-86``)
including the infamous ``[l-1]`` column-indexing quirk at the consumption site
(``optex.py:112``): the layer loop index l = 0..L-1 (deep -> shallow) indexes
the schedule row with ``l-1``, i.e. python-wraps so layer 0 reads the LAST
column. BASELINE parity requires replicating that layout; ``quirk=False``
gives the intended monotone-by-depth split.

Everything here is host-side numpy.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# Per-layer iteration share ~ (channels + 64); reference util.py:82-83.
_LAYER_WEIGHTS = np.array([64, 128, 256, 512, 512], dtype=np.float64) + 64


def iters_and_sizes(size: int, iters: int, passes: int, use_multires: bool,
                    quirk: bool = True, num_layers: int = 5,
                    ) -> Tuple[List[List[int]], List[int]]:
    """Return (iters_per_pass_and_layer, pass_sizes).

    ``iters_per_pass_and_layer[p][l]`` is the sliced-OT iteration count for
    pass p at layer-loop position l (l=0 is the deepest layer). With
    ``quirk=True`` the columns are rotated exactly as the reference consumes
    them, so downstream code can index [p][l] directly.

    ``num_layers < 5`` (missing deep checkpoints) truncates the layer axis to
    the SHALLOWEST num_layers entries of the 5-layer proportion table while
    keeping pass totals: the budget of unavailable deep layers is dropped,
    matching what the reference would do if its deep encoders were absent.
    """
    if use_multires:
        per_pass = np.arange(2 * passes, passes, -1, dtype=np.float64)
        per_pass = per_pass / per_pass.sum() * iters
        sizes = np.linspace(256, size, passes)
        # nearest multiple of 32 so 4 max-pools keep even resolutions
        sizes = (32 * np.round(sizes / 32)).astype(np.int64)
    else:
        per_pass = np.ones(passes) * int(iters / passes)
        sizes = np.array([size] * passes, dtype=np.int64)

    proportions = _LAYER_WEIGHTS / _LAYER_WEIGHTS.sum()
    table = (per_pass[:, None] * proportions[None, :]).astype(np.int64)  # (passes, 5)

    if quirk:
        # optex.py:112 reads column (l-1) mod 5 at layer-loop position l
        # (position 0 = deepest layer); python-wraps to the LAST column at l=0.
        cols = [(l - 1) % 5 for l in range(num_layers)]
    else:
        # intended mapping: depth d draws its channel-count-proportional share,
        # column d-1 (deepest layer gets the most iterations).
        cols = [num_layers - l - 1 for l in range(num_layers)]
    table = table[:, cols]

    return table.tolist(), [int(s) for s in sizes]


def round32(x: int) -> int:
    """Round UP to a multiple of 32 (reference util.py:93-94)."""
    return int(x + 31) & -32


def get_size(size: int, scale: float, h: int, w: int, oversize: bool = False
             ) -> Tuple[int, int]:
    """Target (first, second) dims for a resize, reference util.py:33-42
    semantics replicated exactly — including the quirk that with
    ``oversize=False`` the returned first dim is the UNSCALED ``size``
    argument while the second dim carries the scale (the reference only
    folds ``scale`` into the first dim on the ``oversize`` branch)."""
    ssize = size * scale
    wpercent = ssize / float(h)
    hsize = int(float(w) * wpercent)
    if oversize:
        size = min(int(ssize), h)
        hsize = min(hsize, w)
    return round32(size), round32(hsize)
