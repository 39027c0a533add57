"""Spans of a run on the profiler's clock.

:func:`span` marks a part of the program as a ``torch.profiler``
``record_function`` range. Its host interval lands in the same Kineto
timeline as the device ops launched inside it, linked to them by
correlation id, so a trace can say which part of a run each device op
(the codec and cdf kernels launched through ``ctypes`` included) and each
idle gap belongs to. Tracing is on exactly when a profiler session is (the
CLI's ``--profile_dir``, the benchmark's traced calls); without one a span
is one shared no-op context and builds nothing.

The span tree of :meth:`core.Synthesizer.run` (names fixed; pass indices,
depths and widths go in ``args``)::

    optex.run            the run key, batch, size, hist_mode
      optex.inputs       the pastiche, styles and content to the device
      optex.style_prep   style prep of every pass
        optex.style_encode   resize, multi-tap encode, PCA spectra
        optex.targets        widths, projected statistics, content prep
          optex.fetch        the eigenvalues for the host's width decisions
      optex.pass         p, size
        optex.resize         the multires resize and the cast to the conv dtype
        optex.stage          depth, C, k, iters
          optex.encode       the codec's encode and the widen to float32
          optex.project      features onto the PCA basis
          optex.rotations    the stage's rotation stack (the polar draw)
          optex.ot_steps     the transport: steps, C, N
          optex.unproject    back from the PCA basis
          optex.decode       the cast to the conv dtype and the codec's decode
      optex.gather       the chunks' or the ranks' outputs put together
      optex.color_tail   the color-transfer tail
      optex.quantize     the uint8 result

Every device op a run launches lies in a leaf of this tree (a span without
``optex`` children; ``optex.fetch`` may sit inside any span).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Union

import torch

_NOOP = contextlib.nullcontext()


def span(name: str, args: Union[str, Callable[[], str], None] = None):
    """A ``record_function`` range named ``name`` while a profiler session
    is on, else the shared no-op context. ``args`` is a string, or a
    zero-argument callable that makes one, called only while tracing."""
    if not torch.autograd._profiler_enabled():
        return _NOOP
    if callable(args):
        args = args()
    return torch.profiler.record_function(name, args)


def fetch(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: the one way a run moves a tensor off the device
    (each such copy waits for the device), in an ``optex.fetch`` span."""
    with span("optex.fetch"):
        return t.cpu()
