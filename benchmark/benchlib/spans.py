"""The program's own spans in a traced run, and the device time each one
launched.

The port marks the parts of a run with ``torch.profiler`` ranges named
``optex.*`` (its ``utils/trace.span``); they reach the harness among the
host ops of ``profiling.Trace``. The trace keeps each host op's and each
device op's interval, but not the correlation id that links a device op to
the launch call that queued it. On one stream the device runs its ops in
the order they were queued, so the k-th launch call of a kind (kernel,
copy, set) queued the k-th device op of that kind. :func:`span_device_us`
pairs them so, and checks the pairing against the profiler's own linked
figures: the self device time of every ``aten`` op name (``Trace.ops``)
must come out the same from the pairs. A trace where the counts or the
check fail gives None, and the metrics read from it are left out of the
line rather than misread.

A device op belongs to a span when the call that launched it began inside
the span's host interval (a parent span holds its children's ops). A
program without ``optex`` spans (one older than them) gives None."""

from __future__ import annotations

import bisect
import sys
from typing import List, Optional

PREFIX = "optex."
# the pairing may miss the linked figures by this share of the paired
# device time (rounding of the profiler's microseconds)
AGREE = 0.01


def _launch_kind(name: str) -> Optional[str]:
    """The kind of device op a CUDA runtime or driver call queues, or None
    for a call that queues none."""
    if name.startswith(("cudaLaunch", "cuLaunch")):
        return "kernel"
    if name.startswith("cudaMemcpy"):
        return "copy"
    if name.startswith("cudaMemset"):
        return "set"
    return None


def _op_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "set"
    return "kernel"


def _is_api_call(name: str) -> bool:
    """A CUDA runtime or driver call (``cudaX``, ``cuX``), not a program
    op or range."""
    for p in ("cuda", "cu"):
        if name.startswith(p) and name[len(p):len(p) + 1].isupper():
            return True
    return False


def _pairs(trace) -> Optional[List[tuple]]:
    """(launch call's host start us, device op us) for every device op, in
    launch order; None when a kind's calls and ops differ in number."""
    calls, ops = {}, {}
    for name, a, _ in trace.host:
        k = _launch_kind(name)
        if k is not None:
            calls.setdefault(k, []).append(a)
    for name, a, b in trace.device:
        ops.setdefault(_op_kind(name), []).append((a, b - a))
    pairs = []
    for k in set(calls) | set(ops):
        c, o = sorted(calls.get(k, [])), sorted(ops.get(k, []))
        if len(c) != len(o):
            print(f"spans: {len(c)} {k} launch calls, {len(o)} {k} device "
                  "ops: no pairing", file=sys.stderr, flush=True)
            return None
        pairs += [(t, us) for t, (_, us) in zip(c, o)]
    pairs.sort()
    return pairs


def _innermost(intervals: List[tuple], points: List[float]) -> List:
    """For each of the sorted ``points``, the innermost of the
    (name, start, end) ``intervals`` holding it (properly nested), or
    None."""
    ivs = sorted(intervals, key=lambda iv: (iv[1], -iv[2]))
    out, stack, j = [], [], 0
    for t in points:
        while j < len(ivs) and ivs[j][1] <= t:
            while stack and stack[-1][2] < ivs[j][1]:
                stack.pop()
            stack.append(ivs[j])
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def _agrees(trace, pairs) -> bool:
    """The pairs' device time by innermost ``aten`` op against the
    profiler's linked self device time of each ``aten`` op name."""
    ops = [h for h in trace.host if not _is_api_call(h[0])]
    mine = {}
    for (_, us), op in zip(pairs, _innermost(ops, [t for t, _ in pairs])):
        if op is not None and "::" in op[0]:
            mine[op[0]] = mine.get(op[0], 0.0) + us
    theirs = {n: us for n, us, _ in trace.ops if "::" in n}
    off = sum(abs(mine.get(n, 0.0) - theirs.get(n, 0.0))
              for n in set(mine) | set(theirs))
    total = sum(us for _, us in pairs)
    if off > AGREE * total:
        print(f"spans: the pairing misses the profiler's linked aten device "
              f"time by {off:.0f} us of {total:.0f}", file=sys.stderr,
              flush=True)
        return False
    return True


def span_device_us(trace) -> Optional[List[tuple]]:
    """(name, host start us, host end us, device us launched inside) of
    every ``optex`` span, or None (no spans, or no sound pairing)."""
    if trace is None:
        return None
    spans = [h for h in trace.host if h[0].startswith(PREFIX)]
    if not spans:
        return None
    pairs = _pairs(trace)
    if pairs is None or not _agrees(trace, pairs):
        return None
    starts = [t for t, _ in pairs]
    cum = [0.0]
    for _, us in pairs:
        cum.append(cum[-1] + us)
    return [(n, a, b, cum[bisect.bisect_right(starts, b)]
             - cum[bisect.bisect_left(starts, a)]) for n, a, b in spans]


def ms_per_image(ctx, names) -> Optional[float]:
    """Device ms launched inside the spans named ``names`` (``optex.`` and
    a leaf's name), per image of the traced calls."""
    got = span_device_us(ctx.trace)
    if got is None:
        return None
    us = sum(d for n, _, _, d in got if n in names)
    return us / 1e3 / ctx.traced_images()


def fetches_per_call(ctx) -> Optional[float]:
    """``optex.fetch`` spans (the program's copies to the host, each a wait
    for the device) per traced call."""
    if ctx.trace is None:
        return None
    names = [h[0] for h in ctx.trace.host]
    if PREFIX + "run" not in names:
        return None
    return names.count(PREFIX + "fetch") / len(ctx.result["traced_calls"])
