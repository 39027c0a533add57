"""Reading the device from ``torch.profiler``: a profiled stretch of calls,
retried when a session records no device time (now and then a session on
the H100 delivers no device events at all, as the port's
``tools/edge_convs.profiled_kernels`` found), and the reductions the
per-layer metrics take from it."""

from __future__ import annotations

import bisect
import sys
from typing import Callable, List, NamedTuple, Optional

WINDOW = "bench.window"


class Trace(NamedTuple):
    device: List[tuple]     # (name, start us, end us) of every device op
    host: List[tuple]       # (name, start us, end us) of host ops
    ops: List[tuple]        # (host op name, self device us, count)
    window_us: float        # the traced stretch, host clock
    start_us: float


def profile(fn: Callable[[], None], tries: int = 3, active: bool = True,
            agree: Callable[[bool], bool] = lambda ok: ok) -> Optional[Trace]:
    """Run ``fn`` (which ends in a synchronize) under the profiler; None if
    no try recorded device time. ``active`` False runs ``fn`` unprofiled
    (the other ranks of a multi-card cell), and ``agree`` gives every rank
    the profiling rank's verdict on each try."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    for attempt in range(tries):
        trace = None
        if active:
            with tprofile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function(WINDOW):
                    fn()
            trace = _read(prof, DeviceType)
        else:
            fn()
        if agree(trace is not None):
            return trace
        print(f"profiler session {attempt + 1} recorded no device time",
              file=sys.stderr, flush=True)
    print(f"torch.profiler recorded no device time in {tries} sessions: the "
          "device metrics of this run are left out", file=sys.stderr,
          flush=True)
    return None


def _read(prof, DeviceType) -> Optional[Trace]:
    device, host, win = [], [], None
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # a host range's annotation on the card's timeline (this
            # window's, or torch.distributed's "nccl:*") is not a device op
            if not getattr(e, "is_user_annotation", False) and \
                    e.name != WINDOW:
                device.append((e.name, float(tr.start), float(tr.end)))
        else:
            if e.name == WINDOW:
                win = (float(tr.start), float(tr.end))
            host.append((e.name, float(tr.start), float(tr.end)))
    if not device or win is None or sum(b - a for _, a, b in device) <= 0:
        return None
    ops = [(r.key, float(getattr(r, "self_device_time_total", 0.0)),
            int(r.count)) for r in prof.key_averages()
           if r.device_type != DeviceType.CUDA]
    return Trace(device, host, ops, win[1] - win[0], win[0])


def busy_us(trace: Trace) -> float:
    """The union of the device ops' intervals inside the traced window."""
    lo, hi = trace.start_us, trace.start_us + trace.window_us
    spans = sorted((max(a, lo), min(b, hi)) for _, a, b in trace.device
                   if b > lo and a < hi)
    total, cur_a, cur_b = 0.0, None, None
    for a, b in spans:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def kernel_us(trace: Trace, parts) -> tuple:
    """(device us, launches) of the device ops whose name holds any of
    ``parts``."""
    hits = [b - a for n, a, b in trace.device if any(p in n for p in parts)]
    return sum(hits), len(hits)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device ops that took most time, and the idle time between device
    ops by the innermost host op running when each gap began."""
    by_op = {}
    for n, a, b in trace.device:
        by_op[n] = by_op.get(n, 0.0) + (b - a)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted((a, b) for _, a, b in trace.device)
    gaps, end = [], trace.start_us
    for a, b in spans:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    stop = trace.start_us + trace.window_us
    if stop > end:
        gaps.append((end, stop))
    host = sorted((h for h in trace.host if h[0] != WINDOW),
                  key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle = {}
    for g0, g1 in gaps:
        # the innermost host op holding g0 began shortly before it
        name, width = "(no host op)", None
        i = bisect.bisect_right(starts, g0)
        for n, a, b in host[max(0, i - 256):i]:
            if b >= g0 and (width is None or b - a < width):
                name, width = n, b - a
        idle[name] = idle.get(name, 0.0) + (g1 - g0)
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], us / 1e6] for n, us in ops],
            "idle_gaps": [[n[:160], us / 1e6] for n, us in gaps_top]}
