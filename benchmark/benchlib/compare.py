"""The comparison that decides ``correct``.

The program's run is followed pass by pass: for one call of the window,
drawn from the seed, :class:`Recorder` keeps each pass's input, its PCA
bases and its output as the timed path made them (the program's pass
body, ``core._pass_stages_impl`` or ``core._pass_stages_chunked_impl``,
wrapped for that call only, whatever calls it), with the call's uint8
result. Once the window has closed, the plain reference (``reference.py``)
runs every pass again from the program's own input of that pass, with its
own style prep, PCA widths and rotations, and three numbers are compared:

* ``pass_rel_rms``: the worst pass's ||program - reference|| / ||reference||
  over its output pixels (float32);
* ``link_rel_rms``: the worst gap between a pass's input and what it must
  be: the benchmark's noise for the first pass, the previous pass's output
  after that. Where the program resizes outside the pass (the spatial
  path), the reference takes the noise or the previous output itself and
  resizes it inside its pass, so that the resize is judged with the pass;
* ``u8_rel_rms``: the worst image's ||u8 - reference|| / ||reference|| of
  the call's uint8 result against the reference's last pass, quantized;
* ``ot_rel_rms``: the first OT stage's (the first pass's deepest)
  ||program - reference|| / ||reference|| over its output features, the
  reference's OT run from the program's input of that stage: the
  statistics and the OT alone, with no codec in between, so that their
  precision shows where the codec's rounding would hide it. In cdf mode
  the stage's first step alone: over a stage's steps cdf matching
  amplifies any rounding (about 4% after five steps at 256 px).

A pass is compared alone because the runs are sensitive: bf16 runs part
pixel by pixel under any other summation order, and cdf runs are chaotic
at pass granularity, so two whole runs of one algorithm need not agree.
The reference's eigenvectors take the signs of the program's (the sign is
the eigensolver's choice, and the pass depends on it through the
rotations); everything else of the basis is the reference's own.

Each control is the reference in a lower precision put in the program's
place, on the configured reference's PCA bases and the program's pass
inputs, judged by the same numbers against the configured reference."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import reference, schedule


class Recorder:
    """While entered, every call of the program's pass body appends
    (its pastiche, [each stage's PCA basis or None], its output) to
    ``passes``, and the first OT stage (``transport.transport_loop``: the
    first pass's deepest stage), or in cdf mode its first step
    (``transport._sampled_step_with_rot``), leaves (its input, its output)
    in ``stage``."""

    BODIES = ("_pass_stages_impl", "_pass_stages_chunked_impl")

    def __init__(self, core, mode: str):
        self.core = core
        self.ot = (("_sampled_step_with_rot", 1) if mode == "cdf"
                   else ("transport_loop", 1))
        self.passes: List[tuple] = []
        self.stage = None

    def _hook(self, orig):
        def hooked(*args, **kw):
            out = orig(*args, **kw)
            pastiche = args[2] if len(args) > 2 else kw["pastiche"]
            targets = args[3] if len(args) > 3 else kw["targets"]
            self.passes.append((pastiche, [getattr(t, "eigvecs", None)
                                           for t in targets], out))
            return out
        return hooked

    def _hook_ot(self, orig):
        at = self.ot[1]         # the feature's place in the arguments

        def first(*args, **kw):
            if self.stage is not None:
                return orig(*args, **kw)
            x = args[at].detach().clone()
            out = orig(*args, **kw)
            self.stage = (x, out)
            return out
        return first

    def __enter__(self):
        tr = self.core.transport
        self._orig = [(self.core, n, getattr(self.core, n))
                      for n in self.BODIES if hasattr(self.core, n)]
        for mod, n, f in self._orig:
            setattr(mod, n, self._hook(f))
        self._orig.append((tr, self.ot[0], getattr(tr, self.ot[0])))
        setattr(tr, self.ot[0], self._hook_ot(self._orig[-1][2]))
        return self

    def __exit__(self, *exc):
        for mod, n, f in self._orig:
            setattr(mod, n, f)
        return False


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return math.inf
    d = torch.linalg.vector_norm((a.float() - b.float()).double())
    return float(d / max(float(torch.linalg.vector_norm(b.double())), 1e-30))


def u8_rel_rms(u8: torch.Tensor, ref_u8: torch.Tensor) -> float:
    """The worst image's ||u8 - ref|| / ||ref|| over its uint8 values."""
    if u8.shape != ref_u8.shape:
        return math.inf
    a = u8.reshape(u8.shape[0], -1).double()
    b = ref_u8.reshape(ref_u8.shape[0], -1).double()
    d = torch.linalg.vector_norm(a - b, dim=1)
    return float((d / torch.linalg.vector_norm(b, dim=1).clamp(min=1.0)).max())


def readings(banks, style: torch.Tensor, noise: torch.Tensor, run_key: int,
             passes_in, passes_out, u8: torch.Tensor, *, size: int,
             iters: int, passes: int, depth: int, mode: str,
             precisions=("float32",), passes_bases=None, stage=None
             ) -> Dict[str, Dict[str, float]]:
    """{precision: {number: reading}} of the program's recorded call against
    the reference in the first of ``precisions`` (the configuration's);
    each further one is a control: the reference in that precision put in
    the program's place, on the configured reference's PCA bases and the
    program's pass inputs, against the same. ``banks``: {conv dtype:
    reference.Bank}; ``passes_bases``: the program's bases of each pass
    (deepest first), whose eigenvector signs the reference takes;
    ``stage``: (input, output) of the program's first OT stage (cdf: its
    first step), which the reference follows from that input
    (``ot_rel_rms``)."""
    plan = schedule.pass_plan(size, iters, passes, depth, noise.shape[1:3])
    reference.full_float32()
    n = len(passes_in)

    # each pass's input for the reference, and the links that are checked
    inputs, links = [], []
    for p, x in enumerate(passes_in):
        want = noise if p == 0 else passes_out[p - 1]
        if tuple(want.shape[1:3]) == tuple(x.shape[1:3]):
            links.append(_rel(x, want))
            inputs.append(x)
        else:
            # resized outside the pass: the reference resizes it itself
            inputs.append(want)

    def styles():
        """(pass, style prep key, the pass's style at its size)."""
        for p, (s, rs, _) in enumerate(plan[:n]):
            yield p, (s if rs else None), (reference.resize(
                style, schedule.get_size(s, style.shape[1], style.shape[2]))
                if rs else style)

    def ot_stage(prec, preps):
        """The reference's OT of the first pass's deepest stage (cdf: its
        first step) from the program's input of it."""
        if stage is None or not n:
            return None
        key = next(styles())[1]
        return reference.transport(
            stage[0].float(), preps[key][0], run_key=run_key, pass_idx=0,
            stage=0, n_iters=plan[0][2][0], mode=mode, prec=prec,
            steps=1 if mode == "cdf" else None)

    def run_all(prec, preps):
        return [reference.run_pass(
            banks[prec.conv_dtype], preps[key], inputs[p], size=s,
            iters=n_iters, pass_idx=p, run_key=run_key, mode=mode,
            prec=prec) for (p, key, _), (s, _, n_iters)
            in zip(styles(), plan[:n])]

    prec0 = reference.PRECISIONS[precisions[0]]
    ref_preps = {}
    for p, key, st in styles():
        if key not in ref_preps:
            ref_preps[key] = reference.style_prep(
                banks[prec0.conv_dtype], depth, st, prec0,
                signs_from=passes_bases[p] if passes_bases else None)

    # a call that ran another number of passes than the plan has fails
    missing = [] if n == len(plan) else [math.inf]
    ref_ot = ot_stage(prec0, ref_preps)
    ref = run_all(prec0, ref_preps)
    last = reference.quantize(ref[-1]) if ref else None
    rels = [_rel(o, r) for o, r in zip(passes_out, ref)]
    out = {"passes": rels, precisions[0]: {
        "pass_rel_rms": max(rels + missing, default=math.inf),
        "link_rel_rms": max(links + missing, default=0.0),
        "u8_rel_rms": u8_rel_rms(u8, last) if ref else math.inf,
        "ot_rel_rms": (_rel(stage[1], ref_ot) if ref_ot is not None
                       else math.inf)}}
    for name in precisions[1:]:
        prec = reference.PRECISIONS[name]
        preps = {}
        for _, key, st in styles():
            if key not in preps:
                preps[key] = reference.style_prep(
                    banks[prec.conv_dtype], depth, st, prec,
                    bases=[t.eigvecs for t in ref_preps[key]])
        ctl_ot = ot_stage(prec, preps)
        ctl = run_all(prec, preps)
        out[name] = {
            "ot_rel_rms": (_rel(ctl_ot, ref_ot) if ref_ot is not None
                           else math.inf),
            "pass_rel_rms": max([_rel(c, r) for c, r in zip(ctl, ref)]
                                + missing, default=math.inf),
            "u8_rel_rms": (u8_rel_rms(reference.quantize(ctl[-1]), last)
                           if ctl else math.inf)}
        del ctl, preps
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return all(numbers.get(k, math.inf) <= v for k, v in limits.items())
