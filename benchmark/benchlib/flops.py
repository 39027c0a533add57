"""The FLOP model of one ``Synthesizer.run``, frozen and batch-aware.

A copy of the port's ``utils/flops.py`` (itself the JAX package's), with a
batch factor on the work over the pastiche's samples and a cdf branch. It
counts 2 x MACs of the work the schedule provably issues, so it is a lower
bound:

* every conv of every stage's encode and decode, at the pass's size, for
  each image of the batch;
* the style prep of each distinct pass (gate-skip passes share one): the
  multi-tap encode and each depth's PCA Gram, once per call;
* the OT stage. Moment modes (composed): the initial Gram and the one
  apply GEMM over the batch's samples, ~22 k^3 a step, and the polar
  rotation draw (2 x 30 x 2 k^3 a rotation). cdf: per step the two
  rotations of the pastiche's samples, the rotation of the style's, and
  the same rotation draw;
* the PCA projection and unprojection over the batch's samples.

Left out: eigh, resizes, elementwise work, histograms and remaps.
The PCA widths are the benchmark's own (``reference.style_prep``), never a
count the program reports."""

from __future__ import annotations

from math import ceil

from . import schedule
from .reference import decoder_specs, encoder_specs

POLAR_ITERS = 30


def conv_stack_flops(specs, h: int, w: int) -> float:
    total = 0.0
    for (cin, cout, k, pre, _) in specs:
        if pre == "pool":
            h, w = ceil(h / 2), ceil(w / 2)
        elif pre == "up":
            h, w = h * 2, w * 2
        total += 2.0 * h * w * k * k * cin * cout
    return total


def feat_hw(h: int, w: int, depth: int):
    for _ in range(depth - 1):
        h, w = ceil(h / 2), ceil(w / 2)
    return h, w


def transport_flops(n_samples: int, n_style: int, k: int, n_iters: int,
                    mode: str) -> float:
    rotations = n_iters * (2.0 * POLAR_ITERS * 2.0 * k ** 3)
    if mode == "cdf":
        return rotations + n_iters * (2 * 2.0 * n_samples * k * k
                                      + 2.0 * n_style * k * k)
    return (2 * 2.0 * n_samples * k * k + n_iters * 22.0 * k ** 3
            + rotations)


def run_flops(*, size: int, iters: int, passes: int, depth: int,
              batch: int, pastiche_hw, style_hw, ks, mode: str) -> float:
    """FLOPs of one call: ``ks[p][l]`` the PCA width of pass p at layer
    position l (0: no PCA), ``style_hw`` the exemplar's (h, w)."""
    total = 0.0
    seen = set()
    plan = schedule.pass_plan(size, iters, passes, depth, pastiche_hw)
    h, w = pastiche_hw
    for p, (s, rs, n_iters) in enumerate(plan):
        if rs:
            h = w = s
        key = s if rs else None
        sh, sw = schedule.get_size(s, *style_hw) if rs else style_hw
        if key not in seen:
            seen.add(key)
            total += conv_stack_flops(encoder_specs(depth), sh, sw)
            for d in range(1, depth + 1):
                fh, fw = feat_hw(sh, sw, d)
                total += 2.0 * fh * fw * schedule.CHANNELS[d] ** 2
        for l in range(depth):
            d = depth - l
            c = schedule.CHANNELS[d]
            k = ks[p][l] or c
            fh, fw = feat_hw(h, w, d)
            n = batch * fh * fw
            sfh, sfw = feat_hw(sh, sw, d)
            total += batch * (conv_stack_flops(encoder_specs(d), h, w)
                              + conv_stack_flops(decoder_specs(d), fh, fw))
            total += transport_flops(n, sfh * sfw, k, n_iters[l], mode)
            if ks[p][l]:
                total += 2 * (2.0 * n * c * k)
    return total
