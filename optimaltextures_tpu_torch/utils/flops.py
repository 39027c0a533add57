"""Analytic FLOP model of one synthesis run (a copy of
``optimaltextures_tpu/utils/flops.py``; the port imports nothing from the JAX
package).

Counts the multiply-add work the static schedule provably issues — the model
is a LOWER bound on device FLOPs (documented omissions below), so the MFU it
yields is conservative. All counts are 2*MACs.

Counted:
* every conv in every per-layer stage (encode at the pass's pastiche size +
  decode), with exact ceil-mode pool / nearest-up size tracking;
* style-prep conv stacks (one multi-tap encode per DISTINCT prep — gate-skip
  passes share one, mirroring core.run) and the per-depth PCA Gram GEMM;
* the OT stage (composed execution): the initial sample Gram + the ONE
  final apply GEMM (2 * 2*N*k^2 total), per-iteration k x k work (~22 k^3:
  congruences + transform solve + A/bias composition + cov propagation),
  and the stage's batched polar rotation sampling
  (2 * _POLAR_ITERS * 2*k^3 per rotation);
* PCA project/unproject GEMMs per stage (2 * 2*N*C*k).

Omitted (small at 512px defaults): eigh of the C x C Gram, resizes,
elementwise work, content pulls, color transfer.
"""

from __future__ import annotations

from math import ceil

from ..models import arch
from ..ops.rotation import _POLAR_ITERS
from . import schedule


def conv_stack_flops(specs, h: int, w: int) -> float:
    """FLOPs of one stack forward at input (h, w), tracking pre-ops."""
    total = 0.0
    for (cin, cout, k, pre, _) in specs:
        if pre == "pool":
            h, w = ceil(h / 2), ceil(w / 2)
        elif pre == "up":
            h, w = h * 2, w * 2
        total += 2.0 * h * w * k * k * cin * cout
    return total


def _feat_hw(h: int, w: int, depth: int):
    for _ in range(depth - 1):
        h, w = ceil(h / 2), ceil(w / 2)
    return h, w


def transport_loop_flops(n_samples: int, k: int, n_iters: int) -> float:
    """Moment-mode OT stage, composed closed-form execution
    (transport.compose_moment_chain): one initial sample Gram, ONE final
    apply GEMM, and per iteration only k x k work — congruences + chol +
    solve + fold + the A/bias accumulation + the M^T cov M propagation —
    plus the stage's batched polar rotation sampling.

    The model tracks the executed composition, which has no per-iteration
    sample-sized apply GEMM; compare utilisation figures only within one
    execution scheme."""
    init = 2.0 * n_samples * k * k               # initial pastiche Gram
    apply_once = 2.0 * n_samples * k * k         # the ONE composed apply
    per_iter = 22.0 * k ** 3                     # congruences + chol + solve
    #                                              + fold + A/bias compose
    #                                              + cov propagation
    rotations = n_iters * (2.0 * _POLAR_ITERS * 2.0 * k ** 3)
    return init + apply_once + n_iters * per_iter + rotations


def run_flops(synth, pastiche_hw, style_hws, ks_per_pass) -> float:
    """Total FLOPs of synth.run() for a synthesis-shaped input.

    ``ks_per_pass``: the realized PCA widths (synth.last_run_ks), or None
    entries/zeros for no-PCA stages.
    """
    total = 0.0
    h, w = pastiche_hw
    depth = synth.depth
    seen_preps = set()
    for p in range(synth.cfg.passes):
        size = synth.sizes[p]
        if h != size and w != size:   # the reference's resize gate
            h = w = size              # synthesis: square pastiche
            prep_key = size
        else:
            prep_key = None
        if prep_key not in seen_preps:
            seen_preps.add(prep_key)
            for (sh, sw) in style_hws:
                if prep_key is not None:
                    sh2, sw2 = schedule.get_size(size, synth.cfg.style_scale,
                                                 sh, sw)
                else:
                    sh2, sw2 = sh, sw
                total += conv_stack_flops(arch.encoder_specs(depth), sh2, sw2)
                for d in range(1, depth + 1):
                    fh, fw = _feat_hw(sh2, sw2, d)
                    c = arch.FEATURE_CHANNELS[d]
                    total += 2.0 * fh * fw * c * c     # PCA Gram
        for l in range(depth):
            d = synth.layer_depths[l]
            c = arch.FEATURE_CHANNELS[d]
            k = ks_per_pass[p][l] or c
            total += conv_stack_flops(arch.encoder_specs(d), h, w)
            total += conv_stack_flops(arch.decoder_specs(d), *_feat_hw(h, w, d))
            fh, fw = _feat_hw(h, w, d)
            n = fh * fw
            n_iters = int(synth.iters_table[p][l])
            total += transport_loop_flops(n, k, n_iters)
            if ks_per_pass[p][l]:
                total += 2 * (2.0 * n * c * k)         # project + unproject
    return total
