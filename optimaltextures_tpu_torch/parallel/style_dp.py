"""Style-parallel synthesis: N different styles, one texture each, one style
per rank (the counterpart of ``optimaltextures_tpu/parallel/style_dp.py``).

The reference's batch axis matches N noise pastiches against ONE style with
joint statistics. A texture service wants the transpose: one request per
style. Here rank r synthesizes style r's texture from its own statistics,
so a pass needs no collective; the ranks agree once per distinct pass size
on the shared PCA widths (an all-gather of every style's ranks) and gather
the outputs at the end. Rotations come from the same generator seed on every
rank (blockdiag(SO(k_i), I) with each style's own rank), so a
style-parallel run equals the same styles run one after another in one
process (``mesh=None``, the reference mode).

On the GPU every stage roundtrip runs on the codec kernels and every cdf
step on the histogram and remap kernels, as in ``core.Synthesizer``, whose
style prep and pass body (``core._pass_stages_impl``) this module runs.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict

import numpy as np
import torch

from .. import core, transport
from ..utils.trace import fetch


def per_style_stats(style_feats: torch.Tensor, need_samples: bool):
    """(N, H, W, C) style features -> stacked per-style transport stats:
    mu (N, 1, 1, C), cov (N, C, C), samples (N, H*W, C) or None."""
    n, h, w, c = style_feats.shape
    mu = style_feats.mean(dim=(1, 2), keepdim=True)
    xc = (style_feats - mu).reshape(n, h * w, c)
    cov = torch.einsum("nsc,nsd->ncd", xc, xc) / (h * w)
    samples = style_feats.reshape(n, h * w, c) if need_samples else None
    return mu, cov, samples


def _pass_plan(synth):
    """Per pass: (size, resize?, prep key); the pastiche starts at
    cfg.size and a pass resizes it unless either side already has the pass
    size (the reference's gate). The key names the pass's style prep: the
    pass size, or None where the original styles are encoded."""
    plan, cur = [], (synth.cfg.size, synth.cfg.size)
    for size in synth.sizes:
        rs = cur[0] != size and cur[1] != size
        plan.append((size, rs, size if rs else None))
        if rs:
            cur = (size, size)
    return plan


def _style_ranks(synth, spectra):
    """One style's PCA ranks per depth: host ints (choose_k), or with
    pca_traced_k 0-d int32 tensors on the device (no host decision)."""
    if synth.cfg.pca_traced_k:
        return list(core._traced_ks([sv for (_, sv, _) in spectra]))
    return [transport.choose_k(sv) for (_, sv, _) in spectra]


def _bucket_widths(cfg, spectra, ranks_per_style):
    """The shared per-depth widths: every style's rank rounded up to the
    bucket (cfg.pca_bucket, 32 when unset), the largest, at most C; the full
    width C with pca_traced_k."""
    chans = [sf.shape[-1] for (sf, _, _) in spectra]
    if cfg.pca_traced_k:
        return tuple(chans)
    bucket = cfg.pca_bucket or 32
    top = np.max(np.asarray(ranks_per_style, dtype=np.int64), axis=0)
    return tuple(min(-(-int(k) // bucket) * bucket, c)
                 for k, c in zip(top, chans))


class _StyleSet:
    """The style side of a style-parallel run for this rank's styles: per
    prep key, each style's spectra and ranks, and the agreed widths."""

    def __init__(self, synth, styles, mesh, force_widths):
        self.synth, self.styles, self.mesh = synth, styles, mesh
        self.force = force_widths
        self.preps: Dict = {}

    def prep(self, size: int, rs: bool, ck):
        """(widths, [targets per style]) of one prep key, built once."""
        if ck in self.preps:
            return self.preps[ck]
        synth, cfg = self.synth, self.synth.cfg
        use_pca = not cfg.no_pca
        spectra = [synth._dispatch_style_prep([s], size, rs)
                   for s in self.styles]
        if not use_pca:
            widths = tuple(0 for _ in spectra[0])
            masks = [[None] * len(widths) for _ in spectra]
        else:
            ranks = [_style_ranks(synth, sp) for sp in spectra]
            masks = [[k if isinstance(k, torch.Tensor) else torch.tensor(
                k, dtype=torch.int32, device=synth.device) for k in r]
                for r in ranks]
            if cfg.pca_traced_k:
                widths = _bucket_widths(cfg, spectra[0], None)
            else:
                if self.mesh is not None:
                    # every style's ranks, in rank order (one style a rank)
                    dev = (self.mesh.device if self.mesh.backend == "nccl"
                           else "cpu")
                    ranks = fetch(self.mesh.all_gather(torch.tensor(
                        ranks, dtype=torch.int64, device=dev))).tolist()
                widths = _bucket_widths(cfg, spectra[0], ranks)
            if self.force is not None:
                widths = tuple(self.force[ck] if isinstance(self.force, dict)
                               else self.force)
        targets = []
        for sp, mk in zip(spectra, masks):
            projected = core._project_pass(
                [sf for (sf, _, _) in sp], [v for (_, _, v) in sp], ks=widths,
                true_ks=mk if use_pca else None)
            per_depth = []
            for (sf, eig, _), km in zip(projected, mk):
                mu, cov, samples = per_style_stats(
                    sf, cfg.hist_mode in ("cdf", "sort"))
                per_depth.append(core.LayerTargets(
                    transport.StyleStats(mu[0], cov[0], None if samples is None
                                         else samples[0]), eig, None, km))
            targets.append(per_depth)
        self.preps[ck] = (widths, targets)
        return self.preps[ck]


def _ep_pass_body(synth, pastiche, targets, *, depths, iters, mode: str,
                  pca_flags, cov_prop: bool, use_pallas: bool, pass_idx: int,
                  resize_mats, run_key: int, rotations=None):
    """One style's whole pass: encode -> project onto its own (zero-padded)
    basis -> masked-rotation transport on its own statistics -> unproject
    -> decode, every layer chained (``core._pass_stages_impl`` with the
    bank and packed codec of ``synth``, on the codec kernels on a GPU)."""
    return core._pass_stages_impl(
        [synth.bank.enc_params[d] for d in depths],
        [synth.bank.dec_params[d] for d in depths], pastiche, targets,
        depths=depths, iters=iters, mode=mode,
        strengths=tuple(0.0 for _ in targets), pca_flags=pca_flags,
        resize_mats=resize_mats, stage_codecs=synth.stage_codecs,
        run_key=run_key, pass_idx=pass_idx, use_pallas=use_pallas,
        rotations=rotations, cov_prop=cov_prop)


def make_style_parallel_pass(mesh, *, depths, iters, mode: str, pca_flags,
                             axis: str = "data", cov_prop=None,
                             use_pallas=None):
    """A pass over this rank's (pastiche_i, style_i) pairs (one pair a rank
    on a mesh, every pair with ``mesh=None``), collective-free. Returns
    ``fn(synth, pastiche, targets, *, pass_idx, resize_mats, run_key,
    rotations=None)``: ``pastiche`` (n_local, H, W, 3), ``targets`` one list
    of LayerTargets per local style, ``synth`` (core.Synthesizer) the bank
    and packed codec weights of ``depths``."""
    if mesh is not None and axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's {mesh.axis!r}")
    cov_prop = True if cov_prop is None else cov_prop
    use_pallas = True if use_pallas is None else use_pallas

    def fn(synth, pastiche, targets, *, pass_idx: int, resize_mats,
           run_key: int, rotations=None):
        return torch.cat([_ep_pass_body(
            synth, pastiche[i:i + 1], tg, depths=tuple(depths), iters=iters,
            mode=mode, pca_flags=pca_flags, cov_prop=cov_prop,
            use_pallas=use_pallas, pass_idx=pass_idx, resize_mats=resize_mats,
            run_key=run_key, rotations=rotations)
            for i, tg in enumerate(targets)])

    return fn


def _inner_synth(cfg, bank, device):
    """The single-device Synthesizer a style-parallel run computes with (one
    image, one device, the run's settings)."""
    return core.Synthesizer(dataclasses.replace(
        cfg, num_devices=1, batch=1, style=cfg.style[:1]), bank=bank,
        device=device)


def _check_styles(cfg, styles):
    if len({tuple(s.shape) for s in styles}) != 1:
        raise ValueError("style-parallel synthesis needs equal style shapes")
    if getattr(cfg, "batch_chunk", 0):
        raise ValueError("batch_chunk does not compose with style_parallel "
                         "(one image per style per device — no local batch "
                         "axis to chunk); use num_devices DP for chunked "
                         "batches")
    return cfg.validate()


def style_widths(cfg, styles, bank=None, device=None) -> dict:
    """The PCA widths a style-parallel run of ``styles`` takes at each
    distinct pass size ({prep key: per-depth widths}; all zero without PCA).
    A run of any subset of the styles given these as ``_force_widths`` draws
    exactly the full run's computation for its styles: the widths of a set
    are the elementwise maximum of each member's, so a caller may compute
    them style by style, on different devices, and take the maximum."""
    cfg = _check_styles(cfg, styles)
    synth = _inner_synth(cfg, bank, device)
    sset = _StyleSet(synth, [torch.as_tensor(s, dtype=torch.float32).to(
        synth.device) for s in styles], None, None)
    return {ck: sset.prep(size, rs, ck)[0]
            for (size, rs, ck) in _pass_plan(synth)}


def synthesize_style_batch(cfg, styles, mesh, verbose: bool = False,
                           pastiche=None, bank=None, _force_widths=None, *,
                           device=None, rotations=None) -> torch.Tensor:
    """Style-parallel synthesis: one pastiche per style, with PCA (each
    style's own rank, every width bucketed to the largest across the styles
    per depth and pass size) and the full multires schedule. ``styles``
    (each (1, h, w, 3)) must share a shape. Returns the float32 (N, H, W, 3)
    outputs on every rank (on the device).

    ``mesh``: a parallel.mesh.Mesh of N ranks (rank r takes style r), or None
    to run every style in this process on ``device`` (None: the GPU).
    ``pastiche``: the (N, size, size, 3) starting noise (default: drawn from
    the run key, the whole stack on every rank). ``bank``: a warm VGGBank.
    ``_force_widths``: per-depth widths for every pass, or {prep key:
    widths} (see :func:`style_widths`). ``rotations``: every stage's rotation
    stack (tests; blockdiag masks do not apply to injected stacks).

    Without ``pca_bucket`` the bucket is 32 (exact per-style ranks cannot
    share a width); the math is unchanged (zero-padded bases and
    blockdiag(SO(k_i), I) rotations)."""
    n = len(styles)
    if mesh is not None and n != mesh.size:
        raise ValueError(f"{n} styles for {mesh.size} devices")
    cfg = _check_styles(cfg, styles)
    if not cfg.no_pca and not cfg.pca_bucket and not cfg.pca_traced_k:
        warnings.warn(
            "style_parallel forces pca_bucket=32 (exact-k / pca_bucket=0 "
            "is unavailable on the style axis; math is unchanged — padded "
            "bases + true-rank masked rotations)", stacklevel=2)
    synth = _inner_synth(cfg, bank, mesh.device if mesh is not None
                         else device)
    dev = synth.device
    seed = (cfg.seed if cfg.seed is not None
            else int(np.random.SeedSequence().entropy % (2 ** 63)))
    if mesh is not None and cfg.seed is None:
        seed = mesh.broadcast_int(seed)
    run_key = int(seed)

    if pastiche is None:
        pastiche = core.draw_noise(dev, run_key, (n, cfg.size, cfg.size, 3))
    else:
        pastiche = torch.as_tensor(pastiche, dtype=torch.float32).to(
            dev, copy=True)
    if tuple(pastiche.shape) != (n, cfg.size, cfg.size, 3):
        raise ValueError(f"pastiche {tuple(pastiche.shape)} is not "
                         f"{(n, cfg.size, cfg.size, 3)}")
    mine = range(n) if mesh is None else [mesh.rank]
    pastiche = pastiche[list(mine)]
    sset = _StyleSet(synth, [torch.as_tensor(styles[i], dtype=torch.float32)
                             .to(dev) for i in mine], mesh, _force_widths)

    cur_hw = (cfg.size, cfg.size)
    for p, (size, rs, ck) in enumerate(_pass_plan(synth)):
        widths, targets = sset.prep(size, rs, ck)
        if verbose:
            print(f"Pass {p}, size {size} (style-parallel x{n}, "
                  f"widths {list(widths)})", flush=True)
        mats = synth._resample_mats(cur_hw, (size, size)) if rs else None
        if rs:
            cur_hw = (size, size)
        iters = tuple(int(i) for i in synth.iters_table[p])
        stage = make_style_parallel_pass(
            mesh, depths=tuple(synth.layer_depths), iters=iters,
            mode=cfg.hist_mode, pca_flags=tuple(bool(w) for w in widths),
            cov_prop=cfg.cov_propagation, use_pallas=cfg.use_pallas)
        pastiche = stage(synth, pastiche, targets, pass_idx=p,
                         resize_mats=mats, run_key=run_key,
                         rotations=rotations)
    return pastiche if mesh is None else mesh.all_gather(pastiche)
