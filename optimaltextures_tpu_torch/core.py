"""The pass/layer orchestration loop, single device (the counterpart of
``optimaltextures_tpu/core.py``).

A run is a static plan of multires passes; each pass resizes the pastiche
and runs one stage per VGG layer, deepest first:

    stage = decode( unproject( transport_loop( project( encode(img) ))))

The style side of every pass (multi-tap encode, PCA spectrum, the host's
k-decision, projected moments) is prepared for ALL passes before the first
stage runs, with one host fetch of every pass's eigenvalues. On the CUDA
path the relu1/relu2-scale convs of every stage roundtrip run on the codec
kernels (models/fastcodec.py); the rest is plain PyTorch.

Precision: the f32 path runs matmuls and convs in full f32 —
:func:`full_f32_precision` turns TF32 off for cuBLAS and cuDNN, the
counterpart of the JAX package's ``precision=HIGHEST``.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import transport
from .config import OptexConfig, require_ported
from .models import fastcodec
from .models.vgg import VGGBank, decode, encode, encode_taps
from .ops import histmatch
from .ops.resize import apply_resample, resample_pair
from .ops.rotation import derive_seed, generator
from .utils import schedule

# (pass index, stage index, n_iters, C) -> (n_iters, C, C) rotation stack
RotationSource = Callable[[int, int, int, int], object]


def full_f32_precision() -> None:
    """Turn TF32 off for cuBLAS matmuls and cuDNN convs: the port's f32 path
    computes in full float32, as the JAX package does at HIGHEST precision.
    Process-wide; Synthesizer sets it when it runs on a GPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """None means the GPU; a missing GPU raises (the CPU only on request)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run on the CPU")
        full_f32_precision()
    return device


class LayerTargets(NamedTuple):
    """Per-(pass, layer) transport targets."""
    stats: transport.StyleStats
    eigvecs: Optional[torch.Tensor]      # (C, k) PCA basis or None


# ---------------------------------------------------------------------------
# style prep (counterparts of core._style_spectra_pass_jit and
# core._style_stats_pass_jit)


def _style_spectra_pass(enc_params, style_tens, *, depth: int, use_pca: bool):
    """Multi-tap style encode at every depth + each depth's PCA spectrum
    (scalar-mean centering, Gram, eigh). Returns [(sf, s_vals, v)] ordered
    deepest first."""
    per_style = [encode_taps(enc_params, depth, s) for s in style_tens]
    out = []
    for d in range(depth, 0, -1):
        sf = torch.cat([t[d - 1] for t in per_style], dim=0)
        if use_pca:
            out.append((sf, *transport.pca_spectrum(sf)))
        else:
            out.append((sf, None, None))
    return out


def _style_stats_pass(sfs, vs, *, ks):
    """Project every depth onto its first k PCs (k chosen on the host; 0 =
    no PCA) and compute the transport statistics.
    Returns [(sf_projected, eigvecs, stats, scalar mean)]."""
    out = []
    for sf, v, k in zip(sfs, vs, ks):
        eigvecs = None
        if k:
            eigvecs = v[:, :k]
            # polish the basis: three Newton-Schulz polar steps restore the
            # orthonormality f32 eigh loses, within the same column space
            for _ in range(3):
                vtv = eigvecs.T @ eigvecs
                eigvecs = 1.5 * eigvecs - 0.5 * (eigvecs @ vtv)
            sf = sf @ eigvecs
        mu, cov = histmatch.moment_stats(sf)
        out.append((sf, eigvecs, transport.StyleStats(mu, cov), sf.mean()))
    return out


# ---------------------------------------------------------------------------
# the pass chain


def _pass_stages_impl(enc_params, dec_params, pastiche, targets, *, depths,
                      iters, mode: str, pca_flags, resize_mats=None,
                      stage_codecs=None, run_key: int = 0,
                      pass_idx: int = 0,
                      rotations: Optional[RotationSource] = None):
    """All of a pass's layer stages: the multires resize (``resize_mats``:
    the (wh, ww) weights, or None), then for each depth (deepest first)
    encode -> project -> OT -> unproject -> decode. Takes and returns f32
    NHWC. ``stage_codecs`` (fastcodec.pack_stages) routes the roundtrips
    through the codec kernels; None keeps the F.conv2d codec (CPU only).

    Stage i of pass p draws its rotations from a generator seeded by
    (run_key, p, i), or takes them from ``rotations(p, i, n_iters, C)``."""
    if resize_mats is not None:
        pastiche = apply_resample(pastiche, *resize_mats)

    def ot_stage(i, feat):
        tgt = targets[i]
        if pca_flags[i]:
            feat = feat @ tgt.eigvecs
        c = feat.shape[-1]
        rot = gen = None
        if rotations is not None and iters[i]:
            rot = torch.as_tensor(np.asarray(rotations(pass_idx, i, iters[i], c),
                                             np.float32))
        elif iters[i]:
            gen = generator(feat.device, run_key, pass_idx, i)
        feat = transport.transport_loop(gen, feat, tgt.stats, iters[i], mode,
                                        rotations=rot)
        if pca_flags[i]:
            feat = feat @ tgt.eigvecs.T
        return feat

    if stage_codecs is not None:
        # relu1/relu2-scale codec on the CUDA kernels; the image lives as
        # post-renorm RGB between stages (models/fastcodec.py)
        rgb = fastcodec.pixels_to_rgb(enc_params[0][0], pastiche)
        for i, sc in enumerate(stage_codecs):
            rgb = fastcodec.decode_tail(
                sc, ot_stage(i, fastcodec.encode_head(sc, rgb)))
        return rgb

    for i, d in enumerate(depths):
        feat = ot_stage(i, encode(enc_params[i], d, pastiche))
        pastiche = decode(dec_params[i], d, feat)
    return pastiche


def _run_stages_impl(enc_params, dec_params, pastiche, targets_all, run_key,
                     *, depths, plans, mode: str, pca_flags_all,
                     resize_mats_all, stage_codecs=None,
                     rotations: Optional[RotationSource] = None):
    """The whole run's pass chain. ``plans``: per pass (resize_to | None,
    iters tuple); ``resize_mats_all``: the matching (wh, ww) or None."""
    for p, (_, iters) in enumerate(plans):
        pastiche = _pass_stages_impl(
            enc_params, dec_params, pastiche, targets_all[p], depths=depths,
            iters=iters, mode=mode, pca_flags=pca_flags_all[p],
            resize_mats=resize_mats_all[p], stage_codecs=stage_codecs,
            run_key=run_key, pass_idx=p, rotations=rotations)
    return pastiche


# ---------------------------------------------------------------------------


class Synthesizer:
    """Holds the VGG bank + static schedule and runs the algorithm on one
    device (``None`` = the GPU; tests pass ``device="cpu"``)."""

    def __init__(self, cfg: OptexConfig, bank: Optional[VGGBank] = None,
                 device=None):
        self.cfg = require_ported(cfg.validate())
        self.device = resolve_device(device)
        self.bank = (bank.to(self.device) if bank is not None
                     else VGGBank(cfg.depth, device=self.device))
        self.depth = self.bank.max_depth
        self.iters_table, self.sizes = schedule.iters_and_sizes(
            cfg.size, cfg.iters, cfg.passes, not cfg.no_multires,
            quirk=cfg.compat_schedule_quirk, num_layers=self.depth)
        # layer-loop position l uses depth D-l (deepest first)
        self.layer_depths = [self.depth - l for l in range(self.depth)]
        self.stage_codecs = (fastcodec.pack_stages(
            [self.bank.enc_params[d] for d in self.layer_depths],
            [self.bank.dec_params[d] for d in self.layer_depths],
            self.layer_depths)
            if fastcodec.eligible(cfg.fast_codec, self.device) else None)
        self._run_counter = 0
        self._resample = {}
        self.reseed(cfg.seed)

    def reseed(self, seed: Optional[int]) -> None:
        """(Re-)key for ``seed``: an explicit seed resets to its
        deterministic key; ``None`` draws fresh entropy (once, after a
        seeded phase) and every run then folds a run counter."""
        if seed is None:
            if getattr(self, "_seeded", True):
                self.key = int(np.random.SeedSequence().entropy % (2 ** 63))
                self._run_counter = 0
            self._seeded = False
        else:
            self.key = int(seed)
            self._seeded = True

    def next_run_key(self) -> int:
        """Per-run key: the base key when seeded (identical reruns), else the
        base key folded with a run counter (every run differs)."""
        if self._seeded:
            return self.key
        k = derive_seed(self.key, self._run_counter)
        self._run_counter += 1
        return k

    def _plan_passes(self, pastiche_hw):
        """Per-pass [(size, resize?, target hw)]: the reference's gate skips a
        pass's resize when EITHER pastiche dim already equals its size."""
        plan, cur = [], tuple(pastiche_hw)
        for size in self.sizes:
            if cur[0] != size and cur[1] != size:
                plan.append((size, True, (size, size)))
                cur = (size, size)
            else:
                plan.append((size, False, None))
        return plan

    def _resample_mats(self, in_hw, out_hw):
        key = (tuple(in_hw), tuple(out_hw))
        if key not in self._resample:
            wh, ww = resample_pair(*key)
            self._resample[key] = (torch.from_numpy(wh).to(self.device),
                                   torch.from_numpy(ww).to(self.device))
        return self._resample[key]

    def _dispatch_style_prep(self, styles, size: int, do_resize: bool):
        """One pass's style resize + multi-tap encode + spectra. Gate-skip
        passes encode the ORIGINAL styles, like the reference."""
        cfg = self.cfg
        if do_resize:
            style_tens = []
            for s in styles:
                hw = schedule.get_size(size, cfg.style_scale, s.shape[1], s.shape[2])
                style_tens.append(s if tuple(s.shape[1:3]) == hw else
                                  apply_resample(s, *self._resample_mats(s.shape[1:3], hw)))
        else:
            style_tens = list(styles)
        return _style_spectra_pass(self.bank.enc_params[self.depth], style_tens,
                                   depth=self.depth, use_pca=not cfg.no_pca)

    def _choose_widths(self, spectra, svals_np):
        """Host k-decision for one pass's spectra (0 = no PCA)."""
        if self.cfg.no_pca:
            return tuple(0 for _ in spectra)
        return tuple(transport.choose_k(sv) for sv in svals_np)

    def _finish_style_prep(self, spectra, ks):
        """After the k-decisions: projected statistics. Returns
        [(eigvecs, stats, scalar style mean)] per depth (deepest first)."""
        prepared = _style_stats_pass([sf for (sf, _, _) in spectra],
                                     [v for (_, _, v) in spectra], ks=ks)
        return [(eigvecs, stats, mean) for (_, eigvecs, stats, mean) in prepared]

    def _assemble_targets(self, slim):
        return [LayerTargets(stats=stats, eigvecs=eigvecs)
                for (eigvecs, stats, _) in slim]

    def run(self, pastiche, styles, content=None, verbose: bool = False,
            key: Optional[int] = None,
            rotations: Optional[RotationSource] = None) -> torch.Tensor:
        """Synthesis. ``pastiche`` (1, H, W, 3) and ``styles`` [(1, h, w, 3)]
        are NHWC float32 arrays or tensors; returns the (1, H, W, 3) float32
        result on this synthesizer's device.

        ``key`` overrides the run key (default :meth:`next_run_key`);
        ``rotations`` injects every stage's rotation stack (tests)."""
        if content is not None:
            raise NotImplementedError("content / style transfer is not "
                                      "ported yet (ROADMAP.md, queue 1 item 11)")
        cfg = self.cfg
        dev = self.device
        run_key = key if key is not None else self.next_run_key()
        pastiche = torch.as_tensor(pastiche, dtype=torch.float32).to(dev, copy=True)
        styles = [torch.as_tensor(s, dtype=torch.float32).to(dev) for s in styles]
        if len(styles) != 1:
            raise NotImplementedError("texture mixing is not ported yet "
                                      "(ROADMAP.md, queue 1 item 12)")
        if pastiche.shape[0] != 1:
            raise NotImplementedError("batch > 1 is not ported yet "
                                      "(ROADMAP.md, queue 1 item 13)")

        # phase A: every distinct pass's style prep, ahead of the stages
        plan = self._plan_passes(pastiche.shape[1:3])
        preps = {}
        for (size, rs, _) in plan:
            ck = size if rs else None
            if ck not in preps:
                preps[ck] = self._dispatch_style_prep(styles, size, rs)
        # phase B: ONE host fetch of every prep's eigenvalues, k-decisions
        order = list(preps)
        svals = {ck: [None] * len(preps[ck]) for ck in order}
        if not cfg.no_pca:
            flat = torch.cat([sv for ck in order for (_, sv, _) in preps[ck]]).cpu().numpy()
            off = 0
            for ck in order:
                for j, (_, sv, _) in enumerate(preps[ck]):
                    svals[ck][j] = flat[off:off + sv.shape[0]]
                    off += sv.shape[0]
        widths = {ck: self._choose_widths(preps[ck], svals[ck]) for ck in order}
        # phase C: projected statistics per distinct prep
        slims = {ck: self._finish_style_prep(preps[ck], widths[ck]) for ck in order}

        targets_all, pca_flags_all, plans, mats_all = [], [], [], []
        cur_hw = tuple(pastiche.shape[1:3])
        for p, (size, rs, hw) in enumerate(plan):
            if verbose:
                print(f"Pass {p}, size {size}", flush=True)
                for d in self.layer_depths:
                    print(f"Layer: relu{d}_1", flush=True)
            targets = self._assemble_targets(slims[size if rs else None])
            targets_all.append(targets)
            pca_flags_all.append(tuple(t.eigvecs is not None for t in targets))
            plans.append((hw if rs else None,
                          tuple(int(i) for i in self.iters_table[p])))
            mats_all.append(self._resample_mats(cur_hw, hw) if rs else None)
            if rs:
                cur_hw = tuple(hw)

        # phase D: the pass chain
        return _run_stages_impl(
            [self.bank.enc_params[d] for d in self.layer_depths],
            [self.bank.dec_params[d] for d in self.layer_depths],
            pastiche, targets_all, run_key, depths=tuple(self.layer_depths),
            plans=plans, mode=cfg.hist_mode, pca_flags_all=pca_flags_all,
            resize_mats_all=mats_all, stage_codecs=self.stage_codecs,
            rotations=rotations)


def synthesize(cfg: OptexConfig, styles, content=None, pastiche=None,
               verbose: bool = False, device=None):
    """One-call API: build the synthesizer, draw the noise pastiche, run.
    Returns (output NHWC float32 tensor, wall seconds)."""
    synth = Synthesizer(cfg, device=device)
    run_key = synth.next_run_key()
    if pastiche is None:
        shape = (cfg.batch, cfg.size, cfg.out_width or cfg.size, 3)
        pastiche = torch.rand(shape, generator=generator(synth.device, run_key, 999),
                              device=synth.device, dtype=torch.float32)
    t0 = time.time()
    out = synth.run(pastiche, styles, content, verbose=verbose, key=run_key)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out, time.time() - t0

