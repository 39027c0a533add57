"""The pass/layer orchestration loop, single device (the counterpart of
``optimaltextures_tpu/core.py``).

A run is a static plan of multires passes; each pass resizes the pastiche
and runs one stage per VGG layer, deepest first:

    stage = decode( unproject( transport_loop( project( encode(img) ))))

The style side of every pass (multi-tap encode, PCA spectrum, the host's
k-decision, projected moments) is prepared for ALL passes before the first
stage runs, with one host fetch of every pass's eigenvalues (none with
``pca_traced_k``; per pass, inside the pass loop, above the prefetch
budget); with two or
more styles (texture mixing) every pass blends the styles' projected maps
under a random spatial mask, with cross-histogram matching, before their
moments are taken; a content
image is encoded per pass, projected into the style's PC space and pulled
toward at the three deepest stage positions. After the last pass an
optional color-transfer tail keeps the content's colors (lum: a lightness
swap; opt: three pixel-space cdf OT steps). On the CUDA path the
relu1/relu2-scale convs of every stage roundtrip run on the codec kernels
(models/fastcodec.py) and the cdf steps on the histogram and remap kernels
(ops/cdf.py); the rest is plain PyTorch.

Precision: the f32 path runs matmuls and convs in full f32 —
:func:`full_f32_precision` turns TF32 off for cuBLAS and cuDNN, the
counterpart of the JAX package's ``precision=HIGHEST``. With
``conv_dtype="bfloat16"`` the convs (the bank, the codec kernels and
``F.conv2d``) run in bf16 while the statistics, the PCA and the OT stay in
f32: features widen to f32 after every encode (exactly) and the OT's output
rounds to bf16 before every decode, as in the JAX package.

Batch: a synthesis run takes B noise pastiches (B, H, W, 3); the style
statistics are shared, every stage's moments are taken over B*H*W samples
(per-image means, pooled covariance, as the JAX package's) and one
rotation stack per stage serves the whole batch. Style transfer runs one
image. With ``batch_chunk`` the codec runs the batch in chunks and only the
projected features of the whole batch are kept
(:func:`_pass_stages_chunked_impl`).

The rest of the single-device settings: ``out_width`` (non-square
synthesis, the pass plan gating on the full (H, W) pair), an init image
(any pastiche passed to :meth:`Synthesizer.run`), ``pca_bucket`` and
``pca_traced_k`` (PCA widths padded past the true rank, which rides along
as a device tensor: zeroed eigvec columns and blockdiag(SO(k), I)
rotations keep the pads exactly zero), ``cov_propagation=False`` (the
per-iteration moment loop), the ``styles_token`` prep cache, the
low-memory prep above the prefetch budget and ``quantize_uint8``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import config as config_mod
from . import transport
from .config import OptexConfig
from .models import fastcodec
from .models.vgg import VGGBank, decode, encode, encode_taps
from .ops import colors, histmatch
from .ops.resize import apply_resample, resample_pair, resize_nearest_nhwc
from .ops.rotation import derive_seed, generator
from .utils import schedule

# (pass index, stage index, n_iters, C) -> (n_iters, C, C) rotation stack
RotationSource = Callable[[int, int, int, int], object]
# (pass index, (h, w), n_styles) -> the mixing mask's (h, w) region indices
MixDrawSource = Callable[[int, Tuple[int, int], int], object]

# the color tail's generator key part: step i draws from (run_key, COLOR_KEY, i)
COLOR_KEY = 0xC0102
COLOR_STEPS = 3
# the mixing mask's: pass p draws from (run_key, MIX_KEY, p) (the JAX
# package folds 7919 into the pass key)
MIX_KEY = 7919


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
    stats: transport.StyleStats          # style moments (+ samples for cdf/sort)
    eigvecs: Optional[torch.Tensor]      # (C, k) PCA basis or None
    content: Optional[torch.Tensor] = None   # projected, re-centred content
    # the true PCA rank, a 0-d int tensor on the device, when the width k is
    # padded past it (pca_bucket, pca_traced_k); None when k is exact
    k_mask: Optional[torch.Tensor] = None


@dataclasses.dataclass(eq=False)
class _StylePrep:
    """One distinct pass's style prep within a run, or kept across runs
    under a ``styles_token``: its spectra (None once freed), PCA widths and
    true-rank masks, cache key and, with one style, the finished targets,
    which replace the spectra once built."""
    spectra: Optional[list]
    key: tuple
    widths: Optional[tuple] = None
    masks: Optional[tuple] = None
    slim: Optional[list] = None


# ---------------------------------------------------------------------------
# style prep (counterparts of core._style_spectra_pass_jit and
# core._style_stats_pass_jit)


def _style_spectra_pass(enc_params, style_tens, *, depth: int, use_pca: bool):
    """Multi-tap style encode at every depth + each depth's PCA spectrum
    (scalar-mean centering, Gram, eigh). Returns [(sf, s_vals, v)] ordered
    deepest first."""
    conv_dtype = enc_params[0][0].dtype
    per_style = [encode_taps(enc_params, depth, s.to(conv_dtype))
                 for s in style_tens]
    out = []
    for d in range(depth, 0, -1):
        # bf16 -> f32 widening is exact: the mean, Gram and eigh run in f32
        sf = torch.cat([t[d - 1] for t in per_style], dim=0).float()
        if use_pca:
            out.append((sf, *transport.pca_spectrum(sf)))
        else:
            out.append((sf, None, None))
    return out


def _project_pass(sfs, vs, *, ks, true_ks=None):
    """Project every depth onto its first k PCs (0 = no PCA). Returns
    [(projected sf, eigvecs, scalar mean)].

    With a padded width (pca_bucket, pca_traced_k) ``true_ks`` holds each
    depth's true rank as a 0-d int tensor: eigvec columns >= the true rank
    are zeroed, so the padded feature dims are exactly zero, and the scalar
    mean divides by the true rank, as the exact-k computation does."""
    projected = []
    for sf, v, k, tk in zip(sfs, vs, ks, true_ks or [None] * len(sfs)):
        eigvecs = None
        if k:
            eigvecs = v[:, :k]
            if tk is not None:
                col = torch.arange(k, device=eigvecs.device)
                eigvecs = torch.where(col < tk, eigvecs, 0.0)
            # polish the basis: three Newton-Schulz polar steps restore the
            # orthonormality f32 eigh loses, within the same column space
            # (zeroed columns stay zero)
            for _ in range(3):
                vtv = eigvecs.T @ eigvecs
                eigvecs = 1.5 * eigvecs - 0.5 * (eigvecs @ vtv)
            sf = sf @ eigvecs
        if k and tk is not None:
            mean = sf.sum() / (sf.numel() // sf.shape[-1] * tk.long())
        else:
            mean = sf.mean()
        projected.append((sf, eigvecs, mean))
    return projected


def _traced_ks(svals):
    """The k rule of :func:`transport.choose_k` (the first index where the
    cumulative singular-value share exceeds 0.9, clamped to >= 1) on the
    device, as 0-d int32 tensors: pca_traced_k's replacement for the host
    k-decision, so a run fetches no spectrum. The cumulative share is taken
    in float32 (choose_k uses float64), as the JAX package's
    ``_traced_ks_jit`` does."""
    out = []
    for s in svals:
        frac = torch.cumsum(s, 0) / torch.sum(s)
        k = torch.argmax((frac > 0.9).to(torch.float32))   # the first True
        out.append(torch.clamp(k, min=1).to(torch.int32))
    return tuple(out)


def _styles_fingerprint(styles) -> str:
    """Content fingerprint of the style images, folded into the
    ``styles_token`` cache key so that a stale token never returns another
    style's statistics: blake2b over each style's shape, dtype and a strided
    pixel sample of at most 17 x 17 pixels. Gives the JAX package's digest on
    the same float32 numpy arrays."""
    h = hashlib.blake2b(digest_size=16)
    for s in styles:
        shape = tuple(s.shape)
        dtype = str(s.dtype).replace("torch.", "")
        h.update(repr((shape, dtype)).encode())
        sample = s[:, ::max(1, shape[1] // 16), ::max(1, shape[2] // 16), :]
        if isinstance(sample, torch.Tensor):
            sample = sample.cpu().numpy()
        h.update(np.ascontiguousarray(sample).tobytes())
    return h.hexdigest()


def _quant_u8(x: torch.Tensor) -> torch.Tensor:
    """PNG-ready uint8 on the device, the IEEE float32 ops of
    imageio.save_images' host formula: clamp, * 255 + 0.5, truncate."""
    return (torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


# ---------------------------------------------------------------------------
# texture mixing (counterparts of core._mix_multi_impl and, with weights
# (1 - alpha, alpha), of _mix_pair_impl; _mix_pass_pair_jit and
# _mix_pass_multi_jit)


def _mix_multi_impl(sfs, mask_onehot, weights, *, mode: str,
                    use_pallas: bool = True):
    """N-style blend: region i of the categorical mask shows
    ``sum_j w_j * hist_match(S_i -> S_j)`` (``S_i`` itself for j == i). For
    N = 2 with weights (1 - alpha, alpha) this is the reference's 2-style
    blend ``(a(1-alpha) + AtoB alpha) m + (BtoA(1-alpha) + b alpha)(1 - m)``.
    ``sfs``: N (1, H, W, C) maps; ``mask_onehot``: (1, H, W, N);
    ``weights``: (N,) float32."""
    out = torch.zeros_like(sfs[0])
    for i, si in enumerate(sfs):
        fi = torch.zeros_like(si)
        for j in range(len(sfs)):
            fi = fi + weights[j] * (si if j == i else histmatch.hist_match(
                si, sfs[j], mode, use_pallas=use_pallas))
        out = out + fi * mask_onehot[..., i:i + 1]
    return out


def _mix_regions(u, weights):
    """Categorical regions from uniforms ``u``: the inverse cdf of
    ``weights`` taken from the last style down, so region N-1 holds u <=
    w[N-1]. For two styles that is the reference's threshold: the second
    style where ``ceil(u - alpha) == 0``."""
    n = len(weights)
    below = torch.searchsorted(torch.cumsum(weights.flip(0), 0),
                               u.reshape(-1).contiguous()).clamp(max=n - 1)
    return (n - 1 - below).reshape(u.shape)


def _mix_pass(sfs, regions, weights, *, mode: str, need_samples: bool = False,
              use_pallas: bool = True):
    """One pass's mixing on every depth's projected joint style maps
    ``sfs`` [(N, h, w, C)], deepest first: the one-hot of the (h, w) region
    indices, nearest-resized to each depth, blends the N maps under
    ``weights``, then the blend's transport statistics."""
    mask = torch.nn.functional.one_hot(regions, len(weights)).to(
        torch.float32)[None]
    out = []
    for sf in sfs:
        mixed = _mix_multi_impl([sf[i:i + 1] for i in range(len(weights))],
                                resize_nearest_nhwc(mask, sf.shape[1:3]),
                                weights, mode=mode, use_pallas=use_pallas)
        out.append(transport.style_stats(mixed, need_samples))
    return out


def _content_prep_pass(enc_params, cont, eigvecs_list, style_means,
                       true_ks=None, *, depth: int, use_pca: bool):
    """Multi-tap content encode, each depth projected into the style's PC
    space and re-centred at the style's scalar mean: ``cf - mean(cf) +
    mean(style)``, scalar means (deepest first); with a padded width the
    content's mean divides by the true rank ``true_ks[i]``."""
    taps = encode_taps(enc_params, depth, cont.to(enc_params[0][0].dtype))
    out = []
    for i, d in enumerate(range(depth, 0, -1)):
        cf = taps[d - 1].float()
        if use_pca:
            cf = cf @ eigvecs_list[i]
        tk = true_ks[i] if true_ks is not None else None
        if use_pca and tk is not None:
            cmean = cf.sum() / (cf.numel() // cf.shape[-1] * tk.long())
        else:
            cmean = cf.mean()
        out.append(cf - cmean + style_means[i])
    return out


# ---------------------------------------------------------------------------
# the pass chain


def _stage_rotations(rotations: Optional[RotationSource], pass_idx: int,
                     i: int, n_iters: int, c: int, device, run_key: int,
                     k_mask=None) -> torch.Tensor:
    """Stage i of pass p's rotation stack: ``rotations(p, i, n_iters, C)``
    when injected, else drawn from the generator (run_key, p, i)
    (blockdiag(SO(k), I) ones with ``k_mask``)."""
    if rotations is not None:
        return torch.as_tensor(np.asarray(rotations(pass_idx, i, n_iters, c),
                                          np.float32)).to(device)
    return transport.draw_stage_rotations(
        generator(device, run_key, pass_idx, i), n_iters, c, device, k_mask)


def _pass_stages_impl(enc_params, dec_params, pastiche, targets, *, depths,
                      iters, mode: str, strengths, pca_flags,
                      resize_mats=None, stage_codecs=None, run_key: int = 0,
                      pass_idx: int = 0, use_pallas: bool = True,
                      rotations: Optional[RotationSource] = None,
                      cov_prop: bool = True, pad_mode: str = "reflect",
                      mesh=None, space=None):
    """All of a pass's layer stages: the multires resize (``resize_mats``:
    the (wh, ww) weights, or None) in f32, the cast to the conv dtype, then
    for each depth (deepest first) encode -> widen to f32 -> project -> OT
    (pulled toward ``targets[i].content`` at ``strengths[i]``) -> unproject
    -> cast back -> decode. Takes and returns f32 NHWC.
    ``stage_codecs`` (fastcodec.pack_stages) routes the roundtrips through
    the codec kernels; None keeps the F.conv2d codec (CPU only).

    Stage i of pass p draws its rotations from a generator seeded by
    (run_key, p, i), or takes them from ``rotations(p, i, n_iters, C)``
    (:func:`_stage_rotations`). ``cov_prop`` False runs the moment modes'
    per-iteration loop. ``pad_mode="wrap"`` pads every conv circularly
    (tileable runs; the caller gives circular ``resize_mats``).

    ``mesh`` (parallel.mesh.Mesh): ``pastiche`` is this rank's batch shard
    and the OT statistics are reduced over the ranks
    (``transport.transport_loop``'s mesh); the codec stays shard-local.
    ``space`` (a parallel.mesh.Mesh, with ``mesh``): ``pastiche`` is this
    rank's rows of its images, sharded along H over ``space`` (spatial
    sharding, the grid's space axis), ``targets[i].content`` the content
    features' rows alike: every 3x3 conv takes its halo rows from
    ``space`` (models/fastcodec.exchanged, parallel/spatial.py's halo
    stack) and the per-image means reduce over it; ``resize_mats`` must
    then be None (the caller resizes the gathered image)."""
    if resize_mats is not None:
        pastiche = apply_resample(pastiche, *resize_mats)
    pastiche = pastiche.to(enc_params[0][0][0].dtype)

    def ot_stage(i, feat):
        feat = feat.float()
        tgt = targets[i]
        if pca_flags[i]:
            feat = feat @ tgt.eigvecs
        rot = (_stage_rotations(rotations, pass_idx, i, iters[i],
                                feat.shape[-1], feat.device, run_key,
                                tgt.k_mask) if iters[i] else None)
        feat = transport.transport_loop(
            None, feat, tgt.stats, iters[i], mode, content_feature=tgt.content,
            content_strength=strengths[i], rotations=rot,
            use_pallas=use_pallas, k_mask=tgt.k_mask, cov_prop=cov_prop,
            mesh=mesh, mean_mesh=space)
        if pca_flags[i]:
            feat = feat @ tgt.eigvecs.T
        return feat

    if stage_codecs is not None:
        # relu1/relu2-scale codec on the CUDA kernels; the image lives as
        # post-renorm RGB between stages (models/fastcodec.py)
        rgb = fastcodec.pixels_to_rgb(enc_params[0][0], pastiche)
        for i, sc in enumerate(stage_codecs):
            rgb = fastcodec.decode_tail(
                sc, ot_stage(i, fastcodec.encode_head(sc, rgb, pad_mode,
                                                      space)),
                pad_mode, space)
        return rgb

    enc, dec = encode, decode
    if space is not None:   # the F.conv2d halo stack on this rank's rows
        from .parallel.spatial import decode_spatial, encode_spatial

        def enc(p, d, x, pad):
            return encode_spatial(p, d, x, space, pad)

        def dec(p, d, x, pad):
            return decode_spatial(p, d, x, space, pad)
    for i, d in enumerate(depths):
        feat = ot_stage(i, enc(enc_params[i], d, pastiche, pad_mode))
        pastiche = dec(dec_params[i], d, feat.to(pastiche.dtype), pad_mode)
    return pastiche.float()


def _pass_stages_chunked_impl(enc_params, dec_params, pastiche, targets, *,
                              depths, iters, mode: str, pca_flags,
                              n_chunks: int, resize_mats=None,
                              stage_codecs=None, run_key: int = 0,
                              pass_idx: int = 0,
                              rotations: Optional[RotationSource] = None,
                              pad_mode: str = "reflect", mesh=None):
    """One pass with the batch run through the codec in ``n_chunks`` equal
    chunks, so that the conv activations scale with the chunk,
    not the batch (the counterpart of the JAX package's
    ``_pass_stages_chunked_impl``). The only coupling between images in a
    stage is the joint (mu, cov) of the projected k-wide float32 features,
    so each stage

      1. encodes and projects chunk by chunk, keeping only the projected
         features of the whole batch;
      2. builds the stage's composed affine map from their joint moments
         (per-image means, the covariance pooled over every chunk) with the
         rotation stream of the unchunked run (:func:`_stage_rotations`);
      3. applies the map, unprojects and decodes chunk by chunk.

    The math of :func:`_pass_stages_impl` for moment modes with
    cov_propagation and no content; only the covariance's summation order
    differs. With ``stage_codecs`` every chunk runs on the codec kernels,
    the chunks' images living as post-renorm RGB between stages. With a
    ``mesh`` the batch is this rank's shard, chunked, and the stage's Gram
    and sample count are summed over the ranks once (batch_chunk x DP)."""
    if resize_mats is not None:
        pastiche = apply_resample(pastiche, *resize_mats)
    conv_dtype = enc_params[0][0][0].dtype
    imgs = list(pastiche.to(conv_dtype).chunk(n_chunks))
    del pastiche
    if stage_codecs is not None:
        imgs = [fastcodec.pixels_to_rgb(enc_params[0][0], x) for x in imgs]
    for i, d in enumerate(depths):
        tgt = targets[i]
        feats = []
        for j, x in enumerate(imgs):
            f = (fastcodec.encode_head(stage_codecs[i], x, pad_mode)
                 if stage_codecs is not None
                 else encode(enc_params[i], d, x, pad_mode))
            f = f.float()
            imgs[j] = None
            feats.append(f @ tgt.eigvecs if pca_flags[i] else f)
        c = feats[0].shape[-1]
        affine = None
        if iters[i]:
            mus, gram, n = [], 0.0, 0
            for f in feats:
                mu = f.mean(dim=(1, 2), keepdim=True)
                xc = (f - mu).reshape(-1, c)
                mus.append(mu)
                gram = gram + xc.T @ xc
                n += xc.shape[0]
            if mesh is not None:
                gram, n = mesh.psum(gram), n * mesh.size
            rot = _stage_rotations(rotations, pass_idx, i, iters[i], c,
                                   feats[0].device, run_key, tgt.k_mask)
            A, bias = transport.stage_affine_map(
                rot, torch.cat(mus), gram / n, tgt.stats, mode)
            affine = (A, bias.chunk(n_chunks))
        for j in range(n_chunks):
            f, feats[j] = feats[j], None
            if affine is not None:
                f = (f.reshape(-1, c) @ affine[0]).reshape(f.shape) + affine[1][j]
            if pca_flags[i]:
                f = f @ tgt.eigvecs.T
            imgs[j] = (fastcodec.decode_tail(stage_codecs[i], f, pad_mode)
                       if stage_codecs is not None
                       else decode(dec_params[i], d, f.to(conv_dtype),
                                   pad_mode))
    return torch.cat(imgs).float()


def _run_stages_chunked_impl(enc_params, dec_params, pastiche, targets_all,
                             run_key, *, depths, plans, mode: str,
                             pca_flags_all, n_chunks: int, resize_mats_all,
                             stage_codecs=None,
                             rotations: Optional[RotationSource] = None,
                             pad_mode: str = "reflect"):
    """The whole run's pass chain, batch-chunked (see
    :func:`_pass_stages_chunked_impl`)."""
    for p, (_, iters) in enumerate(plans):
        pastiche = _pass_stages_chunked_impl(
            enc_params, dec_params, pastiche, targets_all[p], depths=depths,
            iters=iters, mode=mode, pca_flags=pca_flags_all[p],
            n_chunks=n_chunks, resize_mats=resize_mats_all[p],
            stage_codecs=stage_codecs, run_key=run_key, pass_idx=p,
            rotations=rotations, pad_mode=pad_mode)
    return pastiche


def _run_stages_impl(enc_params, dec_params, pastiche, targets_all, run_key,
                     *, depths, plans, mode: str, strengths_all, pca_flags_all,
                     resize_mats_all, stage_codecs=None,
                     use_pallas: bool = True, content_px=None,
                     color_mode: Optional[str] = None,
                     rotations: Optional[RotationSource] = None,
                     color_rotations=None, cov_prop: bool = True,
                     pad_mode: str = "reflect"):
    """The whole run's pass chain, then the color-transfer tail.
    ``plans``: per pass (resize_to | None, iters tuple); ``resize_mats_all``:
    the matching (wh, ww) or None.

    ``color_mode`` ("lum" | "opt", with ``content_px`` the content pixels)
    swaps the pastiche's lightness into the content's colors; "opt" then
    matches the pastiche to that target by COLOR_STEPS pixel-space cdf
    steps, step i rotated by a 3x3 QR rotation drawn from (run_key,
    COLOR_KEY, i), or by ``color_rotations[i]`` when given (tests)."""
    for p, (_, iters) in enumerate(plans):
        pastiche = _pass_stages_impl(
            enc_params, dec_params, pastiche, targets_all[p], depths=depths,
            iters=iters, mode=mode, strengths=strengths_all[p],
            pca_flags=pca_flags_all[p], resize_mats=resize_mats_all[p],
            stage_codecs=stage_codecs, run_key=run_key, pass_idx=p,
            use_pallas=use_pallas, rotations=rotations, cov_prop=cov_prop,
            pad_mode=pad_mode)
    return _color_tail(pastiche, content_px, color_mode, run_key, use_pallas,
                       color_rotations)


def _color_tail(pastiche, content_px, color_mode: Optional[str], run_key: int,
                use_pallas: bool = True, color_rotations=None):
    """The color-transfer tail of :func:`_run_stages_impl` on the whole
    output (``color_mode`` None: the pastiche as it is)."""
    if color_mode is None:
        return pastiche
    target = colors.swap_lightness(content_px, pastiche)
    if color_mode == "lum":
        return target
    samples = target.reshape(-1, target.shape[-1])
    for i in range(COLOR_STEPS):
        rot = gen = None
        if color_rotations is not None:
            rot = torch.as_tensor(np.asarray(color_rotations[i], np.float32))
        else:
            gen = generator(pastiche.device, run_key, COLOR_KEY, i)
        pastiche = transport.ot_step_cdf(gen, pastiche, samples, use_pallas,
                                         rotation=rot)
    return pastiche


# ---------------------------------------------------------------------------


class Synthesizer:
    """Holds the VGG bank + static schedule and runs the algorithm on one
    device (``None`` = the GPU; tests pass ``device="cpu"``).

    With ``cfg.num_devices = N > 1`` or ``cfg.spatial_devices = S > 1`` the
    synthesizer is one rank of a multi-device run (``mesh``: a
    parallel.mesh.Mesh of N * S ranks; None builds it from the current
    process group, and raises without one). Every rank runs the same calls
    with the whole pastiche and gets the whole result back. The device is
    the mesh's. Three layouts, as in the JAX package:

    * batch data parallelism (N > 1, S = 1): each rank runs its B/N images,
      the transport statistics reduced over the mesh (parallel/shard_ot.py).
      Synthesis only: a content run (batch 1) takes the single-device path;
    * spatial sharding (S > 1, N = 1, batch 1): each rank runs its H/S rows
      of the image, every 3x3 conv on halo rows from its neighbours, the
      statistics global (parallel/spatial.py); style transfer too, the
      content features' rows alike. Every pass's H must divide by
      S * 2^(depth-1);
    * the 2-D grid (N, S > 1): rank d * S + s runs row block s of batch
      shard d (parallel/grid.py; parallel.mesh.make_grid_mesh). Synthesis
      only.

    Under the two row layouts each pass's multires resize runs on the
    gathered image, and the color tail on the gathered output."""

    def __init__(self, cfg: OptexConfig, bank: Optional[VGGBank] = None,
                 device=None, mesh=None):
        self.cfg = cfg.validate()
        n_data, n_space = cfg.num_devices, cfg.spatial_devices
        if n_data * n_space > 1:
            from .parallel import mesh as mesh_mod

            if n_space > 1 and n_data > 1:
                if mesh is None or not mesh.grid:
                    mesh = mesh_mod.make_grid_mesh(
                        n_data, n_space,
                        device=mesh.device if mesh is not None else device)
            elif mesh is None:
                mesh = mesh_mod.make_mesh(
                    n_data * n_space, axis="space" if n_space > 1 else "data",
                    device=device)
            elif n_space > 1:
                mesh = mesh.with_axis("space")
        if mesh is not None:
            if mesh.size != n_data * n_space:
                raise ValueError(
                    f"a mesh of {mesh.size} ranks for num_devices {n_data}"
                    + f" x spatial_devices {n_space}" * (n_space > 1))
            if cfg.batch % n_data:
                raise ValueError(f"batch {cfg.batch} not divisible by "
                                 f"num_devices {n_data}")
            if device is not None and torch.device(device).type != \
                    mesh.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.mesh = mesh
        # the mesh along H (the spatial and grid layouts), or None
        self.space = (None if mesh is None or n_space == 1 else
                      mesh.space if mesh.grid else mesh)
        self.device = resolve_device(device)
        if not cfg.use_pallas and self.device.type != "cpu":
            raise ValueError("use_pallas=False runs the cdf kernels' plain "
                             "versions, a CPU reference; on a GPU the cdf "
                             "steps run on the CUDA kernels")
        conv_dtype = getattr(torch, cfg.conv_dtype)
        self.bank = (bank.to(self.device, conv_dtype) if bank is not None
                     else VGGBank(cfg.depth, device=self.device,
                                  dtype=conv_dtype))
        self.depth = self.bank.max_depth
        self.iters_table, self.sizes = schedule.iters_and_sizes(
            cfg.size, cfg.iters, cfg.passes, not cfg.no_multires,
            quirk=cfg.compat_schedule_quirk, num_layers=self.depth)
        check_pass_sizes(self.sizes, self.depth, cfg.tileable, n_space)
        # tileable: circular conv padding and wrap-tap pastiche resizes;
        # style and content prep keep reflect taps (vgg.encode_taps)
        self.pad_mode = "wrap" if cfg.tileable else "reflect"
        # layer-loop position l uses depth D-l (deepest first)
        self.layer_depths = [self.depth - l for l in range(self.depth)]
        self.stage_codecs = (fastcodec.pack_stages(
            [self.bank.enc_params[d] for d in self.layer_depths],
            [self.bank.dec_params[d] for d in self.layer_depths],
            self.layer_depths)
            if fastcodec.eligible(cfg.fast_codec, self.device) else None)
        self._run_counter = 0
        self._resample = {}
        # cross-run style prep cache (LRU), keyed ((styles_token,
        # fingerprint), pass key): see run(styles_token=)
        self._style_prep_cache = OrderedDict()
        # the realised per-(pass, layer) PCA widths of the last run, and the
        # style preps dispatched since it began (none when the styles_token
        # cache held every pass's)
        self.last_run_ks = None
        self.last_run_style_preps = 0
        self.reseed(cfg.seed)

    def reseed(self, seed: Optional[int]) -> None:
        """(Re-)key for ``seed``: an explicit seed resets to its
        deterministic key; ``None`` draws fresh entropy (once, after a
        seeded phase) and every run then folds a run counter."""
        if seed is None:
            if getattr(self, "_seeded", True):
                self.key = int(np.random.SeedSequence().entropy % (2 ** 63))
                if self.mesh is not None:   # one key for every rank
                    self.key = self.mesh.broadcast_int(self.key)
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

    def _plan_passes(self, pastiche_hw, content_hw=None):
        """Per-pass [(size, resize?, target hw)]: the reference's gate skips a
        pass's resize when EITHER pastiche dim already equals its size. With
        a content image the target follows the content's aspect
        (``get_size(..., oversize=True)``). With ``out_width`` (synthesis) the
        width follows the pass size by the same aspect rule and the gate
        compares the full (H, W) pair: the either-dim gate would skip a pass
        whose height target equals the current width (out_width 576 at size
        512 would skip the final pass)."""
        cfg = self.cfg
        plan, cur = [], tuple(pastiche_hw)
        for size in self.sizes:
            if cfg.out_width and content_hw is None:
                target = schedule.get_size(size, 1.0, cfg.size, cfg.out_width)
                if cur != target:
                    plan.append((size, True, target))
                    cur = target
                else:
                    plan.append((size, False, None))
            elif cur[0] != size and cur[1] != size:
                if content_hw is not None:
                    target = schedule.get_size(size, 1.0, content_hw[0],
                                               content_hw[1], oversize=True)
                else:
                    target = (size, size)
                plan.append((size, True, target))
                cur = target
            else:
                plan.append((size, False, None))
        return plan

    # All-pass style-prep budget in bytes, above which run() switches to the
    # low-memory prep; None reads OPTEX_PREP_PREFETCH_GB at run time
    # (config.prep_prefetch_bytes). A class attribute so tests can pin it.
    _PREP_PREFETCH_BYTES = None

    def _prep_budget_bytes(self) -> int:
        return (self._PREP_PREFETCH_BYTES
                if self._PREP_PREFETCH_BYTES is not None
                else config_mod.prep_prefetch_bytes())

    def _prep_prefetch_bytes(self, plan, styles) -> int:
        """The all-pass style prep's footprint: the float32 multi-tap
        features of every distinct pass prep, which coexist from phase A
        until the finished targets replace them (relu1 of a 4096-px style is
        H x W x 64 float32 a pass)."""
        channels = [64, 128, 256, 512, 512]
        seen = set()
        total = 0
        for (size, rs, _) in plan:
            ck = size if rs else None
            if ck in seen:
                continue
            seen.add(ck)
            for s in styles:
                if rs:
                    h, w = schedule.get_size(size, self.cfg.style_scale,
                                             s.shape[1], s.shape[2])
                else:
                    h, w = s.shape[1], s.shape[2]
                for d in range(1, self.depth + 1):
                    total += (h // 2 ** (d - 1)) * (w // 2 ** (d - 1)) \
                        * channels[d - 1] * 4
        return total

    def _resample_mats(self, in_hw, out_hw, circular: bool = False):
        """The (wh, ww) resize weights on the device, cached; ``circular``
        wraps the taps (the tileable pastiche's pass resizes only)."""
        key = (tuple(in_hw), tuple(out_hw), circular)
        if key not in self._resample:
            wh, ww = resample_pair(*key)
            self._resample[key] = (torch.from_numpy(wh).to(self.device),
                                   torch.from_numpy(ww).to(self.device))
        return self._resample[key]

    def _dispatch_style_prep(self, styles, size: int, do_resize: bool):
        """One pass's style resize + multi-tap encode + spectra. Gate-skip
        passes encode the ORIGINAL styles, like the reference."""
        cfg = self.cfg
        self.last_run_style_preps += 1
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

    def _choose_widths(self, spectra, svals_np=None):
        """One pass's PCA widths: (widths, true-rank masks), one per depth.
        Without a padded width the widths are the host k-decisions
        (``svals_np``: the fetched singular values; None fetches them here)
        and the masks None (0 = no PCA). pca_bucket rounds each width up to
        the bucket (at most C), the true rank riding along as a 0-d int32
        tensor on the device; pca_traced_k takes the full width C and the
        rank from :func:`_traced_ks`, with no host decision at all."""
        cfg = self.cfg
        if cfg.no_pca:
            return tuple(0 for _ in spectra), tuple(None for _ in spectra)
        if cfg.pca_traced_k:
            return (tuple(sf.shape[-1] for (sf, _, _) in spectra),
                    _traced_ks([sv for (_, sv, _) in spectra]))
        if svals_np is None:
            svals_np = [sv.cpu().numpy() for (_, sv, _) in spectra]
        true = [transport.choose_k(sv) for sv in svals_np]
        if cfg.pca_bucket:
            widths = tuple(min(-(-t // cfg.pca_bucket) * cfg.pca_bucket,
                               sf.shape[-1])
                           for t, (sf, _, _) in zip(true, spectra))
            return widths, tuple(torch.tensor(t, dtype=torch.int32,
                                              device=self.device)
                                 for t in true)
        return tuple(true), tuple(None for _ in true)

    def _finish_style_prep(self, spectra, ks, k_masks=None, regions=None,
                           weights=None):
        """After the k-decisions: projected statistics. Returns
        [(eigvecs, stats, scalar style mean)] per depth (deepest first).
        ``ks`` are the widths, ``k_masks`` the true ranks of padded widths
        (None: exact). With several styles, the pass's mask ``regions`` (see
        :meth:`_mix_draw`) and ``weights`` blend the projected maps before
        their statistics are taken; the scalar means stay the PRE-mix ones,
        which the content re-centring uses."""
        cfg = self.cfg
        need_samples = cfg.hist_mode in ("cdf", "sort")
        projected = _project_pass([sf for (sf, _, _) in spectra],
                                  [v for (_, _, v) in spectra], ks=ks,
                                  true_ks=k_masks)
        sfs = [sf for sf, _, _ in projected]
        if regions is None:
            stats = [transport.style_stats(sf, need_samples) for sf in sfs]
        else:
            stats = _mix_pass(sfs, regions, weights, mode=cfg.hist_mode,
                              need_samples=need_samples,
                              use_pallas=cfg.use_pallas)
        return [(eigvecs, st, mean)
                for (_, eigvecs, mean), st in zip(projected, stats)]

    def _mix_weights(self, n_styles: int) -> torch.Tensor:
        """The blend's (N,) float32 weights, normalised in float64:
        (1 - alpha, alpha) for two styles without ``mixing_weights`` (the
        reference's alpha blend), else ``mixing_weights`` (uniform by
        default)."""
        cfg = self.cfg
        w = cfg.mixing_weights
        if w is not None and len(w) != n_styles:
            raise ValueError(f"mixing_weights has {len(w)} weights for "
                             f"{n_styles} styles")
        if w is None:
            w = ([1.0 - cfg.mixing_alpha, cfg.mixing_alpha] if n_styles == 2
                 else [1.0] * n_styles)
        w = np.asarray(w, dtype=np.float64)
        return torch.as_tensor((w / w.sum()).astype(np.float32),
                               device=self.device)

    def _mix_draw(self, run_key: int, p: int, hw, weights) -> torch.Tensor:
        """Pass ``p``'s (h, w) mask regions (:func:`_mix_regions`) from a
        uniform drawn by the generator (run_key, MIX_KEY, p)."""
        u = torch.rand(tuple(hw), generator=generator(self.device, run_key,
                                                      MIX_KEY, p),
                       device=self.device, dtype=torch.float32)
        return _mix_regions(u, weights)

    def _assemble_targets(self, slim, cont=None, k_masks=None):
        """Finished style targets + this pass's content prep (``cont``: the
        pass's content pixels, or None) + the true-rank masks."""
        content_feats = [None] * len(slim)
        k_masks = k_masks or [None] * len(slim)
        if cont is not None:
            content_feats = _content_prep_pass(
                self.bank.enc_params[self.depth], cont,
                [s[0] for s in slim], [s[2] for s in slim], k_masks,
                depth=self.depth, use_pca=not self.cfg.no_pca)
        return [LayerTargets(stats=stats, eigvecs=eigvecs, content=cf,
                             k_mask=km)
                for (eigvecs, stats, _), cf, km in zip(slim, content_feats,
                                                       k_masks)]

    def _stage_strengths(self, targets):
        """The reference's content rule: a pull only at the three deepest
        layer-loop positions (l <= 2), at content_strength / 16, / 8, / 4
        ("index"; "depth" anchors at VGG depths >= 3, strength / 2^(d-1) —
        the two coincide at depth 5). A zero strength drops the content
        target, so the stage takes the plain composed loop."""
        cfg = self.cfg
        adj, strengths = [], []
        for l, tgt in enumerate(targets):
            d = self.layer_depths[l]
            if cfg.content_anchor == "depth":
                has_content = tgt.content is not None and d >= 3
                strength = cfg.content_strength / 2 ** (d - 1)
            else:
                has_content = tgt.content is not None and l <= 2
                strength = cfg.content_strength / 2 ** (4 - l)
            has_content = has_content and strength != 0.0
            adj.append(tgt if has_content else tgt._replace(content=None))
            strengths.append(float(strength) if has_content else 0.0)
        return adj, tuple(strengths)

    def _chunks(self, batch: int, has_content: bool) -> int:
        """How many chunks the batch runs in (1: unchunked). A batch that
        ``batch_chunk`` cannot split, a content run or OPTEX_NO_COV_PROP
        raises: a chunked run never falls back to the unchunked one."""
        chunk = self.cfg.batch_chunk
        if not chunk or batch <= chunk:
            return 1
        if batch % chunk:
            raise ValueError(f"batch {batch} not divisible by batch_chunk "
                             f"{chunk}")
        if has_content:
            raise ValueError("batch_chunk applies to synthesis only (content "
                             "runs are single-image)")
        if not transport.cov_propagation_enabled():
            raise ValueError("batch_chunk applies the composed stage map; "
                             "OPTEX_NO_COV_PROP=1 turns it off")
        return batch // chunk

    def run(self, pastiche, styles, content=None, verbose: bool = False,
            key: Optional[int] = None,
            rotations: Optional[RotationSource] = None,
            color_rotations=None,
            mix_draws: Optional[MixDrawSource] = None,
            styles_token=None, quantize_uint8: bool = False) -> torch.Tensor:
        """Synthesis, or style transfer when ``content`` (1, Hc, Wc, 3) is
        given; two or more ``styles`` mix. ``pastiche`` (B, H, W, 3; B = 1
        with a content image) and ``styles`` [(1, h, w, 3)] are NHWC float32
        arrays or tensors; returns the float32 (B, ...) result on this
        synthesizer's device, or with ``quantize_uint8`` the PNG-ready uint8
        one (:func:`_quant_u8`, on the device).

        ``styles_token``: any hashable naming the styles' content. With it
        each pass's style prep (spectra, widths and, for one style, the
        finished targets) is kept on this instance and reused by later runs
        with the same token and the same styles: the token is checked
        against a fingerprint of the styles (:func:`_styles_fingerprint`),
        so a stale token with other styles recomputes.

        ``key`` overrides the run key (default :meth:`next_run_key`);
        ``rotations`` injects every stage's rotation stack,
        ``color_rotations`` (COLOR_STEPS, 3, 3) the color tail's and
        ``mix_draws`` every pass's mixing-mask draw (tests).

        On a mesh every rank passes the whole pastiche batch and the same
        arguments, keeps its images (and under spatial sharding its rows),
        and gets the whole result back; rank 0's finished style targets are
        broadcast, so that no rank runs with another PCA width or
        eigenvector sign (a width that differed would pair mismatched
        collectives)."""
        cfg = self.cfg
        dev = self.device
        self.last_run_style_preps = 0
        run_key = key if key is not None else self.next_run_key()
        if styles_token is not None:
            styles_token = (styles_token, _styles_fingerprint(styles))
        pastiche = torch.as_tensor(pastiche, dtype=torch.float32)
        # spatial sharding alone runs content runs too; DP and the grid are
        # synthesis-only
        mesh = (self.mesh if content is None or (self.space is not None
                                                 and not self.mesh.grid)
                else None)
        space = self.space if mesh is not None else None
        data = None if mesh is None else (
            mesh.data if mesh.grid else None if space is not None else mesh)
        if data is not None:
            if pastiche.shape[0] % data.size:
                raise ValueError(f"batch {pastiche.shape[0]} not divisible "
                                 f"by num_devices {data.size}")
            b = pastiche.shape[0] // data.size
            pastiche = pastiche[data.rank * b:(data.rank + 1) * b]
        pastiche = pastiche.to(dev, copy=True)
        styles = [torch.as_tensor(s, dtype=torch.float32).to(dev) for s in styles]
        if any(s.shape != styles[0].shape for s in styles[1:]):
            # mixing blends the styles' feature maps position by position
            raise ValueError("style images must have the same shape; got "
                             f"{[tuple(s.shape) for s in styles]}")
        if content is not None:
            content = torch.as_tensor(content, dtype=torch.float32).to(dev)
        elif cfg.color_transfer is not None:
            raise ValueError("Color transfer requires content image")
        if content is not None and pastiche.shape[0] != 1:
            # the reference ignores --batch with a content image
            raise ValueError("style transfer runs one image; got a pastiche "
                             f"batch of {pastiche.shape[0]}")
        n_chunks = self._chunks(pastiche.shape[0], content is not None)
        n_styles = len(styles)

        # phase A: every distinct pass's style prep, ahead of the stages
        # (gate-skip passes encode the ORIGINAL styles, so they share one),
        # or found in the styles_token cache. Above the prefetch budget
        # (low-memory prep) each prep is dispatched in phase C instead, and
        # its spectra are freed after their last use.
        plan = self._plan_passes(
            pastiche.shape[1:3],
            tuple(content.shape[1:3]) if content is not None else None)
        if space is not None:
            # with a content image the pass heights follow the content's
            # aspect: every pass's H must split evenly at every depth
            from .parallel.spatial import check_spatial_divisibility

            cur_h = pastiche.shape[1]
            for (_, rs, hw) in plan:
                if rs:
                    cur_h = hw[0]
                check_spatial_divisibility(cur_h, space.size, self.depth)
        low_mem = (self._prep_prefetch_bytes(plan, styles)
                   > self._prep_budget_bytes())
        entries, pending, local = [], [], {}
        for (size, rs, _) in plan:
            ck = size if rs else None
            full = (styles_token, ck)
            if styles_token is not None and full in self._style_prep_cache:
                self._style_prep_cache.move_to_end(full)
                entry = self._style_prep_cache[full]
            elif ck in local:
                entry = local[ck]
            else:
                entry = _StylePrep(None if low_mem else
                                   self._dispatch_style_prep(styles, size, rs),
                                   full)
                local[ck] = entry
                if not low_mem:
                    pending.append(entry)
            entries.append(entry)
        last_use = {id(e): p for p, e in enumerate(entries)}

        # phase B: ONE host fetch of every new prep's eigenvalues for the
        # k-decisions (none with pca_traced_k)
        svals = [None] * len(pending)
        if pending and not cfg.no_pca and not cfg.pca_traced_k:
            flat = torch.cat([sv for e in pending for (_, sv, _) in e.spectra]
                             ).cpu().numpy()
            off = 0
            for j, e in enumerate(pending):
                svals[j] = []
                for (_, sv, _) in e.spectra:
                    svals[j].append(flat[off:off + sv.shape[0]])
                    off += sv.shape[0]
        for e, sv in zip(pending, svals):
            e.widths, e.masks = self._choose_widths(e.spectra, sv)
            if mesh is not None:
                e.widths, e.masks = self._agree_widths(e.widths, e.masks)
            if styles_token is not None:
                self._style_prep_cache[e.key] = e
        self._evict_style_preps()

        # per-pass content, resized from the ORIGINAL (as the reference does)
        conts, resized = [], {}
        for (_, rs, hw) in plan:
            if content is None or not rs or tuple(content.shape[1:3]) == hw:
                conts.append(content)
                continue
            if hw not in resized:
                resized[hw] = apply_resample(
                    content, *self._resample_mats(content.shape[1:3], hw))
            conts.append(resized[hw])

        # phase C: every pass's targets. One style's finished targets are
        # shared by the passes of an entry (and, tokened, across runs);
        # mixing draws its mask per pass, so its finish runs once a pass.
        # The mask is drawn at the second-deepest depth's size and
        # nearest-resized to every depth.
        weights = self._mix_weights(n_styles) if n_styles > 1 else None
        targets_all, strengths_all, pca_flags_all = [], [], []
        plans, mats_all = [], []
        cur_hw = tuple(pastiche.shape[1:3])
        for p, (size, rs, hw) in enumerate(plan):
            if verbose:
                print(f"Pass {p}, size {size}", flush=True)
                for d in self.layer_depths:
                    print(f"Layer: relu{d}_1", flush=True)
            e = entries[p]
            if e.widths is None and e.slim is None:
                # low-memory prep: this pass's prep is dispatched here and
                # its k-decision fetched alone
                if e.spectra is None:
                    e.spectra = self._dispatch_style_prep(styles, size, rs)
                e.widths, e.masks = self._choose_widths(e.spectra)
                if mesh is not None:
                    e.widths, e.masks = self._agree_widths(e.widths, e.masks)
                if styles_token is not None and n_styles == 1:
                    # mixing entries are not kept: their targets depend on
                    # the pass's mask, so the cache could only pin the very
                    # spectra this prep sheds
                    self._style_prep_cache[e.key] = e
            if e.slim is not None:
                slim = e.slim
            elif n_styles == 1:
                slim = self._finish_style_prep(e.spectra, e.widths, e.masks)
                e.slim = slim = (self._agree_targets(slim) if mesh is not None
                                 else slim)
            else:
                mask_hw = tuple(e.spectra[1 if len(e.spectra) > 1 else 0][0]
                                .shape[1:3])
                if mix_draws is not None:
                    regions = torch.as_tensor(
                        np.array(mix_draws(p, mask_hw, n_styles)),
                        device=dev).long()
                else:
                    regions = self._mix_draw(run_key, p, mask_hw, weights)
                slim = self._finish_style_prep(e.spectra, e.widths, e.masks,
                                               regions, weights)
                if mesh is not None:
                    slim = self._agree_targets(slim)
            targets, strengths = self._stage_strengths(
                self._assemble_targets(slim, conts[p], e.masks))
            if space is not None:
                # each rank pulls its rows toward the content's rows
                from .parallel.spatial import own_rows

                targets = [t if t.content is None else
                           t._replace(content=own_rows(t.content, space))
                           for t in targets]
            cached = (styles_token is not None
                      and self._style_prep_cache.get(e.key) is e)
            if (low_mem and last_use[id(e)] == p
                    and (not cached or e.slim is not None)):
                e.spectra = None   # nothing later reads them
            targets_all.append(targets)
            strengths_all.append(strengths)
            pca_flags_all.append(tuple(t.eigvecs is not None for t in targets))
            plans.append((hw if rs else None,
                          tuple(int(i) for i in self.iters_table[p])))
            mats_all.append(self._resample_mats(cur_hw, hw, cfg.tileable)
                            if rs else None)
            if rs:
                cur_hw = tuple(hw)
        self.last_run_ks = [e.widths for e in entries]
        self._evict_style_preps()
        if styles_token is not None:
            # kept entries: the finished targets replace the spectra
            for e in entries:
                if e.slim is not None:
                    e.spectra = None

        # phase D: the pass chain
        enc_all = [self.bank.enc_params[d] for d in self.layer_depths]
        dec_all = [self.bank.dec_params[d] for d in self.layer_depths]
        if mesh is not None and space is not None:
            out = self._run_rows(enc_all, dec_all, pastiche, targets_all,
                                 run_key, plans, strengths_all, pca_flags_all,
                                 mats_all, rotations)
            if mesh.grid:
                out = mesh.data.all_gather(out)
            out = _color_tail(out, content, cfg.color_transfer, run_key,
                              cfg.use_pallas, color_rotations)
            return _quant_u8(out) if quantize_uint8 else out
        if mesh is not None:
            out = self._run_dp(enc_all, dec_all, pastiche, targets_all,
                               run_key, plans, strengths_all, pca_flags_all,
                               mats_all, n_chunks, rotations)
            return mesh.all_gather(_quant_u8(out) if quantize_uint8 else out)
        if n_chunks > 1:
            out = _run_stages_chunked_impl(
                enc_all, dec_all, pastiche, targets_all, run_key,
                depths=tuple(self.layer_depths), plans=plans,
                mode=cfg.hist_mode, pca_flags_all=pca_flags_all,
                n_chunks=n_chunks, resize_mats_all=mats_all,
                stage_codecs=self.stage_codecs, rotations=rotations,
                pad_mode=self.pad_mode)
        else:
            out = _run_stages_impl(
                enc_all, dec_all, pastiche, targets_all, run_key,
                depths=tuple(self.layer_depths), plans=plans,
                mode=cfg.hist_mode, strengths_all=strengths_all,
                pca_flags_all=pca_flags_all, resize_mats_all=mats_all,
                stage_codecs=self.stage_codecs, use_pallas=cfg.use_pallas,
                content_px=content, color_mode=cfg.color_transfer,
                rotations=rotations, color_rotations=color_rotations,
                cov_prop=cfg.cov_propagation, pad_mode=self.pad_mode)
        return _quant_u8(out) if quantize_uint8 else out

    def _agree_widths(self, widths, masks):
        """Rank 0's PCA widths and true-rank masks on every rank (one
        broadcast): the widths fix the shapes of every later collective."""
        mesh = self.mesh
        vals = list(widths) + [-1 if m is None else int(m) for m in masks]
        dev = mesh.device if mesh.backend == "nccl" else "cpu"
        got = mesh.broadcast(torch.tensor(vals, dtype=torch.int64,
                                          device=dev)).tolist()
        d = len(widths)
        return (tuple(got[:d]),
                tuple(None if m is None else torch.tensor(
                    g, dtype=torch.int32, device=self.device)
                    for m, g in zip(masks, got[d:])))

    def _agree_targets(self, slim):
        """Rank 0's finished targets [(eigvecs, stats, scalar mean)] on every
        rank, in one broadcast of their float32 values (the shapes agree:
        the widths were agreed first)."""
        fields = [t for eig, st, mean in slim
                  for t in (eig, st.mu, st.cov_raw, st.samples, mean)]
        live = [t for t in fields if t is not None]
        flat = self.mesh.broadcast(torch.cat([t.reshape(-1) for t in live]))
        vals = iter(flat.split([t.numel() for t in live]))
        got = [None if t is None else next(vals).view(t.shape)
               for t in fields]
        return [(got[i], transport.StyleStats(*got[i + 1:i + 4]), got[i + 4])
                for i in range(0, len(got), 5)]

    def _run_dp(self, enc_all, dec_all, pastiche, targets_all, run_key,
                plans, strengths_all, pca_flags_all, mats_all, n_chunks,
                rotations):
        """The pass chain of this rank's batch shard: one
        parallel.shard_ot.make_sharded_pass program per pass, its transport
        statistics reduced over the mesh."""
        from .parallel.shard_ot import make_sharded_pass

        cfg = self.cfg
        for p, (_, iters) in enumerate(plans):
            tg = targets_all[p]
            stage = make_sharded_pass(
                self.mesh, depths=tuple(self.layer_depths), iters=iters,
                mode=cfg.hist_mode, strengths=strengths_all[p],
                pca_flags=pca_flags_all[p], pad_mode=self.pad_mode,
                cov_prop=cfg.cov_propagation, n_chunks=n_chunks,
                fast_codec=self.stage_codecs is not None)
            pastiche = stage(
                enc_all, dec_all, pastiche, tuple(t.stats.mu for t in tg),
                tuple(t.stats.cov_raw for t in tg),
                tuple(t.stats.samples for t in tg),
                tuple(t.eigvecs for t in tg), tuple(t.content for t in tg),
                run_key, tuple(t.k_mask for t in tg), pass_idx=p,
                stage_codecs=self.stage_codecs, resize_mats=mats_all[p],
                rotations=rotations, use_pallas=cfg.use_pallas)
        return pastiche

    def _run_rows(self, enc_all, dec_all, pastiche, targets_all, run_key,
                  plans, strengths_all, pca_flags_all, mats_all, rotations):
        """The pass chain of this rank's rows (spatial sharding; on the grid
        of its batch shard's rows): one parallel.spatial.make_spatial_pass
        (or parallel.grid.make_grid_pass) program per pass. ``pastiche`` is
        whole along H; before each pass that resizes (and the first) the
        whole image is resized by the single-device op (the multires taps
        cross shards) and each rank keeps its rows, the image gathered
        along H (one all_gather) after every pass but the last. Returns the
        whole image along H."""
        from .parallel.grid import make_grid_pass
        from .parallel.spatial import make_spatial_pass, own_rows

        cfg, mesh, space = self.cfg, self.mesh, self.space
        for p, (_, iters) in enumerate(plans):
            if p == 0 or mats_all[p] is not None:
                if p > 0:
                    pastiche = space.all_gather(pastiche, dim=1)
                if mats_all[p] is not None:
                    pastiche = apply_resample(pastiche, *mats_all[p])
                pastiche = own_rows(pastiche, space)
            tg = targets_all[p]
            kw = dict(depths=tuple(self.layer_depths), iters=iters,
                      mode=cfg.hist_mode, strengths=strengths_all[p],
                      pca_flags=pca_flags_all[p], pad_mode=self.pad_mode,
                      cov_prop=cfg.cov_propagation,
                      fast_codec=self.stage_codecs is not None)
            stage = (make_grid_pass(mesh, **kw) if mesh.grid
                     else make_spatial_pass(mesh, **kw))
            pastiche = stage(
                enc_all, dec_all, pastiche, tuple(t.stats.mu for t in tg),
                tuple(t.stats.cov_raw for t in tg),
                tuple(t.stats.samples for t in tg),
                tuple(t.eigvecs for t in tg), tuple(t.content for t in tg),
                run_key, tuple(t.k_mask for t in tg), pass_idx=p,
                stage_codecs=self.stage_codecs, rotations=rotations,
                use_pallas=cfg.use_pallas)
        return space.all_gather(pastiche, dim=1)

    def _evict_style_preps(self) -> None:
        while len(self._style_prep_cache) > 6 * max(self.cfg.passes, 1):
            self._style_prep_cache.popitem(last=False)


def draw_noise(device, run_key: int, shape) -> torch.Tensor:
    """Run ``run_key``'s noise pastiche: float32 uniforms in [0, 1) drawn
    on ``device`` from the generator (run_key, 999)."""
    return torch.rand(shape, generator=generator(device, run_key, 999),
                      device=device, dtype=torch.float32)


def check_pass_sizes(sizes, depth: int, tileable: bool, n_space: int = 1
                     ) -> None:
    """A Synthesizer's refusals of its pass ``sizes`` at ``depth``: a
    tileable run needs each divisible by 2^(depth-1) (an odd size reaches
    ceil-mode pooling's -inf pad row, which breaks the torus equivariance
    that makes the output tile), spatial sharding over ``n_space`` ranks by
    n_space x 2^(depth-1)."""
    if tileable:
        stride = 2 ** (depth - 1)
        for size in sizes:
            if size % stride:
                raise ValueError(
                    f"tileable needs every pass size divisible by "
                    f"{stride} (2^(depth-1)); pass size {size} is not")
    if n_space > 1:
        from .parallel.spatial import check_spatial_divisibility

        for size in sizes:
            check_spatial_divisibility(size, n_space, depth)


def synthesize(cfg: OptexConfig, styles, content=None, pastiche=None,
               verbose: bool = False, device=None, mesh=None):
    """One-call API: build the synthesizer, draw the noise pastiche (the
    content's shape when a content image is given), run. ``mesh``: the
    mesh of a ``num_devices > 1`` or ``spatial_devices > 1`` run (see
    Synthesizer).
    Returns (output NHWC float32 tensor, wall seconds)."""
    synth = Synthesizer(cfg, device=device, mesh=mesh)
    run_key = synth.next_run_key()
    if pastiche is None:
        shape = (tuple(content.shape) if content is not None else
                 (cfg.batch, cfg.size, cfg.out_width or cfg.size, 3))
        pastiche = draw_noise(synth.device, run_key, shape)
    t0 = time.time()
    out = synth.run(pastiche, styles, content, verbose=verbose, key=run_key)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out, time.time() - t0

