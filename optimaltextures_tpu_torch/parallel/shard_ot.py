"""Sharded sliced optimal transport: exact batch data parallelism (the
counterpart of ``optimaltextures_tpu/parallel/shard_ot.py``).

The pastiche batch is split over the ranks of a mesh (one process per
device, parallel/mesh.py) while the matching stays joint over the global
batch, because everything a transport step needs from the sample cloud is

* the per-(image, channel) means, local to a rank's batch shard, and
* the pooled C x C covariance, a sum of each rank's Gram matrix and count.

So each rank takes its centred Gram, one all-reduce gives the global
covariance, every rank builds the same C x C map (the same rotations, drawn
from the same generator seed on every rank: no broadcast) and applies it to
its own samples. cdf reduces its range and target histogram the same way;
sort gathers the rotated samples. The codec never communicates: on the GPU
each rank's stage roundtrips run on the codec kernels at its local batch.

The stage body is the single-device one: :func:`make_sharded_pass` runs
``core._pass_stages_impl`` (or ``_pass_stages_chunked_impl`` for
batch_chunk x DP) with the mesh, which hands it to
``transport.transport_loop``; the step functions here are that loop's steps
with a mesh.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import core, transport
from ..models import fastcodec
from ..ops import histmatch


def _moment_step_sharded(rot, feature, style_mu, style_cov_raw, mode: str,
                         mesh, eps: float = 1.0, sfactor=None):
    """One moment-mode sliced-OT step on this rank's batch shard, the
    covariance pooled over the mesh. ``sfactor`` supplies the style side's
    decomposition (histmatch.style_factor_batch), as the loop does."""
    if sfactor is None:
        return transport._moment_step_with_rot(
            rot, feature, transport.StyleStats(style_mu, style_cov_raw), mode,
            eps, mesh)
    return transport._moment_step_with_factor(rot, feature, style_mu, sfactor,
                                              mode, eps, mesh)


def ot_step_moment_sharded(gen: torch.Generator, feature, style_mu,
                           style_cov_raw, mode: str, mesh, eps: float = 1.0):
    """:func:`_moment_step_sharded` with the rotation drawn from ``gen``,
    seeded alike on every rank."""
    from ..ops.rotation import random_rotation

    rot = random_rotation(gen, feature.shape[-1], feature.device)
    return _moment_step_sharded(rot, feature, style_mu, style_cov_raw, mode,
                                mesh, eps)


def _cdf_step_sharded(rot, feature, style_samples, mesh,
                      use_pallas: bool = True):
    """Sharded cdf matching: the range and the target histogram reduce over
    the mesh (one MIN of the local extremes, one sum of the counts), so the
    256-bin cdf is the global one; the remap runs locally, on the histogram
    and remap kernels on a GPU (one histogram launch for both clouds, only
    the target's counts summed). The style samples are replicated."""
    return transport._sampled_step_with_rot(rot, feature, style_samples, "cdf",
                                            use_pallas, mesh)


def _sort_step_sharded(rot, feature, style_samples, mesh):
    """Exact distributed sort matching: every rank gathers the rotated
    samples in rank order (the single-device flatten order), matches the
    whole cloud and keeps its own samples."""
    return transport._sampled_step_with_rot(rot, feature, style_samples,
                                            "sort", mesh=mesh)


def _sort_step_grid(rot, feature, style_samples, grid):
    """Exact distributed sort matching on the 2-D (batch x height) grid
    (``grid``: a parallel.mesh.GridMesh; ``feature`` this rank's (b, h, W, C)
    block of b images' rows).

    The single-device flatten order of a (B, H, W) batch is image-major, and
    a plain gather of the grid's blocks would interleave every image's rows
    across the space ring. So: gather the space ring (ds, C, b h W), put each
    image's ds row blocks one after the other (each image's rows are then
    contiguous, top to bottom), gather the data axis (whole images in batch
    order: the single-device flatten order), match the whole cloud and keep
    this rank's (data, space) block. The JAX package's ``_sort_step_grid``."""
    c = feature.shape[-1]
    b, h, w, _ = feature.shape
    rf = rot.T @ feature.reshape(-1, c).T                       # (C, b h w)
    rs = rot.T @ style_samples.T
    g = grid.space.all_gather(rf[None])                          # (ds, C, N)
    ds = g.shape[0]
    g = g.reshape(ds, c, b, h * w).permute(1, 2, 0, 3).reshape(c, -1)
    matched = histmatch.sort_match_rows(grid.data.all_gather(g, dim=1), rs)
    ours = matched.reshape(c, grid.data.size, b, ds, h * w)[
        :, grid.data.rank, :, grid.space.rank].reshape(c, b * h * w)
    return (ours.T @ rot.T).reshape(feature.shape)


def sharded_transport_loop(gen, feature, style_mu, style_cov_raw,
                           n_iters: int, mode: str, *, mesh,
                           style_samples=None, content_feature=None,
                           content_strength: float = 0.0, k_mask=None,
                           cov_prop: Optional[bool] = None, rotations=None,
                           use_pallas: bool = True):
    """The batch-DP loop (the JAX package's ``sharded_transport_loop``, its
    ``sharded_transport_loop_axes`` with ``mean_axes=()``): the per-image
    means local to each rank's shard, the Gram matrices, cdf's range and
    histograms and sort's gather over the one mesh axis. The loop is
    ``transport.transport_loop`` with the mesh; the spatial and grid layouts
    are the same loop with the means reduced over the space axis as well
    (parallel/spatial.py, parallel/grid.py)."""
    return transport.transport_loop(
        gen, feature, transport.StyleStats(style_mu, style_cov_raw,
                                           style_samples), n_iters, mode,
        content_feature=content_feature, content_strength=content_strength,
        rotations=rotations, use_pallas=use_pallas, k_mask=k_mask,
        cov_prop=cov_prop, mesh=mesh)


def _chunked_stage_local(enc_p, dec_p, pastiche, style_mu, style_cov_raw,
                         eigvecs, key: int, k_mask, *, depth: int,
                         n_iters: int, mode: str, pca_flag: bool,
                         n_chunks: int, mesh, pad_mode: str = "reflect",
                         pass_idx: int = 0, rotations=None):
    """One stage of the DP pass with this rank's batch shard run through the
    codec in ``n_chunks`` chunks: encode and project chunk by chunk, the
    stage's Gram summed over the chunks and then over the mesh once, the
    composed stage map from the global statistics, and apply, unproject and
    decode chunk by chunk. ``core._pass_stages_chunked_impl`` with one stage
    on the F.conv2d codec (its rotations drawn from (key, pass_idx, 0), or
    ``rotations``); the pass entry (:func:`make_sharded_pass` with
    ``n_chunks``) runs the same on the codec kernels."""
    tgt = core.LayerTargets(transport.StyleStats(style_mu, style_cov_raw),
                            eigvecs if pca_flag else None, None, k_mask)
    return core._pass_stages_chunked_impl(
        [enc_p], [dec_p], pastiche, [tgt], depths=(depth,), iters=(n_iters,),
        mode=mode, pca_flags=(pca_flag,), n_chunks=n_chunks, run_key=key,
        pass_idx=pass_idx, rotations=rotations,
        pad_mode=pad_mode, mesh=mesh)


def make_sharded_pass(mesh, *, depths, iters, mode: str, strengths,
                      pca_flags, axis: str = "data",
                      pad_mode: str = "reflect", cov_prop=None,
                      n_chunks: int = 1, fast_codec: bool = False):
    """ALL of a pass's layer stages on this rank's batch shard: per depth
    (deepest first) encode -> project -> the sharded OT loop -> unproject ->
    decode, as ``core._pass_stages_impl`` (which this runs, with the mesh).

    Returns ``fn(enc_list, dec_list, pastiche_f32, mus, covs, samples,
    eigvecs, contents, key, k_masks, *, pass_idx=0, stage_codecs=None,
    resize_mats=None, rotations=None, use_pallas=True) -> pastiche_f32``;
    the per-layer values come as tuples (None entries allowed), ``key`` is
    the run key (stage i of pass ``pass_idx`` draws its rotations from the
    generator (key, pass_idx, i), the same on every rank) and
    ``resize_mats`` the pass's multires resize. The pastiche is the local
    shard; everything else is replicated.

    ``n_chunks > 1`` composes DP with batch_chunk: each rank runs its shard
    through the codec in chunks while the stage's covariance is summed over
    the mesh once (moment modes with cov_propagation and no content).
    ``fast_codec`` runs each rank's stage roundtrips on the codec kernels
    (models/fastcodec.py; ``stage_codecs`` packed once by the caller, or
    here per call); without it the F.conv2d codec runs (CPU only)."""
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's {mesh.axis!r}")
    cov_prop = True if cov_prop is None else cov_prop

    def fn(enc_list, dec_list, pastiche, mus, covs, samples, eigvecs,
           contents, key, k_masks, *, pass_idx: int = 0, stage_codecs=None,
           resize_mats=None, rotations=None, use_pallas: bool = True):
        if fast_codec and stage_codecs is None:
            stage_codecs = fastcodec.pack_stages(enc_list, dec_list, depths)
        elif not fast_codec:
            stage_codecs = None
        targets = [core.LayerTargets(transport.StyleStats(m, c, s), e, ct, k)
                   for m, c, s, e, ct, k in zip(mus, covs, samples, eigvecs,
                                                contents, k_masks)]
        if n_chunks > 1:
            return core._pass_stages_chunked_impl(
                enc_list, dec_list, pastiche, targets, depths=depths,
                iters=iters, mode=mode, pca_flags=pca_flags,
                n_chunks=n_chunks, resize_mats=resize_mats,
                stage_codecs=stage_codecs, run_key=key, pass_idx=pass_idx,
                rotations=rotations, pad_mode=pad_mode, mesh=mesh)
        return core._pass_stages_impl(
            enc_list, dec_list, pastiche, targets, depths=depths, iters=iters,
            mode=mode, strengths=strengths, pca_flags=pca_flags,
            resize_mats=resize_mats, stage_codecs=stage_codecs, run_key=key,
            pass_idx=pass_idx, use_pallas=use_pallas, rotations=rotations,
            cov_prop=cov_prop, pad_mode=pad_mode, mesh=mesh)

    return fn
