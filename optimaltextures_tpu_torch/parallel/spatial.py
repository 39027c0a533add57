"""Spatial (H-axis) sharding: one image's rows split over the ranks of a
mesh (the counterpart of ``optimaltextures_tpu/parallel/spatial.py``).

Rank r of an n-rank space mesh holds row block r of the image, so every
part of a pass becomes a per-rank program with a few collectives:

* 3x3 convs take their neighbours' halo rows (``Mesh.halo_rows``): the
  image reflects at its global top and bottom, or wraps around the ring of
  ranks for tileable runs. On the GPU the stage roundtrips run on the codec
  kernels by exchange and crop (models/fastcodec.py); the 256-channel convs
  and the CPU reference codec run the F.conv2d halo stack here
  (:func:`run_stack_spatial`);
* 2x2 pools and upsamples never straddle a shard as long as every local H
  stays even at every depth: every pass's H must divide by
  ``n * 2^(depth-1)`` (:func:`check_spatial_divisibility`);
* the transport statistics are global: the per-image means AND the Gram
  matrices reduce over the mesh, cdf's range and counts too, and sort
  gathers the cloud (rank order is the image's row order).

The multires resize of a pass is no part of this: bicubic taps cross
shards, so the caller resizes the gathered image (core.Synthesizer).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import transport
from ..models import arch
from ..ops.convops import conv2d_nhwc, maxpool_2x2_ceil, upsample_nearest_2x


def own_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of ``x``'s rows (dim 1), in rank order; the height
    must divide by the mesh's size."""
    h = x.shape[1]
    if h % mesh.size:
        raise ValueError(f"H={h} does not split over {mesh.size} ranks")
    h //= mesh.size
    return x[:, mesh.rank * h:(mesh.rank + 1) * h].contiguous()


def _halo_pad_h(x: torch.Tensor, mesh, pad_mode: str = "reflect"
                ) -> torch.Tensor:
    """Pad this rank's rows by one row above and below: the neighbours'
    rows inside the image; at the image's top and bottom the reflection
    (exclude-edge, as ReflectionPad2d) under ``reflect``, the other end of
    the ring under ``wrap``. The JAX package's ``_halo_pad_h``."""
    top, bottom = mesh.halo_rows(x, 1, pad_mode)
    if top is None:
        top = x[:, 1:2]
    if bottom is None:
        bottom = x[:, -2:-1]
    return torch.cat([top, x, bottom], 1)


def _pad_w(x: torch.Tensor, pad_mode: str = "reflect") -> torch.Tensor:
    """One column each side, reflected or wrapped (the W axis is whole)."""
    if pad_mode == "reflect":
        left, right = x[:, :, 1:2], x[:, :, -2:-1]
    elif pad_mode == "wrap":
        left, right = x[:, :, -1:], x[:, :, :1]
    else:
        raise ValueError(f"pad mode must be reflect|wrap, got {pad_mode!r}")
    return torch.cat([left, x, right], 2)


def run_stack_spatial(params, specs, x: torch.Tensor, mesh,
                      pad_mode: str = "reflect") -> torch.Tensor:
    """The VGG conv stack on this rank's rows: the halo exchange in place of
    the local padding of H. Op for op ``models.vgg._run_stack``."""
    for (w, b), (_, _, k, pre, post) in zip(params, specs):
        if pre == "pool":
            x = maxpool_2x2_ceil(x)
        elif pre == "up":
            x = upsample_nearest_2x(x)
        if k == 3:
            x = _pad_w(_halo_pad_h(x, mesh, pad_mode), pad_mode)
        x = conv2d_nhwc(x, w, b)
        if post == "relu":
            x = torch.relu(x)
    return x


def encode_spatial(params, depth: int, img: torch.Tensor, mesh,
                   pad_mode: str = "reflect") -> torch.Tensor:
    return run_stack_spatial(params, arch.encoder_specs(depth), img, mesh,
                             pad_mode)


def decode_spatial(params, depth: int, feat: torch.Tensor, mesh,
                   pad_mode: str = "reflect") -> torch.Tensor:
    return run_stack_spatial(params, arch.decoder_specs(depth), feat, mesh,
                             pad_mode)


def spatial_transport_loop(gen, feature, style_mu, style_cov_raw,
                           n_iters: int, mode: str, *, mesh,
                           style_samples=None, content_feature=None,
                           content_strength: float = 0.0, k_mask=None,
                           cov_prop: Optional[bool] = None, rotations=None,
                           use_pallas: bool = True):
    """The OT loop on this rank's rows of the feature map: the means AND the
    Gram matrices reduce over the mesh (the image's exact moments), cdf's
    range and target counts too, sort matches the gathered cloud. The
    content pull is elementwise, so the content feature's rows apply
    locally. The JAX package's ``spatial_transport_loop``
    (``sharded_transport_loop_axes`` with the space axis as mean, Gram and
    sort axis): ``transport.transport_loop`` with ``mesh`` as both."""
    return transport.transport_loop(
        gen, feature, transport.StyleStats(style_mu, style_cov_raw,
                                           style_samples), n_iters, mode,
        content_feature=content_feature, content_strength=content_strength,
        rotations=rotations, use_pallas=use_pallas, k_mask=k_mask,
        cov_prop=cov_prop, mesh=mesh, mean_mesh=mesh)


def make_spatial_pass(mesh, *, depths, iters, mode: str, strengths,
                      pca_flags, axis: str = "space",
                      pad_mode: str = "reflect", cov_prop=None,
                      fast_codec: bool = False):
    """ALL of a pass's layer stages on this rank's rows of the image: per
    depth (deepest first) encode -> project -> the spatial OT loop ->
    unproject -> decode, as ``core._pass_stages_impl`` (which this runs,
    with the mesh as its Gram mesh and its space mesh). The spatial twin of
    ``shard_ot.make_sharded_pass``: the returned function takes the same
    arguments, the content features come as this rank's rows like the
    pastiche's, and ``resize_mats`` must be None (the caller resizes the
    gathered image). ``fast_codec`` runs the stage roundtrips on the codec
    kernels by exchange and crop (``stage_codecs`` packed once by the
    caller, or here per call); without it the F.conv2d halo stack (CPU
    only)."""
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's {mesh.axis!r}")
    return _rows_pass(mesh, mesh, depths=depths, iters=iters, mode=mode,
                      strengths=strengths, pca_flags=pca_flags,
                      pad_mode=pad_mode, cov_prop=cov_prop,
                      fast_codec=fast_codec)


def _rows_pass(mesh, space, *, depths, iters, mode: str, strengths,
               pca_flags, pad_mode: str, cov_prop, fast_codec: bool):
    """The pass of :func:`make_spatial_pass` with ``mesh`` as the Gram mesh
    and ``space`` as the halo and mean mesh (the grid's pass too)."""
    from .. import core
    from ..models import fastcodec

    cov_prop = True if cov_prop is None else cov_prop

    def fn(enc_list, dec_list, pastiche, mus, covs, samples, eigvecs,
           contents, key, k_masks, *, pass_idx: int = 0, stage_codecs=None,
           resize_mats=None, rotations=None, use_pallas: bool = True):
        if resize_mats is not None:
            raise ValueError("a pass on image rows resizes nothing: resize "
                             "the gathered image before it")
        if fast_codec and stage_codecs is None:
            stage_codecs = fastcodec.pack_stages(enc_list, dec_list, depths)
        elif not fast_codec:
            stage_codecs = None
        targets = [core.LayerTargets(transport.StyleStats(m, c, s), e, ct, k)
                   for m, c, s, e, ct, k in zip(mus, covs, samples, eigvecs,
                                                contents, k_masks)]
        return core._pass_stages_impl(
            enc_list, dec_list, pastiche, targets, depths=depths, iters=iters,
            mode=mode, strengths=strengths, pca_flags=pca_flags,
            stage_codecs=stage_codecs, run_key=key, pass_idx=pass_idx,
            use_pallas=use_pallas, rotations=rotations, cov_prop=cov_prop,
            pad_mode=pad_mode, mesh=mesh, space=space)

    return fn


def check_spatial_divisibility(h: int, n_devices: int, depth: int) -> None:
    need = n_devices * (2 ** (depth - 1))
    if h % need != 0:
        raise ValueError(
            f"H={h} must be divisible by n_devices*2^(depth-1)={need} for "
            f"spatial sharding at depth {depth}")
