"""The stage roundtrip's relu1/relu2-scale codec on the CUDA kernels.

The counterpart of ``optimaltextures_tpu/models/fastcodec.py``. Every OT stage
decodes the pastiche to pixels and re-encodes it for the next layer; the
convs at 64 and 128 channels of those roundtrips run on the kernels of
:mod:`..ops.codec`, the 256-channel ones on ``F.conv2d``:

  encode_head:  rgb_to_relu1 -> conv3x3_p2 (+ fused pool) -> conv3x3_full
                -> conv3x3_full (+ fused pool) -> F.conv2d stack
  decode_tail:  F.conv2d stack -> upconv_p2 -> conv3x3_p2 -> upconv_p2
                -> final_to_rgb (the NEXT stage's 1x1 RGB renorm folded in;
                identity for the pass's last decode)

Between stages the image lives as post-renorm RGB, NHWC float32 (the JAX
package pads it to 8 channels in a (H, W, C, 128) layout for the TPU's
lanes; here it stays (N, H, W, 3)). Each stage's kernel weights are packed
once per synthesizer (:func:`pack_stages`), in the bank's dtype: with
bfloat16 weights every conv here computes the bf16 function (the JAX
package's ``conv_dtype="bfloat16"``): the features are bf16, the RGB
between stages stays float32. ``pad="wrap"`` (tileable runs) pads every
conv here circularly: the kernels' wrap mode and circular ``F.conv2d``
padding.

Spatial sharding (``halo``: the space mesh, parallel/mesh.py) runs the
same kernels on a rank's rows of the image by exchange and crop
(:func:`exchanged`): the neighbours' halo rows are put above and below the
shard, the kernel runs on the taller tensor in its own pad mode, and the
output rows the halo produced are cropped. An output row whose 3x3 window
lies inside the taller tensor is the single-device row; the rows that met
the kernel's own edge padding are the cropped ones, except at the image's
global top and bottom under reflect padding, where no halo is added and the
kernel's reflection is the image's. The 256-channel convs take the
F.conv2d halo stack of parallel/spatial.py.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from ..ops import codec
from ..ops.convops import conv2d_nhwc
from . import arch
from .vgg import _run_stack


def eligible(fast_codec: bool, device) -> bool:
    """The port's gate: whether the stage roundtrips run on this module.

    The JAX gate (``optimaltextures_tpu/models/fastcodec.eligible``) sends a
    run to the Pallas kernels only at batch == 128, bfloat16, reflect
    padding and sizes that are multiples of 32: the TPU's lane width and
    tiling, and the Pallas kernels' one halo. The port's kernels take any
    batch, any size (reflect padding needs >= 2 px at every level, as on
    the F.conv2d path), either float32 or bfloat16 and either pad mode, so
    none of those conditions applies. On a GPU every roundtrip runs on the kernels,
    in the bank's dtype; ``fast_codec=False`` (the F.conv2d codec, the
    reference the CPU tests hold this module against) is for the CPU
    only."""
    if fast_codec:
        return True
    if torch.device(device).type != "cpu":
        raise ValueError("fast_codec=False runs the F.conv2d codec, a CPU "
                         "reference; on a GPU the stage codec runs on the "
                         "CUDA kernels")
    return False


class StageCodec(NamedTuple):
    """One stage's codec weights at relu{depth}_1, packed once, in the conv
    dtype (:attr:`dtype`)."""
    depth: int
    head: Tuple[codec.Packed, ...]   # encoder convs [1]..[4] (as the depth has)
    enc_rest: List                   # encoder (w, b) [5:], on F.conv2d
    dec_rest: List                   # decoder (w, b) [:-4], on F.conv2d
    tail: Tuple[codec.Packed, ...]   # decoder convs [-4]..[-2] (as the depth has)
    final: codec.Packed              # decoder [-1], next renorm folded in

    @property
    def dtype(self) -> torch.dtype:
        return self.final.w.dtype


def pack_stage(enc_params, dec_params, depth: int,
               renorm_params=None) -> StageCodec:
    """``renorm_params``: the NEXT stage's encoder 1x1 renorm (w, b) to fold
    into the decoder-final conv, or None for the pass's last decode (raw
    pixels). The tail's upconvs get their folded taps (``codec.pack_up``)."""
    split = max(len(dec_params) - 4, 0)
    tail_specs = arch.decoder_specs(depth)[split:-1]
    return StageCodec(
        depth, tuple(codec.pack(*p) for p in enc_params[1:5]),
        list(enc_params[5:]), list(dec_params[:split]),
        tuple((codec.pack_up if s[3] == "up" else codec.pack)(*p)
              for s, p in zip(tail_specs, dec_params[split:-1])),
        codec.pack_final(*dec_params[-1], renorm_params))


def pack_stages(enc_params, dec_params, depths) -> List[StageCodec]:
    """A pass's stages (deepest first): stage i folds stage i+1's renorm
    into its final conv; the last stage's final conv stays as it is."""
    return [pack_stage(enc_params[i], dec_params[i], d,
                       enc_params[i + 1][0] if i + 1 < len(depths) else None)
            for i, d in enumerate(depths)]


def pixels_to_rgb(renorm_params, pastiche: torch.Tensor) -> torch.Tensor:
    """NHWC pixels (conv dtype) -> post-renorm RGB, float32: the encoder's
    1x1 renorm conv, applied once per pass (decode_tail folds the later ones
    into the final conv), in the conv dtype, then widened (JAX's
    ``pixels_to_rgb8``)."""
    w0, b0 = renorm_params
    return conv2d_nhwc(pastiche, w0, b0).float()


def exchanged(kernel, x: torch.Tensor, p, halo=None, pad: str = "reflect",
              **kw) -> torch.Tensor:
    """``kernel(x, p, pad=pad, **kw)`` (a wrapper of :mod:`..ops.codec`) on
    this rank's rows ``x`` of an image sharded along H over ``halo`` (a
    parallel.mesh.Mesh; None: ``x`` is the whole image): exchange, run the
    kernel on the taller tensor, crop. The halo is 2 rows for a pooled conv
    (its row pairs stay aligned with the shard, whose height is even, and 1
    pooled row is cropped a side), 1 coarse row for the upconv (2 fine rows
    cropped) and 1 row otherwise; under reflect the image's own top and
    bottom take none (:meth:`~..parallel.mesh.Mesh.halo_rows`)."""
    if halo is None:
        return kernel(x, p, pad=pad, **kw)
    up = kernel is codec.upconv_p2
    pool = kw.get("pool", False)
    xt, top, bottom = halo.halo_pad(x, 2 if pool else 1, pad)
    y = kernel(xt, p, pad=pad, **kw)
    if pool:
        top, bottom = top // 2, bottom // 2
    elif up:
        top, bottom = 2 * top, 2 * bottom
    # a batch-1 crop along H is a contiguous view; a batch's is not
    return y[:, top:y.shape[1] - bottom].contiguous()


def _rest_stack(params, specs, x, pad, halo):
    """The 256-channel F.conv2d convs: local, or the halo stack of
    parallel/spatial.py on a shard."""
    if halo is None:
        return _run_stack(params, specs, x, pad)
    from ..parallel.spatial import run_stack_spatial

    return run_stack_spatial(params, specs, x, halo, pad)


def encode_head(sc: StageCodec, rgb: torch.Tensor,
                pad: str = "reflect", halo=None) -> torch.Tensor:
    """Post-renorm RGB (float32) -> relu{depth}_1 features, NHWC, in the
    conv dtype; every conv padded by ``pad`` (reflect | wrap). ``halo``:
    the space mesh when ``rgb`` is this rank's rows of the image
    (:func:`exchanged`).

    Kernel-covered encoder prefix (arch._ENCODER_FULL indices): [1] entry
    3->64, [2] conv1_2 + [3]'s pre-pool, [3] 64->128, [4] 128->128 + [5]'s
    pre-pool; F.conv2d from 256 channels on."""
    t = exchanged(codec.rgb_to_relu1, rgb, sc.head[0], halo, pad)
    if sc.depth == 1:
        return t
    t = exchanged(codec.conv3x3_p2, t, sc.head[1], halo, pad, relu=True,
                  pool=True)
    t = exchanged(codec.conv3x3_full, t, sc.head[2], halo, pad, relu=True)
    if sc.depth == 2:
        return t
    t = exchanged(codec.conv3x3_full, t, sc.head[3], halo, pad, relu=True,
                  pool=True)
    specs = arch.encoder_specs(sc.depth)[5:]
    # spec[5]'s pre-pool is fused into the 128->128 kernel above
    s0 = specs[0]
    specs = [(s0[0], s0[1], s0[2], "", s0[4])] + list(specs[1:])
    return _rest_stack(sc.enc_rest, specs, t, pad, halo)


def decode_tail(sc: StageCodec, feat: torch.Tensor,
                pad: str = "reflect", halo=None) -> torch.Tensor:
    """relu{depth}_1 features (NHWC; the OT's float32, cast to the conv
    dtype here) -> RGB (NHWC, float32): post-renorm for the next stage, or
    raw pixels after the pass's last stage; every conv padded by ``pad``.
    ``halo``: as for :func:`encode_head`.

    Kernel-covered decoder suffix: [-4] 128->128 upconv, [-3] 128->64, [-2]
    64->64 upconv, [-1] final; F.conv2d above 128 channels."""
    x = feat.to(sc.dtype)
    if sc.depth > 2:
        x = _rest_stack(sc.dec_rest, arch.decoder_specs(sc.depth)[:-4], x,
                        pad, halo)
        x = exchanged(codec.upconv_p2, x, sc.tail[0], halo, pad)
    if sc.depth > 1:
        x = exchanged(codec.conv3x3_p2, x, sc.tail[-2], halo, pad, relu=True)
        x = exchanged(codec.upconv_p2, x, sc.tail[-1], halo, pad)
    return exchanged(codec.final_to_rgb, x, sc.final, halo, pad)
