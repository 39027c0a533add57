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


def encode_head(sc: StageCodec, rgb: torch.Tensor,
                pad: str = "reflect") -> torch.Tensor:
    """Post-renorm RGB (float32) -> relu{depth}_1 features, NHWC, in the
    conv dtype; every conv padded by ``pad`` (reflect | wrap).

    Kernel-covered encoder prefix (arch._ENCODER_FULL indices): [1] entry
    3->64, [2] conv1_2 + [3]'s pre-pool, [3] 64->128, [4] 128->128 + [5]'s
    pre-pool; F.conv2d from 256 channels on."""
    t = codec.rgb_to_relu1(rgb, sc.head[0], pad=pad)
    if sc.depth == 1:
        return t
    t = codec.conv3x3_p2(t, sc.head[1], relu=True, pool=True, pad=pad)
    t = codec.conv3x3_full(t, sc.head[2], relu=True, pad=pad)
    if sc.depth == 2:
        return t
    t = codec.conv3x3_full(t, sc.head[3], relu=True, pool=True, pad=pad)
    specs = arch.encoder_specs(sc.depth)[5:]
    # spec[5]'s pre-pool is fused into the 128->128 kernel above
    s0 = specs[0]
    specs = [(s0[0], s0[1], s0[2], "", s0[4])] + list(specs[1:])
    return _run_stack(sc.enc_rest, specs, t, pad)


def decode_tail(sc: StageCodec, feat: torch.Tensor,
                pad: str = "reflect") -> torch.Tensor:
    """relu{depth}_1 features (NHWC; the OT's float32, cast to the conv
    dtype here) -> RGB (NHWC, float32): post-renorm for the next stage, or
    raw pixels after the pass's last stage; every conv padded by ``pad``.

    Kernel-covered decoder suffix: [-4] 128->128 upconv, [-3] 128->64, [-2]
    64->64 upconv, [-1] final; F.conv2d above 128 channels."""
    x = feat.to(sc.dtype)
    if sc.depth > 2:
        x = _run_stack(sc.dec_rest, arch.decoder_specs(sc.depth)[:-4], x,
                       pad)
        x = codec.upconv_p2(x, sc.tail[0], pad=pad)
    if sc.depth > 1:
        x = codec.conv3x3_p2(x, sc.tail[-2], relu=True, pad=pad)
        x = codec.upconv_p2(x, sc.tail[-1], pad=pad)
    return codec.final_to_rgb(x, sc.final, pad=pad)
