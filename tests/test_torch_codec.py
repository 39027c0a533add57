"""The torch port's codec against the JAX package: each CUDA kernel's plain
version vs its Pallas kernel in interpret mode (tests/test_pallas_codec.py
shapes: B=128, 32x32, f32, tol 2e-5), the channel/pool variants vs the JAX
XLA ops at batch 2, the VGG stacks and encode_head/decode_tail vs JAX
encode/decode on the real depth-3 weights at 64 px (2e-4, as
tests/test_fastcodec.py). The kernels themselves run only on a GPU:
tests/test_torch_cuda.py holds them against these plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimaltextures_tpu.models import fastcodec as jfast
from optimaltextures_tpu.models import vgg as jvgg
from optimaltextures_tpu.ops.convops import (conv2d_nhwc, maxpool_2x2_ceil,
                                             reflect_pad, upsample_nearest_2x)
from optimaltextures_tpu.ops.pallas import codec as jcodec
from optimaltextures_tpu_torch.models import fastcodec as tfast
from optimaltextures_tpu_torch.models import vgg as tvgg
from optimaltextures_tpu_torch.ops import codec

B, H, W = 128, 32, 32
TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _oihw(w_hwio):
    return _t(np.asarray(w_hwio).transpose(3, 2, 0, 1))


def _pack(w_hwio, b):
    return codec.pack(_oihw(w_hwio), _t(b))


def _err(got, ref):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(ref))))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    n = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return {
        "x": n(B, H, W, 64), "xc": n(B, H // 2, W // 2, 64),
        "rgb": n(B, H, W, 3),
        "w": n(3, 3, 64, 64, sc=0.1), "b": n(64, sc=0.1),
        "wf": n(3, 3, 64, 3, sc=0.1), "bf": n(3, sc=0.1),
        "wrn": n(1, 1, 3, 3, sc=0.5), "brn": n(3, sc=0.1),
        "we": n(3, 3, 3, 64, sc=0.1), "be": n(64, sc=0.1),
        "w128": n(3, 3, 64, 128, sc=0.1), "b128": n(128, sc=0.1),
    }


# --- plain versions vs the Pallas kernels (interpret mode) -------------------

def test_conv3x3_p2_vs_pallas(data):
    wr, b2 = jcodec.pack_conv_p2(data["w"], data["b"])
    ref = jcodec.tcb_to_nhwc(jcodec.conv3x3_p2(
        jcodec.nhwc_to_tcb(jnp.asarray(data["x"])), wr, b2, relu=True,
        interpret=True))
    got = codec.conv3x3_p2(_t(data["x"]), _pack(data["w"], data["b"]),
                           relu=True)
    assert _err(got, ref) < TOL


def test_conv3x3_full_vs_pallas(data):
    wr, bb = jcodec.pack_conv_full(data["w128"], data["b128"])
    ref = jcodec.tcb_to_nhwc(jcodec.conv3x3_full(
        jcodec.nhwc_to_tcb(jnp.asarray(data["x"])), wr, bb, relu=True,
        pool=True, interpret=True))
    got = codec.conv3x3_full(_t(data["x"]), _pack(data["w128"], data["b128"]),
                             relu=True, pool=True)
    assert got.shape == (B, H // 2, W // 2, 128)
    assert _err(got, ref) < TOL


def test_upconv_p2_vs_pallas(data):
    wa0, wa1, bu = jcodec.pack_upconv_fold(data["w"], data["b"])
    ref = jcodec.tcb_to_nhwc(jcodec.upconv_p2(
        jcodec.nhwc_to_tcb(jnp.asarray(data["xc"])), wa0, wa1, bu,
        interpret=True))
    got = codec.upconv_p2(_t(data["xc"]), _pack(data["w"], data["b"]))
    assert got.shape == (B, H, W, 64)
    assert _err(got, ref) < TOL


def test_final_to_rgb_vs_pallas(data):
    w3, b3 = jcodec.pack_final_rgb(data["wf"], data["bf"], data["wrn"],
                                   data["brn"])
    ref = jcodec.tcb_to_nhwc(jcodec.final_to_rgb(
        jcodec.nhwc_to_tcb(jnp.asarray(data["x"])), w3, b3,
        interpret=True))[..., :3]
    p = codec.pack_final(_oihw(data["wf"]), _t(data["bf"]),
                         (_oihw(data["wrn"]), _t(data["brn"])))
    got = codec.final_to_rgb(_t(data["x"]), p)
    assert got.shape == (B, H, W, 3)
    assert _err(got, ref) < TOL


def test_rgb_to_relu1_vs_pallas(data):
    rgb8 = jnp.pad(jnp.asarray(data["rgb"]), ((0, 0),) * 3 + ((0, 5),))
    we, be = jcodec.pack_entry_rgb(data["we"], data["be"])
    ref = jcodec.tcb_to_nhwc(jcodec.rgb_to_relu1(
        jcodec.nhwc_to_tcb(rgb8), we, be, out_dtype=jnp.float32,
        interpret=True))
    got = codec.rgb_to_relu1(_t(data["rgb"]), _pack(data["we"], data["be"]))
    assert _err(got, ref) < TOL


# --- variants vs the JAX XLA ops at batch 2 ----------------------------------

def _xla_conv(x, w, b, relu, pool, up=False):
    x = jnp.asarray(x)
    if up:
        x = upsample_nearest_2x(x)
    y = conv2d_nhwc(reflect_pad(x), jnp.asarray(w), jnp.asarray(b))
    if relu:
        y = jax.nn.relu(y)
    if pool:
        y = maxpool_2x2_ceil(y)
    return np.asarray(y)


@pytest.mark.parametrize("fn,cin,cout,relu,pool", [
    ("conv3x3_p2", 128, 64, True, False), ("conv3x3_p2", 64, 64, True, True),
    ("conv3x3_p2", 128, 64, False, True), ("conv3x3_p2", 64, 64, False, False),
    ("conv3x3_full", 64, 128, True, False), ("conv3x3_full", 128, 128, True, True),
    ("conv3x3_full", 128, 128, False, False)])
def test_conv_variants_vs_xla(fn, cin, cout, relu, pool):
    rng = np.random.default_rng(cin + cout + 2 * relu + pool)
    x = rng.standard_normal((2, 24, 40, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    got = getattr(codec, fn)(_t(x), _pack(w, b), relu=relu, pool=pool)
    assert _err(got, _xla_conv(x, w, b, relu, pool)) < TOL


@pytest.mark.parametrize("fn,cin,cout", [("conv3x3_p2", 64, 64),
                                         ("conv3x3_full", 128, 128)])
def test_pooled_variants_at_odd_sizes_vs_xla(fn, cin, cout):
    """The fused pool is ceil mode, as the VGG stack's: an odd H or W keeps
    its last row or column as a window of its own."""
    rng = np.random.default_rng(cin + cout)
    x = rng.standard_normal((1, 13, 22, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    got = getattr(codec, fn)(_t(x), _pack(w, b), relu=True, pool=True)
    assert got.shape == (1, 7, 11, cout)
    assert _err(got, _xla_conv(x, w, b, True, True)) < TOL


@pytest.mark.parametrize("c", [64, 128])
def test_upconv_variants_vs_xla(c):
    rng = np.random.default_rng(c)
    x = rng.standard_normal((2, 12, 20, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    got = codec.upconv_p2(_t(x), _pack(w, b))
    assert got.shape == (2, 24, 40, c)
    assert _err(got, _xla_conv(x, w, b, True, False, up=True)) < TOL


def test_final_without_renorm_vs_xla():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 64)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 64, 3)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(3) * 0.1).astype(np.float32)
    got = codec.final_to_rgb(_t(x), codec.pack_final(_oihw(w), _t(b)))
    assert _err(got, _xla_conv(x, w, b, False, False)) < TOL


def test_wrappers_reject_bad_operands():
    x = torch.zeros(1, 8, 8, 32)
    with pytest.raises(ValueError):
        codec.conv3x3_p2(x, codec.pack(torch.zeros(64, 32, 3, 3), torch.zeros(64)))
    with pytest.raises(ValueError):
        codec.final_to_rgb(torch.zeros(1, 8, 8, 64),
                           codec.pack(torch.zeros(4, 64, 3, 3), torch.zeros(4)))
    with pytest.raises(ValueError):
        codec.rgb_to_relu1(torch.zeros(1, 1, 8, 3),
                           codec.pack(torch.zeros(64, 3, 3, 3), torch.zeros(64)))
    with pytest.raises(ValueError):
        codec.upconv_p2(torch.zeros(1, 8, 8, 64),
                        codec.pack(torch.zeros(128, 64, 3, 3), torch.zeros(128)))


def test_plain_versions_do_not_count_launches():
    codec.reset_launches()
    x = torch.rand(1, 8, 8, 3)
    codec.rgb_to_relu1(x, codec.pack(torch.rand(64, 3, 3, 3), torch.rand(64)))
    assert all(v == 0 for v in codec.LAUNCHES.values())


# --- the VGG stacks and the fast codec on the real depth-3 weights -----------

@pytest.fixture(scope="module")
def banks():
    return jvgg.VGGBank(3), tvgg.VGGBank(3, device="cpu")


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(11).uniform(size=(1, 64, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_vgg_encode_decode_vs_jax(banks, pixels, depth):
    jb, tb = banks
    ref = np.asarray(jvgg.encode(jb.enc_params[depth], depth, jnp.asarray(pixels)))
    got = tvgg.encode(tb.enc_params[depth], depth, _t(pixels)).numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    assert _err(got, ref) < 1e-6 * scale + 1e-4
    back_ref = np.asarray(jvgg.decode(jb.dec_params[depth], depth, jnp.asarray(ref)))
    back = tvgg.decode(tb.dec_params[depth], depth, _t(ref)).numpy()
    assert _err(back, back_ref) < 1e-4
    taps_ref = jvgg.encode_taps(jb.enc_params[depth], depth, jnp.asarray(pixels))
    taps = tvgg.encode_taps(tb.enc_params[depth], depth, _t(pixels))
    for a, b in zip(taps, taps_ref):
        assert _err(a.numpy(), b) < 1e-6 * scale + 1e-4


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_encode_head_decode_tail_vs_jax(banks, pixels, depth):
    """The port's kernel-covered codec (plain versions on the CPU) vs JAX
    vgg.encode/decode; renorm folding checked against decode -> 1x1 renorm."""
    jb, tb = banks
    enc_j, dec_j = jb.enc_params[depth], jb.dec_params[depth]
    ref_feat = np.asarray(jvgg.encode(enc_j, depth, jnp.asarray(pixels)))
    sc = tfast.pack_stage(tb.enc_params[depth], tb.dec_params[depth], depth)
    rgb = tfast.pixels_to_rgb(tb.enc_params[depth][0], _t(pixels))
    feat = tfast.encode_head(sc, rgb).numpy()
    scale = max(1.0, float(np.abs(ref_feat).max()))
    assert _err(feat, ref_feat) < 2e-4 * scale

    ref_px = np.asarray(jvgg.decode(dec_j, depth, jnp.asarray(ref_feat)))
    got_px = tfast.decode_tail(sc, _t(ref_feat)).numpy()
    assert _err(got_px, ref_px) < 2e-4

    # the next stage's renorm folded into the final conv (the JAX path
    # folds it the same way: fastcodec.decode_tail + pack_final_rgb)
    rn = jb.enc_params[max(depth - 1, 1)][0]
    ref_rn = np.asarray(conv2d_nhwc(jnp.asarray(ref_px), *rn))
    sc_rn = tfast.pack_stage(tb.enc_params[depth], tb.dec_params[depth], depth,
                             tb.enc_params[max(depth - 1, 1)][0])
    got_rn = tfast.decode_tail(sc_rn, _t(ref_feat)).numpy()
    assert _err(got_rn, ref_rn) < 2e-4 * max(1.0, float(np.abs(ref_rn).max()))


def test_eligibility_gate():
    """The port's gate has no batch, dtype or size condition: the codec
    runs unless fast_codec is off, which only the CPU allows."""
    assert tfast.eligible(True, "cpu")
    assert tfast.eligible(True, torch.device("cuda"))
    assert not tfast.eligible(False, "cpu")
    with pytest.raises(ValueError):
        tfast.eligible(False, torch.device("cuda"))
    # the JAX gate refuses batch != 128 and sizes off the 32 grid
    assert not jfast.eligible(1, [(512, 512)], "reflect", jnp.bfloat16)
    assert not jfast.eligible(128, [(500, 500)], "reflect", jnp.bfloat16)
    # ... which the port's codec takes (odd sizes at the pooled levels)
    sc = tfast.pack_stages(*_tiny_bank(3), [3, 2, 1])[0]
    feat = tfast.encode_head(sc, torch.rand(1, 50, 46, 3))
    assert feat.shape == (1, 13, 12, 256)
    assert tfast.decode_tail(sc, feat).shape == (1, 52, 48, 3)


def _tiny_bank(depth):
    bank = tvgg.synthetic_bank(depth)
    order = range(depth, 0, -1)
    return ([bank.enc_params[d] for d in order],
            [bank.dec_params[d] for d in order])
