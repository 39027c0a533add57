"""The bf16 function of the codec (``conv_dtype="bfloat16"``, the function
the Pallas kernels compute on the TPU) against the JAX package, on the CPU.

* The bf16 plain versions of kernels 1-5 against the Pallas kernels in
  interpret mode with bf16 inputs, at B = 128 and 32 x 32, as
  tests/test_torch_codec.py does in f32. Bound: 2^-7 x max|ref|, one bf16
  rounding (both sides sum in f32 in their own order and round once, so an
  output a rounding apart flips by one bf16 ulp, 2^-8 of its value).
* The bf16 packings against JAX's ``pack_*`` on bf16 weights: the folded
  upconv taps bit-equal; the final conv's folded renorm within one bf16
  ulp (both round the einsum's f32 sum once; XLA's CPU dot and torch's
  may sum the three terms in another order); the biases widen exactly.
* The bf16 kernels' weight images (``pack_wg``, ``pack_wg_up``) are read
  back, and the kernel modelled, in tests/test_torch_wg.py.
* ``vgg.encode`` / ``decode`` in bf16 against JAX's XLA bf16 encode and
  decode: every conv rounds twice (the conv's output, then ``y + b``), as
  JAX's ``conv2d_nhwc`` does. Bound 2^-7 x max|ref|.
* ``encode_head`` / ``decode_tail`` in bf16 against JAX's fastcodec in
  interpret mode at B = 128, 32 px, depth 2. Bound 2^-6 x max|ref|: three
  chained bf16 convs, each of which can flip an output by one ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from optimaltextures_tpu.models import fastcodec as jfast
from optimaltextures_tpu.models import vgg as jvgg
from optimaltextures_tpu.ops.pallas import codec as jcodec
from optimaltextures_tpu_torch.models import fastcodec as tfast
from optimaltextures_tpu_torch.models import vgg as tvgg
from optimaltextures_tpu_torch.models import weights as tweights
from optimaltextures_tpu_torch.ops import codec

B, H, W = 128, 32, 32
BF = torch.bfloat16
ONE_ROUNDING = 2.0 ** -7


def _bf(a):
    """numpy f32 -> torch bf16 (rounded to nearest even)."""
    return torch.from_numpy(np.array(a, np.float32)).to(BF)


def _jbf(a):
    return jnp.asarray(np.array(a, np.float32), jnp.bfloat16)


def _oihw(w_hwio):
    return _bf(np.asarray(w_hwio, np.float32).transpose(3, 2, 0, 1))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _hold(got, ref, bound=ONE_ROUNDING):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= bound * scale, (err, scale)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
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


def _pack(w_hwio, b):
    return codec.pack(_oihw(w_hwio), _bf(b))


# --- bf16 plain versions vs the Pallas kernels (interpret mode) -------------

def test_conv3x3_p2_bf16_vs_pallas(data):
    wr, b2 = jcodec.pack_conv_p2(_jbf(data["w"]), _jbf(data["b"]))
    ref = jcodec.tcb_to_nhwc(jcodec.conv3x3_p2(
        jcodec.nhwc_to_tcb(_jbf(data["x"])), wr, b2, relu=True, pool=True,
        interpret=True))
    got = codec.conv3x3_p2(_bf(data["x"]), _pack(data["w"], data["b"]),
                           relu=True, pool=True)
    assert got.dtype == BF and ref.dtype == jnp.bfloat16
    assert got.shape == (B, H // 2, W // 2, 64)
    _hold(got, ref)


def test_conv3x3_full_bf16_vs_pallas(data):
    wr, bb = jcodec.pack_conv_full(_jbf(data["w128"]), _jbf(data["b128"]))
    ref = jcodec.tcb_to_nhwc(jcodec.conv3x3_full(
        jcodec.nhwc_to_tcb(_jbf(data["x"])), wr, bb, relu=True,
        interpret=True))
    got = codec.conv3x3_full(_bf(data["x"]), _pack(data["w128"], data["b128"]),
                             relu=True)
    assert got.dtype == BF and got.shape == (B, H, W, 128)
    _hold(got, ref)


def test_upconv_p2_bf16_vs_pallas(data):
    wa0, wa1, bu = jcodec.pack_upconv_fold(_jbf(data["w"]), _jbf(data["b"]))
    ref = jcodec.tcb_to_nhwc(jcodec.upconv_p2(
        jcodec.nhwc_to_tcb(_jbf(data["xc"])), wa0, wa1, bu, interpret=True))
    got = codec.upconv_p2(_bf(data["xc"]),
                          codec.pack_up(_oihw(data["w"]), _bf(data["b"])))
    assert got.dtype == BF and got.shape == (B, H, W, 64)
    _hold(got, ref)


def test_final_to_rgb_bf16_vs_pallas(data):
    w3, b3 = jcodec.pack_final_rgb(_jbf(data["wf"]), _jbf(data["bf"]),
                                   _jbf(data["wrn"]), _jbf(data["brn"]))
    ref = jcodec.tcb_to_nhwc(jcodec.final_to_rgb(
        jcodec.nhwc_to_tcb(_jbf(data["x"])), w3, b3, interpret=True))[..., :3]
    p = codec.pack_final(_oihw(data["wf"]), _bf(data["bf"]),
                         (_oihw(data["wrn"]), _bf(data["brn"])))
    got = codec.final_to_rgb(_bf(data["x"]), p)
    # bf16 features in, f32 RGB out
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    assert got.shape == (B, H, W, 3)
    _hold(got, ref)


def test_rgb_to_relu1_bf16_vs_pallas(data):
    """f32 RGB in, rounded to bf16 before it multiplies (``p0.astype(dt)``
    in the Pallas kernel), bf16 features out."""
    rgb8 = jnp.pad(jnp.asarray(data["rgb"]), ((0, 0),) * 3 + ((0, 5),))
    we, be = jcodec.pack_entry_rgb(_jbf(data["we"]), _jbf(data["be"]))
    ref = jcodec.tcb_to_nhwc(jcodec.rgb_to_relu1(
        jcodec.nhwc_to_tcb(rgb8), we, be, out_dtype=jnp.bfloat16,
        interpret=True))
    x = torch.from_numpy(data["rgb"])
    got = codec.rgb_to_relu1(x, _pack(data["we"], data["be"]))
    assert got.dtype == BF and ref.dtype == jnp.bfloat16
    _hold(got, ref)
    # the input's rounding matters: the same sums on the unrounded f32 RGB
    # round to other bf16 values
    p = _pack(data["we"], data["be"])
    t = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect"),
                 p.w.float(), p.b)
    assert not torch.equal(torch.relu(t).permute(0, 2, 3, 1).to(BF), got)


# --- packings ---------------------------------------------------------------

@pytest.mark.parametrize("c", [64, 128])
def test_bf16_fold_is_jax_pack_upconv_fold(c):
    """fold_up in bf16 rounds each sum to bf16 in JAX's order (rows, then
    columns): bit-equal to pack_upconv_fold's blocks on bf16 weights. The
    bias widens to f32 exactly, as pack_upconv_fold's does."""
    rng = np.random.default_rng(c)
    w_hwio = rng.normal(0, 0.1, (3, 3, c, c)).astype(np.float32)
    b = rng.normal(0, 0.1, c).astype(np.float32)
    wa0, wa1, bu = jcodec.pack_upconv_fold(_jbf(w_hwio), _jbf(b))
    assert wa0.dtype == jnp.bfloat16
    wa = (_f32(wa0), _f32(wa1))
    p = codec.pack_up(_oihw(w_hwio), _bf(b))
    fold = p.w_fold
    assert fold.dtype == BF and fold.shape == (2, 2, 2, 2, c, c)
    for a in range(2):
        for ph in range(2):
            for u in range(2):
                for v in range(2):
                    slot = ph + v
                    block = wa[a][u, ph * c:(ph + 1) * c, slot * c:(slot + 1) * c]
                    np.testing.assert_array_equal(_f32(fold[a, ph, u, v]), block.T)
    # the rounding is real: summed in f32 the taps differ
    f32_fold = codec.fold_up(_oihw(w_hwio).float().permute(2, 3, 1, 0))
    assert not torch.equal(f32_fold, fold.float())
    assert p.b.dtype == torch.float32
    np.testing.assert_array_equal(p.b.numpy(), _f32(bu)[:c, 0])


def test_bf16_final_fold_is_jax_pack_final_rgb():
    """pack_final in bf16 against pack_final_rgb on bf16 weights: the folded
    weights within one bf16 ulp (the einsum's three products summed in f32
    and rounded once on both sides, in another order: 0 here, but XLA's CPU
    dot may order them otherwise), the bias ``b_renorm + b_fin @ rn`` (a
    rounded dot, then a rounded add) likewise, widened to f32."""
    rng = np.random.default_rng(3)
    wf = rng.normal(0, 0.1, (3, 3, 64, 3)).astype(np.float32)
    bf = rng.normal(0, 0.1, 3).astype(np.float32)
    wrn = rng.normal(0, 0.5, (1, 1, 3, 3)).astype(np.float32)
    brn = rng.normal(0, 0.1, 3).astype(np.float32)
    w3, b3 = jcodec.pack_final_rgb(_jbf(wf), _jbf(bf), _jbf(wrn), _jbf(brn))
    w3 = _f32(w3)
    p = codec.pack_final(_oihw(wf), _bf(bf), (_oihw(wrn), _bf(brn)))
    assert p.w.dtype == BF and p.b.dtype == torch.float32
    # w3[r, px * 8 + co, c * 64 + ci] = wf_folded[r, c - px, ci, co]: px = 0
    ref = np.stack([w3[:, co, :3 * 64].reshape(3, 3, 64) for co in range(3)])
    got = _f32(p.w).transpose(0, 2, 3, 1)              # (co, r, c, ci)
    ulp = np.abs(ref) * 2.0 ** -7
    assert np.all(np.abs(got - ref) <= ulp)
    np.testing.assert_allclose(p.b.numpy(), _f32(b3)[:3, 0],
                               rtol=2.0 ** -7, atol=0)
    # the bias is the bf16 value, widened
    assert torch.equal(p.b.to(BF).float(), p.b)


def test_bf16_biases_widen_exactly():
    b = _bf(np.random.default_rng(1).normal(0, 1, 64))
    w = _bf(np.random.default_rng(2).normal(0, 0.1, (64, 64, 3, 3)))
    for p in (codec.pack(w, b), codec.pack_up(w, b)):
        assert p.b.dtype == torch.float32 and torch.equal(p.b, b.float())
        assert p.w_hwio.dtype == torch.float32
        assert torch.equal(p.w_hwio, w.float().permute(2, 3, 1, 0))


# --- the VGG stacks and the stage codec -------------------------------------

@pytest.fixture(scope="module")
def banks():
    jb = jvgg.VGGBank(3, dtype=jnp.bfloat16)
    tb = tweights.params_from_numpy(jb.enc_params, jb.dec_params).to("cpu", BF)
    return jb, tb


def test_bf16_bank_rounds_weights_and_biases(banks):
    jb, tb = banks
    assert tb.dtype == BF
    f32 = tvgg.VGGBank(3)
    for d in (1, 3):
        for (wj, bj), (wt, bt), (w32, b32) in zip(
                jb.enc_params[d], tb.enc_params[d], f32.enc_params[d]):
            assert wt.dtype == bt.dtype == BF
            np.testing.assert_array_equal(_f32(wt), _f32(wj).transpose(3, 2, 0, 1))
            np.testing.assert_array_equal(_f32(bt), _f32(bj))
            assert torch.equal(w32.to(BF), wt) and torch.equal(b32.to(BF), bt)
    assert tvgg.VGGBank(2, dtype=BF).dtype == BF


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_bf16_encode_decode_match_jax(banks, depth):
    jb, tb = banks
    rng = np.random.default_rng(depth)
    img = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    ref = jvgg.encode(jb.enc_params[depth], depth, _jbf(img))
    got = tvgg.encode(tb.enc_params[depth], depth, _bf(img))
    assert got.dtype == BF and ref.dtype == jnp.bfloat16
    _hold(got, ref)
    feat = (rng.uniform(size=got.shape) * float(got.float().abs().max()) / 2
            ).astype(np.float32)
    ref = jvgg.decode(jb.dec_params[depth], depth, _jbf(feat))
    got = tvgg.decode(tb.dec_params[depth], depth, _bf(feat))
    assert got.dtype == BF
    _hold(got, ref)


def test_bf16_conv_rounds_twice_as_jax():
    """The bias add is its own bf16 op: one rounding of conv + bias would
    differ from JAX's on some outputs; the port's two match it."""
    from optimaltextures_tpu.ops import convops as jconv
    from optimaltextures_tpu_torch.ops import convops as tconv

    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 12, 12, 16)).astype(np.float32)
    w = rng.normal(0, 0.3, (3, 3, 16, 32)).astype(np.float32)
    b = rng.normal(0, 3, 32).astype(np.float32)
    ref = _f32(jconv.conv2d_nhwc(_jbf(x), _jbf(w), _jbf(b)))
    got = tconv.conv2d_nhwc(_bf(x), _oihw(w), _bf(b))
    assert got.dtype == BF
    fused = F.conv2d(_bf(x).float().permute(0, 3, 1, 2),
                                       _oihw(w).float(), _bf(b).float()
                                       ).permute(0, 2, 3, 1).to(BF)
    mismatch = lambda t: float(np.mean(_f32(t) != ref))
    assert mismatch(got) < 0.5 * mismatch(fused)
    _hold(got, ref)


@pytest.fixture(scope="module")
def stage_io(banks):
    """A depth-2 stage roundtrip at B = 128, 32 px, through JAX's fastcodec
    (interpret-mode Pallas kernels, bf16) and the port's (plain versions,
    bf16), from the same pixels."""
    jb, tb = banks
    d = 2
    px = np.random.default_rng(9).uniform(size=(B, 32, 32, 3)).astype(np.float32)
    renorm_next = jb.enc_params[1][0]
    rgb8 = jfast.pixels_to_rgb8(jb.enc_params[d][0], _jbf(px))
    jfeat = jfast.encode_head(jb.enc_params[d], d, rgb8, jnp.bfloat16)
    feat = np.asarray(jnp.asarray(jfeat, jnp.float32))
    jrgb = jfast.rgb8_to_pixels(jfast.decode_tail(
        jb.dec_params[d], d, jnp.asarray(feat), renorm_next, jnp.bfloat16),
        jnp.float32)
    sc = tfast.pack_stage(tb.enc_params[d], tb.dec_params[d], d,
                          tb.enc_params[1][0])
    rgb = tfast.pixels_to_rgb(tb.enc_params[d][0], _bf(px))
    return dict(jrgb8=rgb8, jfeat=jfeat, jout=jrgb, feat=feat, sc=sc, rgb=rgb)


def test_bf16_pixels_to_rgb_matches_jax(stage_io):
    ref = jfast.rgb8_to_pixels(stage_io["jrgb8"], jnp.float32)
    assert stage_io["rgb"].dtype == torch.float32
    _hold(stage_io["rgb"], ref)


def test_bf16_encode_head_matches_jax_fastcodec(stage_io):
    got = tfast.encode_head(stage_io["sc"], stage_io["rgb"])
    assert got.dtype == BF and got.shape == (B, 16, 16, 128)
    _hold(got, stage_io["jfeat"], 2.0 ** -6)


def test_bf16_decode_tail_matches_jax_fastcodec(stage_io):
    got = tfast.decode_tail(stage_io["sc"], torch.from_numpy(stage_io["feat"]))
    assert got.dtype == torch.float32 and got.shape == (B, 32, 32, 3)
    _hold(got, stage_io["jout"], 2.0 ** -6)
