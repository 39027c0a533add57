"""Tileable output (``tileable=True``) in the torch port against the JAX
package, on the CPU.

Under tileable the convs on the pastiche pad circularly and its pass
resizes wrap their taps, so a run commutes with circular shifts and its
output tiles without a seam; style and content prep keep reflect taps.
Here, at 32-64 px, depth <= 3 and few iterations, with inputs from numpy
seeds, ``weights/*.npz`` and ``docs/samples/*.png``:

* the circular resize matrices and resizes equal JAX's;
* ``vgg.encode`` / ``decode`` in wrap mode equal JAX's (1e-5);
* each codec kernel's plain version in wrap mode, f32 and bf16, equals
  JAX's XLA conv on ``pad_spatial(..., "wrap")`` within the reflect case's
  bounds (2e-5; 2^-7 x max|ref| in bf16); the folded upconv taps on the
  circularly padded coarse image equal the fine-scale circular conv; the
  wrap repair of ``final_to_rgb``'s edge tiles, emulated, builds the
  circular halo;
* ``encode_head`` / ``decode_tail`` in wrap mode equal JAX's encode /
  decode in wrap mode;
* a tileable ``Synthesizer.run`` equals JAX's (``fast_codec=False``, the
  rotation stream injected) within 5e-4, without and with multires;
* a tileable run's style and content prep equal a reflect run's;
* the pass-size check raises where JAX's does, with its message;
* the port's run is shift-equivariant on the torus (JAX's bounds) and the
  reflect run is not;
* the CLI's ``--tileable`` writes JAX's file name; a served tileable
  request returns 200.
"""

import base64
import io
import json
import os
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimaltextures_tpu import config as jconfig
from optimaltextures_tpu import core as jcore
from optimaltextures_tpu.models import vgg as jvgg
from optimaltextures_tpu.ops import resize as jresize
from optimaltextures_tpu.ops.convops import (conv2d_nhwc, maxpool_2x2_ceil,
                                             pad_spatial, upsample_nearest_2x)
from optimaltextures_tpu.utils import imageio as jimageio
from optimaltextures_tpu_torch import cli, serve
from optimaltextures_tpu_torch import config as tconfig
from optimaltextures_tpu_torch import core as tcore
from optimaltextures_tpu_torch.models import fastcodec as tfast
from optimaltextures_tpu_torch.models import vgg as tvgg
from optimaltextures_tpu_torch.ops import codec, convops
from optimaltextures_tpu_torch.ops import resize as tresize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "docs", "samples", "graffiti_cholhist_256.png")
TOL = 2e-5
ONE_ROUNDING = 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _err(got, ref):
    return float(np.max(np.abs(np.asarray(got, np.float32) - np.asarray(ref, np.float32))))


def _roll(x, m):
    return np.roll(np.asarray(x), (m, m), axis=(1, 2))


# --- (a) the circular resize -------------------------------------------------

@pytest.mark.parametrize("n_in,n_out", [(32, 64), (64, 32), (64, 256), (256, 64),
                                        (128, 256), (256, 512), (160, 320), (48, 96)])
def test_circular_resample_matrix_equals_jax(n_in, n_out):
    """tests/test_tileable.py's pairs and the schedule's pass sizes."""
    got = tresize.resample_matrix_circular(n_in, n_out)
    ref = jresize.resample_matrix_circular(n_in, n_out)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    wh, ww = tresize.resample_pair((n_in, n_in), (n_out, n_out), circular=True)
    np.testing.assert_array_equal(wh, ref)
    assert not np.array_equal(tresize.resample_pair((n_in, n_in), (n_out, n_out))[0], ref)


@pytest.mark.parametrize("in_hw,out_hw,m", [((32, 32), (64, 64), 3),
                                            ((64, 64), (32, 32), 4),
                                            ((64, 48), (256, 192), 16)])
def test_circular_resize_equals_jax_and_commutes_with_rolls(in_hw, out_hw, m):
    x = np.random.default_rng(m).uniform(size=(1, *in_hw, 3)).astype(np.float32)
    ref = np.asarray(jresize.resize_nhwc(jnp.asarray(x), out_hw, circular=True))
    got = tresize.apply_resample(_t(x), *map(torch.from_numpy, tresize.resample_pair(
        in_hw, out_hw, circular=True))).numpy()
    assert _err(got, ref) < 1e-6
    mo = m * out_hw[0] // in_hw[0]
    rolled = tresize.apply_resample(_t(_roll(x, m)), *map(
        torch.from_numpy, tresize.resample_pair(in_hw, out_hw, circular=True))).numpy()
    assert _err(rolled, np.roll(got, (mo, m * out_hw[1] // in_hw[1]), (1, 2))) < 1e-6


def test_pad_spatial_equals_jax_and_refuses_other_modes():
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 3)).astype(np.float32)
    for mode in ("reflect", "wrap"):
        np.testing.assert_array_equal(
            convops.pad_spatial(_t(x), 1, mode).numpy(),
            np.asarray(pad_spatial(jnp.asarray(x), 1, mode)))
    with pytest.raises(ValueError, match="reflect|wrap"):
        convops.pad_spatial(_t(x), 1, "edge")
    with pytest.raises(ValueError, match="reflect|wrap"):
        codec.conv3x3_p2(_t(np.zeros((1, 4, 4, 64))), codec.pack(
            torch.zeros(64, 64, 3, 3), torch.zeros(64)), pad="circular")


# --- (b) the VGG stacks in wrap mode -----------------------------------------

@pytest.fixture(scope="module")
def banks():
    return jvgg.VGGBank(3), tvgg.VGGBank(3, device="cpu")


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(11).uniform(size=(1, 64, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_wrap_encode_decode_equal_jax(banks, pixels, depth):
    jb, tb = banks
    ref = np.asarray(jvgg.encode(jb.enc_params[depth], depth, jnp.asarray(pixels), "wrap"))
    got = tvgg.encode(tb.enc_params[depth], depth, _t(pixels), "wrap").numpy()
    assert _err(got, ref) < 1e-5 * max(1.0, float(np.abs(ref).max()))
    # the wrap is not the reflection: the borders differ
    assert _err(tvgg.encode(tb.enc_params[depth], depth, _t(pixels)).numpy(), ref) > 1e-3
    back_ref = np.asarray(jvgg.decode(jb.dec_params[depth], depth, jnp.asarray(ref), "wrap"))
    back = tvgg.decode(tb.dec_params[depth], depth, _t(ref), "wrap").numpy()
    assert _err(back, back_ref) < 1e-5 * max(1.0, float(np.abs(back_ref).max()))


def test_encode_taps_keep_reflect_taps(banks, pixels):
    """Style and content prep encode with reflect taps whatever the run's
    pad mode, as JAX's encode_taps (no pad-mode argument) does."""
    jb, tb = banks
    taps = tvgg.encode_taps(tb.enc_params[3], 3, _t(pixels))
    for d, tap in enumerate(taps, start=1):
        np.testing.assert_array_equal(
            tap.numpy(), tvgg.encode(tb.enc_params[d], d, _t(pixels)).numpy())
        assert _err(tap.numpy(), tvgg.encode(tb.enc_params[d], d, _t(pixels),
                                             "wrap").numpy()) > 1e-3
    for a, b in zip(taps, jvgg.encode_taps(jb.enc_params[3], 3, jnp.asarray(pixels))):
        assert _err(a.numpy(), b) < 1e-5 * max(1.0, float(np.abs(np.asarray(b)).max()))


# --- (c) the codec's plain versions in wrap mode -----------------------------

def _xla_wrap(x, w_hwio, b, relu=False, pool=False, up=False, dtype=jnp.float32):
    """JAX's XLA conv on the circular pad, in ``dtype`` (its bf16 rounds the
    conv and ``+ b`` each)."""
    x = jnp.asarray(np.asarray(x, np.float32), dtype)
    if up:
        x = upsample_nearest_2x(x)
    y = conv2d_nhwc(pad_spatial(x, 1, "wrap"), jnp.asarray(w_hwio, dtype),
                    jnp.asarray(b, dtype))
    if relu:
        y = jnp.maximum(y, 0)
    if pool:
        y = maxpool_2x2_ceil(y)
    return np.asarray(y.astype(jnp.float32))


# (wrapper, Cin, Cout, wrapper kwargs): every mode on the stage roundtrip
WRAP_CASES = [("rgb_to_relu1", 3, 64, {}),
              ("conv3x3_p2", 64, 64, dict(relu=True, pool=True)),
              ("conv3x3_p2", 128, 64, dict(relu=True)),
              ("conv3x3_full", 64, 128, dict(relu=True)),
              ("conv3x3_full", 128, 128, dict(relu=True, pool=True)),
              ("upconv_p2", 64, 64, {}), ("upconv_p2", 128, 128, {}),
              ("final_to_rgb", 64, 3, {})]


def _wrap_inputs(cin, cout, seed, hw=(12, 20)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, *hw, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, w, b


def _oihw(w_hwio, dtype=torch.float32):
    return _t(np.asarray(w_hwio).transpose(3, 2, 0, 1)).to(dtype)


@pytest.mark.parametrize("name,cin,cout,kw", WRAP_CASES)
def test_wrap_plain_versions_equal_jax_xla(name, cin, cout, kw):
    """f32: within 2e-5, tests/test_torch_codec.py's bound for the reflect
    variants against XLA."""
    x, w, b = _wrap_inputs(cin, cout, cin + cout)
    up = name == "upconv_p2"
    p = (codec.pack_up if up else codec.pack)(_oihw(w), _t(b))
    got = getattr(codec, name)(_t(x), p, pad="wrap", **kw).numpy()
    ref = _xla_wrap(x, w, b, relu=kw.get("relu", name in ("rgb_to_relu1", "upconv_p2")),
                    pool=kw.get("pool", False), up=up)
    assert got.shape == ref.shape
    assert _err(got, ref) < TOL * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("name,cin,cout,kw", WRAP_CASES)
def test_wrap_plain_versions_bf16_equal_jax_xla(name, cin, cout, kw):
    """bf16: within 2^-7 x max|ref| (tests/test_torch_bf16.py's bound: the
    plain version rounds once, XLA's bf16 conv twice). The upconv's plain
    version convolves with its folded bf16 taps on the circularly padded
    coarse image; the reference is JAX's XLA conv of the nearest-x2 image
    with those taps unfolded: each folded tap rounds its sum to bf16 once,
    as JAX's pack_upconv_fold does."""
    x, w, b = _wrap_inputs(cin, cout, 3 * cin + cout)
    up = name == "upconv_p2"
    wb, bb = _oihw(w, torch.bfloat16), _t(b).to(torch.bfloat16)
    p = (codec.pack_up if up else codec.pack)(wb, bb)
    xin = _t(x) if name == "rgb_to_relu1" else _t(x).to(torch.bfloat16)
    got = getattr(codec, name)(xin, p, pad="wrap", **kw).float().numpy()
    ref = _xla_wrap(x, np.asarray(wb.float().permute(2, 3, 1, 0)), bb.float().numpy(),
                    relu=kw.get("relu", name in ("rgb_to_relu1", "upconv_p2")),
                    pool=kw.get("pool", False), up=up, dtype=jnp.bfloat16)
    assert got.shape == ref.shape
    assert _err(got, ref) <= ONE_ROUNDING * float(np.abs(ref).max())


@pytest.mark.parametrize("c", [64, 128])
def test_folded_taps_on_the_wrapped_coarse_image_are_the_fine_wrap(c):
    """A 1-px wrap of a nearest-x2 image is the coarse image's 1-px wrap, so
    fold_up's taps apply unchanged: the folded upconv on the circularly
    padded coarse image equals the 3x3 conv of the circularly padded
    nearest-x2 image (f32, within rounding), and differs from it on the
    edge-padded coarse image."""
    x, w, b = _wrap_inputs(c, c, c, hw=(5, 7))
    fold = codec.fold_up(_t(w))
    coarse = _t(x).permute(0, 3, 1, 2)
    ref = _xla_wrap(x, w, np.zeros(c, np.float32), up=True)
    got = codec.folded_upconv(coarse, fold, "wrap").permute(0, 2, 3, 1).numpy()
    assert _err(got, ref) < TOL * max(1.0, float(np.abs(ref).max()))
    edge = codec.folded_upconv(coarse, fold, "reflect").permute(0, 2, 3, 1).numpy()
    assert _err(edge, ref) > 1e-2


def test_wrap_final_with_folded_renorm_equals_jax():
    """The next stage's 1x1 renorm folded into the final conv (pack_final),
    in wrap mode: JAX's XLA wrap conv, then the renorm (2e-4 x scale, as
    tests/test_torch_codec.py folds it)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 20, 64)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 64, 3)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(3) * 0.1).astype(np.float32)
    wrn = (rng.standard_normal((1, 1, 3, 3)) * 0.5).astype(np.float32)
    brn = (rng.standard_normal(3) * 0.1).astype(np.float32)
    ref = np.asarray(conv2d_nhwc(jnp.asarray(_xla_wrap(x, w, b)), jnp.asarray(wrn),
                                 jnp.asarray(brn)))
    p = codec.pack_final(_oihw(w), _t(b), (_oihw(wrn), _t(brn)))
    got = codec.final_to_rgb(_t(x), p, pad="wrap").numpy()
    assert _err(got, ref) < 2e-4 * max(1.0, float(np.abs(ref).max()))


def test_wrap_sizes_and_launch_counts():
    """The wrap takes a side of 1 (the reflection needs 2), and the plain
    versions count no launch."""
    x, w, b = _wrap_inputs(64, 64, 1, hw=(1, 3))
    p = codec.pack(_oihw(w), _t(b))
    codec.reset_launches()
    got = codec.conv3x3_p2(_t(x), p, relu=False, pad="wrap").numpy()
    assert _err(got, _xla_wrap(x, w, b)) < TOL * max(1.0, float(np.abs(got).max()))
    with pytest.raises(ValueError, match="H, W >= 2"):
        codec.conv3x3_p2(_t(x), p)
    assert all(v == 0 for v in codec.LAUNCHES.values())
    assert {k for k in codec.LAUNCHES if k.endswith("_wrap")} == {
        k + dt + "_wrap" for k in codec.KERNELS for dt in ("", "_bf16")}


# final_to_rgb's wrap repair (csrc/codec.cu and csrc/edge_mma.cu
# wrap_fetch and wrap_store), emulated with the kernels' index arithmetic

HALO = 18


def _wrap_repaired_box(img, y0, x0):
    """The 18 x 18 halo of the 16 x 16 tile at (y0, x0) as the kernels'
    wrap mode builds it: a TMA box with zeros outside the image, then for an
    edge tile the 576 (line, chunk) items of wrap_fetch, each loading the
    pixel at the wrapped coordinates. Returns (box, times each halo pixel
    was written)."""
    h, w = img.shape[:2]
    box = np.zeros((HALO, HALO) + img.shape[2:], img.dtype)
    ys, xs = np.arange(y0 - 1, y0 + HALO - 1), np.arange(x0 - 1, x0 + HALO - 1)
    iy, ix = (ys >= 0) & (ys < h), (xs >= 0) & (xs < w)
    box[np.ix_(iy, ix)] = img[np.ix_(ys[iy], xs[ix])]
    writes = np.zeros((HALO, HALO), int)
    left, right = x0 == 0, x0 + 16 >= w
    top, bottom = y0 == 0, y0 + 16 >= h
    if not (left or right or top or bottom):
        return box, writes
    wrap1 = lambda i, n: i + n if i < 0 else (i - n if i >= n else i)
    cmax, rmax = min(HALO - 1, w - x0 + 1), min(HALO - 1, h - y0 + 1)
    for k in range(4 * HALO * 8):
        line, j = k >> 3, k & 7
        if line < 2 * HALO:
            far = line >= HALO
            r, c = (line - HALO if far else line), (cmax if far else 0)
            on = (right if far else left) and r <= rmax
        else:
            far = line >= 3 * HALO
            c, r = (line - 3 * HALO if far else line - 2 * HALO), (rmax if far else 0)
            on = ((bottom if far else top) and c <= cmax and not (left and c == 0)
                  and not (right and c == cmax))
        if on:
            box[r, c] = img[wrap1(y0 - 1 + r, h), wrap1(x0 - 1 + c, w)]
            writes[r, c] += 1 if j == 0 else 0
    return box, writes


@pytest.mark.parametrize("hw", [(40, 56), (16, 16), (17, 33), (3, 5), (1, 1),
                                (48, 32), (2, 40)])
def test_final_to_rgb_wrap_repair_builds_the_circular_halo(hw):
    """Every stored output pixel's 3 x 3 window in the repaired box is its
    window in the circularly padded image, each far-edge pixel is loaded
    once, and interior tiles keep the box as TMA landed it."""
    h, w = hw
    img = np.random.default_rng(h * w).standard_normal((h, w, 2)).astype(np.float32)
    padded = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="wrap")
    for y0 in range(0, h, 16):
        for x0 in range(0, w, 16):
            box, writes = _wrap_repaired_box(img, y0, x0)
            assert writes.max() <= 1
            rows, cols = min(16, h - y0) + 2, min(16, w - x0) + 2
            np.testing.assert_array_equal(box[:rows, :cols],
                                          padded[y0:y0 + rows, x0:x0 + cols])


# --- (d) the kernel-covered codec in wrap mode -------------------------------

@pytest.mark.parametrize("depth", [1, 2, 3])
def test_wrap_encode_head_decode_tail_equal_jax(banks, pixels, depth):
    """tests/test_torch_codec.py's bounds (2e-4 x scale)."""
    jb, tb = banks
    ref_feat = np.asarray(jvgg.encode(jb.enc_params[depth], depth, jnp.asarray(pixels),
                                      "wrap"))
    sc = tfast.pack_stage(tb.enc_params[depth], tb.dec_params[depth], depth)
    rgb = tfast.pixels_to_rgb(tb.enc_params[depth][0], _t(pixels))
    feat = tfast.encode_head(sc, rgb, "wrap").numpy()
    assert _err(feat, ref_feat) < 2e-4 * max(1.0, float(np.abs(ref_feat).max()))
    ref_px = np.asarray(jvgg.decode(jb.dec_params[depth], depth, jnp.asarray(ref_feat),
                                    "wrap"))
    got_px = tfast.decode_tail(sc, _t(ref_feat), "wrap").numpy()
    assert _err(got_px, ref_px) < 2e-4
    assert _err(tfast.decode_tail(sc, _t(ref_feat)).numpy(), ref_px) > 1e-3


# --- (e) whole tileable runs against JAX --------------------------------------

class RotationStream:
    """Deterministic SO(n) stacks per (pass, stage), drawn with numpy (QR
    with the sign fix), handed to both packages."""

    def __init__(self, seed):
        self.seed, self.cache = seed, {}

    def __call__(self, p, i, n_iters, n):
        if (p, i) not in self.cache:
            rng = np.random.default_rng([self.seed, p, i])
            qs = []
            for _ in range(n_iters):
                q, r = np.linalg.qr(rng.standard_normal((n, n)))
                q = q * np.sign(np.diag(r))[None, :]
                if np.linalg.det(q) < 0:
                    q[:, -1] *= -1
                qs.append(q)
            self.cache[(p, i)] = np.stack(qs).astype(np.float32)
        return self.cache[(p, i)]


def _clear_jax_stage_caches():
    for fn in (jcore._run_stages_jit, jcore._run_stages_jit_nodonate,
               jcore._pass_stages_jit, jcore._pass_stages_jit_resize):
        fn.clear_cache()


def _jax_run(noise, style, stream, monkeypatch, cfg_kw):
    """JAX Synthesizer.run (fast_codec off) with the stream injected, in
    pass-major, deepest-first order."""
    order = [(p, i) for p in range(cfg_kw["passes"]) for i in range(cfg_kw["depth"])]
    calls = []

    def fake_stage_rotations(key, n_iters, n):
        p, i = order[len(calls)]
        calls.append((p, i))
        return jnp.asarray(stream(p, i, n_iters, n))

    _clear_jax_stage_caches()
    try:
        monkeypatch.setattr("optimaltextures_tpu.transport.stage_rotations",
                            fake_stage_rotations)
        synth = jcore.Synthesizer(jconfig.OptexConfig(fast_codec=False, **cfg_kw))
        out = np.asarray(synth.run(jnp.asarray(noise), [style]))
    finally:
        _clear_jax_stage_caches()
    assert calls == order
    return out


@pytest.fixture(scope="module")
def style64():
    return jimageio.load_image(SAMPLE, 64)


@pytest.mark.parametrize("extra", [dict(no_multires=True, passes=2),
                                   dict(no_multires=False, passes=2)])
def test_tileable_run_equals_jax(style64, monkeypatch, extra):
    """64 px, depth 3, no PCA: 2 passes at 64 px, then the multires plan (64
    -> 256 -> 64), whose pass resizes wrap their taps."""
    cfg_kw = dict(size=64, iters=40, depth=3, seed=0, no_pca=True,
                  style=["graffiti.png"], tileable=True, **extra)
    noise = np.random.default_rng(5).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    stream = RotationStream(17)
    ref = _jax_run(noise, style64, stream, monkeypatch, cfg_kw)
    synth = tcore.Synthesizer(tconfig.OptexConfig(**cfg_kw), device="cpu")
    assert synth.pad_mode == "wrap"
    got = synth.run(noise, [style64], rotations=stream).numpy()
    assert got.shape == ref.shape == (1, 64, 64, 3)
    assert _err(got, ref) < 5e-4
    if not extra["no_multires"]:
        # the pastiche's pass resizes wrap their taps (the style's do not)
        assert ((64, 64), (256, 256), True) in synth._resample
        assert ((256, 256), (64, 64), True) in synth._resample


def test_tileable_run_is_not_the_reflect_run(style64):
    kw = dict(size=64, passes=1, iters=20, no_multires=True, depth=2, seed=0,
              no_pca=True, style=["graffiti.png"])
    noise = np.random.default_rng(5).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    stream = RotationStream(3)
    wrap = tcore.Synthesizer(tconfig.OptexConfig(tileable=True, **kw),
                             device="cpu").run(noise, [style64], rotations=stream)
    refl = tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu").run(
        noise, [style64], rotations=stream)
    assert _err(wrap.numpy(), refl.numpy()) > 1e-2


# --- (f) style and content prep keep reflect taps -----------------------------

def test_tileable_style_and_content_prep_equal_the_reflect_runs(style64):
    kw = dict(size=64, passes=2, iters=20, depth=3, seed=0, style=["g.png"],
              content_strength=0.2)
    content = np.random.default_rng(2).uniform(size=(1, 64, 48, 3)).astype(np.float32)
    synths = [tcore.Synthesizer(tconfig.OptexConfig(tileable=t, **kw), device="cpu")
              for t in (False, True)]
    styles = [torch.as_tensor(style64)]
    preps = [s._dispatch_style_prep(styles, 64, True) for s in synths]
    for (fa, sa, va), (fb, sb, vb) in zip(*preps):
        for a, b in ((fa, fb), (sa, sb), (va, vb)):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)
    ks = [s._choose_widths(p) for s, p in zip(synths, preps)]
    slims = [s._finish_style_prep(p, *k) for s, p, k in zip(synths, preps, ks)]
    targets = [s._assemble_targets(sl, torch.as_tensor(content), k[1])
               for s, sl, k in zip(synths, slims, ks)]
    for ta, tb in zip(*targets):
        assert torch.equal(ta.content, tb.content)
        assert torch.equal(ta.eigvecs, tb.eigvecs)


# --- (g) the pass-size check ------------------------------------------------

@pytest.mark.parametrize("kw", [dict(size=66, depth=3, no_multires=True),
                                dict(size=99, depth=2, no_multires=True),
                                dict(size=100, depth=3, passes=3),
                                dict(size=98, depth=2, no_multires=True),
                                dict(size=102, depth=3, passes=2)])
def test_pass_size_check_matches_jax(kw):
    cfg = dict(style=["x.png"], tileable=True, **kw)
    try:
        jcore.Synthesizer(jconfig.OptexConfig(**cfg))
        jerr = None
    except ValueError as e:
        jerr = str(e)
    try:
        tcore.Synthesizer(tconfig.OptexConfig(**cfg), device="cpu")
        terr = None
    except ValueError as e:
        terr = str(e)
    assert terr == jerr
    # the same config without tileable builds on both sides
    tcore.Synthesizer(tconfig.OptexConfig(**{**cfg, "tileable": False}), device="cpu")
    if kw["size"] in (66, 99):
        assert terr is not None and "divisible" in terr


# --- (h) shift-equivariance on the torus --------------------------------------

def _equivariance(style, hist_mode, tileable, extra=None, m=16):
    kw = dict(size=64, passes=1, iters=6, no_multires=True, depth=2, seed=0,
              style=["g.png"], hist_mode=hist_mode, tileable=tileable)
    kw.update(extra or {})
    noise = np.random.default_rng(7).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    out = tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu").run(noise, [style])
    shifted = tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu").run(
        _roll(noise, m), [style])
    return _err(shifted.numpy(), _roll(out.numpy(), m))


@pytest.mark.parametrize("hist_mode", ["chol", "cdf"])
def test_tileable_run_is_shift_equivariant(style64, hist_mode):
    """JAX tests/test_tileable.py's bounds: < 1e-2 wrapped, and the reflect
    run's error more than 10x that."""
    err_wrap = _equivariance(style64, hist_mode, True)
    assert err_wrap < 1e-2, err_wrap
    err_reflect = _equivariance(style64, hist_mode, False)
    assert err_reflect > 10 * max(err_wrap, 1e-4), (err_reflect, err_wrap)


def test_tileable_multires_run_is_shift_equivariant(style64):
    """64 -> 256 -> 64 through the circular resizes: < 2e-2."""
    err = _equivariance(style64, "chol", True,
                        dict(no_multires=False, passes=2, iters=4))
    assert err < 2e-2, err


# --- (i) the CLI and (j) the server -------------------------------------------

def test_cli_tileable_writes_jax_file_name(tmp_path):
    args = ["--style", SAMPLE, "--size", "32", "--passes", "1", "--iters", "4",
            "--no_multires", "--depth", "2", "--seed", "1", "--tileable"]
    assert cli.build_parser().parse_args(args).tileable
    assert cli.main(args + ["--device", "cpu", "--output_dir", str(tmp_path),
                            "--quiet"]) == 0
    want = jimageio.output_name(jconfig.OptexConfig(
        style=[SAMPLE], size=32, passes=1, iters=4, no_multires=True, depth=2,
        seed=1, tileable=True)) + ".png"
    assert "tileable" in want
    assert os.listdir(tmp_path) == [want]


def test_served_tileable_request_returns_200():
    from PIL import Image

    with open(SAMPLE, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    srv = serve.serve(port=0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/synthesize",
            data=json.dumps({"config": dict(size=32, passes=1, iters=4, depth=2,
                                            no_multires=True, seed=0, tileable=True),
                             "style_b64": [b64]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            status, body = r.status, r.read()
    finally:
        srv.shutdown()
        srv.server_close()
        t.join()
    assert status == 200
    assert np.asarray(Image.open(io.BytesIO(body))).shape == (32, 32, 3)
