"""The tensor-core kernels' arithmetic and layouts, on the CPU.

``conv3x3_p2``, ``conv3x3_full`` and ``upconv_p2`` run 3xTF32 on
``mma.sync`` and ``conv64`` runs bf16 on ``wgmma``; none runs here. What
they rest on does: ``codec.split_tf32`` (the hi/lo split the kernels make
with ``cvt.rna.tf32.f32``), the packed hi/lo weights ``codec.pack_tc`` and
``codec.pack_up`` (the upconv's folded taps, bit-equal to the JAX package's
``pack_upconv_fold``), the fold identity on the edge-padded coarse image,
float64 emulations of the 3xTF32 convs held to the kernels' bound against
the plain version (and 1xTF32 ones that miss it: why the kernels sum three
products), and ``conv64.pack_tc``, the weight matrix the conv64 kernel
builds from ``wrow``, against the JAX tool's packing."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from optimaltextures_tpu.ops.pallas import codec as jcodec
from optimaltextures_tpu_torch.models import arch, fastcodec, vgg
from optimaltextures_tpu_torch.ops import codec, conv64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the kernel-vs-plain bound of the codec kernels (chip_smoke.py, tests/test_torch_cuda.py)
REL_TOL = 2e-5


def _unfrag(frags):
    """The inverse of codec's fragment order: (Cin/8, T, Cout/8, 32, 4) ->
    the (hi, lo) halves as (T, Cin, Cout)."""
    c8, taps, j, _, _ = frags.shape
    f = frags.reshape(c8, taps, j, 8, 4, 4).permute(1, 0, 4, 2, 3, 5)  # tap c t j g .
    hi = torch.stack([f[..., 0], f[..., 1]], 2)     # (tap, c, k-half, t, j, g)
    lo = torch.stack([f[..., 2], f[..., 3]], 2)
    return hi.reshape(taps, 8 * c8, 8 * j), lo.reshape(taps, 8 * c8, 8 * j)


def _low13(t):
    return t.contiguous().view(torch.int32) & 0x1FFF


def _wide(rng, shape):
    """Magnitudes log-uniform over 1e-30 .. 1e30, random signs."""
    mag = 10.0 ** rng.uniform(-30, 30, shape)
    return torch.from_numpy(np.where(rng.uniform(size=shape) < 0.5, -mag, mag)
                            .astype(np.float32))


@pytest.mark.parametrize("kind", ["normal", "wide"])
def test_split_tf32_rebuilds_its_input(kind, rng):
    x = (torch.from_numpy(rng.normal(0, 3, 4096).astype(np.float32))
         if kind == "normal" else _wide(rng, 4096))
    hi, lo = codec.split_tf32(x)
    assert int(_low13(hi).abs().max()) == 0 and int(_low13(lo).abs().max()) == 0
    # hi is x to TF32's 11 significant bits, lo the remainder to 11 more
    xd, hd, ld = x.double(), hi.double(), lo.double()
    assert bool(((hd - xd).abs() <= 2.0 ** -11 * xd.abs()).all())
    assert bool(((hd + ld - xd).abs() <= 2.0 ** -22 * xd.abs()).all())
    assert bool((torch.sign(hi) == torch.sign(x)).all())


def test_split_tf32_zero_signs_and_ties():
    x = torch.tensor([0.0, -0.0, 1.0, -1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 + 2.0 ** -20], dtype=torch.float32)
    hi, lo = codec.split_tf32(x)
    assert hi[:4].tolist() == [0.0, -0.0, 1.0, -1.0] and lo[:4].tolist() == [0.0] * 4
    assert torch.signbit(hi[1]) and not torch.signbit(hi[0])
    # a tie rounds away from zero (cvt.rna); the remainder is exact here
    assert hi[4] == 1.0 + 2.0 ** -10 and lo[4] == -(2.0 ** -11)
    assert hi[5] == -(1.0 + 2.0 ** -10) and lo[5] == 2.0 ** -11
    assert hi[6] == 1.0 + 2.0 ** -10 and float(hi[6] + lo[6]) == float(x[6])
    # the split of -x is the negated split of x
    h2, l2 = codec.split_tf32(-x)
    assert torch.equal(h2, -hi) and torch.equal(l2, -lo)


@pytest.mark.parametrize("cin,cout", [(64, 128), (128, 128), (64, 64), (128, 64)])
def test_pack_tc_hi_lo_rebuild_w_hwio(cin, cout, rng):
    w = torch.from_numpy(rng.normal(0, 0.1, (cout, cin, 3, 3)).astype(np.float32))
    p = codec.pack(w, torch.zeros(cout))
    assert p.w_tc.shape == (cin // 8, 9, cout // 8, 32, 4)
    assert p.w_tc.dtype == torch.float32
    hi, lo = _unfrag(p.w_tc)
    taps = p.w_hwio.reshape(9, cin, cout)
    want_hi, want_lo = codec.split_tf32(taps)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    rebuilt = hi.double() + lo.double()
    assert bool(((rebuilt - taps.double()).abs()
                 <= 2.0 ** -22 * taps.double().abs()).all())
    # the fragment order itself: chunk c, tap, n8 tile j, lane 4g + t holds
    # {hi(k), hi(k + 4), lo(k), lo(k + 4)} of w[tap, 8c + k, 8j + g] at k = t
    for c, tap, j, g, t in [(0, 0, 0, 0, 0), (cin // 8 - 1, 8, cout // 8 - 1, 7, 3),
                            (3, 4, 5, 5, 2)]:
        v = taps[tap, 8 * c + t, 8 * j + g], taps[tap, 8 * c + t + 4, 8 * j + g]
        h, l = codec.split_tf32(torch.stack(v))
        assert p.w_tc[c, tap, j, 4 * g + t].tolist() == [*h.tolist(), *l.tolist()]


def test_pack_tc_only_for_the_128_channel_convs():
    """Which convs carry tensor-core weights: every conv with 64 or 128
    channels in and out (the name is from when only the 128-output ones
    did), not the 3->64 entry nor the 64->3 final; an upconv carries its
    folded taps instead. As fastcodec.pack_stage packs a depth-3 stage."""
    for cout, cin in ((64, 64), (64, 128), (128, 64), (128, 128)):
        p = codec.pack(torch.zeros(cout, cin, 3, 3), torch.zeros(cout))
        assert p.w_tc is not None and p.w_up is None
    for cout, cin in ((3, 64), (64, 3)):
        p = codec.pack(torch.zeros(cout, cin, 3, 3), torch.zeros(cout))
        assert p.w_tc is None and p.w_up is None
    for c in (64, 128):
        p = codec.pack_up(torch.zeros(c, c, 3, 3), torch.zeros(c))
        assert p.w_tc is None and p.w_up.shape == (c // 8, 16, c // 8, 32, 4)

    bank = vgg.synthetic_bank(3)
    sc = fastcodec.pack_stage(bank.enc_params[3], bank.dec_params[3], 3,
                              bank.enc_params[2][0])
    assert [p.w_tc is not None for p in sc.head] == [False, True, True, True]
    assert [p.w_up is not None for p in sc.tail] == [True, False, True]
    assert [p.w_tc is not None for p in sc.tail] == [False, True, False]
    assert sc.final.w_tc is None and sc.final.w_up is None
    assert [s[3] for s in arch.decoder_specs(3)[1:-1]] == ["up", "", "up"]


@pytest.mark.parametrize("c", [64, 128])
def test_pack_up_is_jax_pack_upconv_fold(c, rng):
    """The folded taps equal pack_upconv_fold's blocks bit for bit (the same
    f32 sums in the same order), and w_up holds their hi/lo split in
    fragment order, tap-phase 8a + 4u + 2b + v."""
    w_hwio = rng.normal(0, 0.1, (3, 3, c, c)).astype(np.float32)
    b = rng.normal(0, 0.1, c).astype(np.float32)
    wa0, wa1, _ = jcodec.pack_upconv_fold(jnp.asarray(w_hwio), jnp.asarray(b))
    wa = (np.asarray(wa0), np.asarray(wa1))          # each (u, 2 Co, 3 Cin)
    fold = codec.fold_up(torch.from_numpy(w_hwio))   # (a, b, u, v, ci, co)
    assert fold.shape == (2, 2, 2, 2, c, c) and fold.dtype == torch.float32
    for a in range(2):
        for ph in range(2):
            for u in range(2):
                for v in range(2):
                    slot = ph + v                    # the 3-wide column window
                    block = wa[a][u, ph * c:(ph + 1) * c, slot * c:(slot + 1) * c]
                    np.testing.assert_array_equal(fold[a, ph, u, v].numpy(), block.T)

    p = codec.pack_up(torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy()),
                      torch.from_numpy(b))
    assert p.w_up.shape == (c // 8, 16, c // 8, 32, 4)
    hi, lo = _unfrag(p.w_up)
    want_hi, want_lo = codec.split_tf32(fold.permute(0, 2, 1, 3, 4, 5).reshape(16, c, c))
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    # tap-phase (a, u, b, v) = (1, 0, 1, 1), chunk 2, n8 tile 3, lane 4 * 5 + 1
    v = fold[1, 1, 0, 1, 8 * 2 + 1, 8 * 3 + 5], fold[1, 1, 0, 1, 8 * 2 + 5, 8 * 3 + 5]
    h, l = codec.split_tf32(torch.stack(v))
    assert p.w_up[2, 8 + 2 + 1, 3, 4 * 5 + 1].tolist() == [*h.tolist(), *l.tolist()]


def _folded_conv(x, fold):
    """The 2x2 folded-tap conv of the edge-padded coarse x at every fine
    phase, no bias, in x's dtype: NHWC coarse (N, Hc, Wc, Cin) -> (N, 2Hc,
    2Wc, Cout)."""
    n, hc, wc, _ = x.shape
    xe = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    out = x.new_zeros((n, fold.shape[-1], 2 * hc, 2 * wc))
    for a in range(2):
        for ph in range(2):
            k = fold[a, ph].permute(3, 2, 0, 1)           # (co, ci, u, v)
            out[:, :, a::2, ph::2] = F.conv2d(
                xe[:, :, a:a + hc + 1, ph:ph + wc + 1], k)
    return out.permute(0, 2, 3, 1)


@pytest.mark.parametrize("hw", [(1, 2), (7, 9), (17, 23)])
def test_folded_taps_on_the_edge_padded_coarse_image_are_the_upconv(hw, rng):
    """In float64, without the split: the 4 folded taps per fine pixel on
    the edge-padded coarse image equal nearest-x2 + reflect pad + 3x3 conv
    (conv3x3_plain(up=True)), down to one coarse row."""
    c = 16
    x = torch.from_numpy(rng.normal(0, 1, (2, *hw, c)))
    w = torch.from_numpy(rng.normal(0, 0.1, (c, c, 3, 3)))
    b = torch.from_numpy(rng.normal(0, 0.1, c))
    ref = codec.conv3x3_plain(x, codec.Packed(w, b, w.permute(2, 3, 1, 0)),
                              relu=True, up=True)
    got = torch.relu(_folded_conv(x, codec.fold_up(w.permute(2, 3, 1, 0))) + b)
    assert got.shape == ref.shape == (2, 2 * hw[0], 2 * hw[1], c)
    assert float((got - ref).abs().max()) <= 1e-10


def _tf32_conv(x, p, relu, pool, terms):
    """The kernel's arithmetic in float64: sum over ``terms`` of conv(x_part,
    w_part), each part a TF32 half from split_tf32; bias, ReLU, pool."""
    xh, xl = codec.split_tf32(x)
    wh, wl = codec.split_tf32(p.w)
    parts = {"hh": (xh, wh), "hl": (xh, wl), "lh": (xl, wh)}
    t = 0
    for term in terms:
        xa, wa = parts[term]
        xp = F.pad(xa.double().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        t = t + F.conv2d(xp, wa.double())
    t = t + p.b.double()[None, :, None, None]
    if relu:
        t = torch.relu(t)
    if pool:
        t = F.max_pool2d(t, 2, 2, ceil_mode=True)
    return t.permute(0, 2, 3, 1)


def _bound_holds_for_three_products_only(ref, three, one):
    bound = REL_TOL * float(ref.abs().max())
    assert three.shape == one.shape == ref.shape
    assert float((three - ref).abs().max()) <= bound
    assert float((one - ref).abs().max()) > bound


@pytest.mark.parametrize("cin,cout,relu,pool", [
    (64, 128, True, False), (128, 128, True, True),      # conv3x3_full
    (64, 64, True, True), (128, 64, True, False)])       # conv3x3_p2
def test_3xtf32_conv_holds_the_kernel_bound(cin, cout, relu, pool, rng):
    """hi*hi + hi*lo + lo*hi stays within 2e-5 x max|plain| of the f32 plain
    version on 32 x 32 inputs; hi*hi alone (one TF32 product) does not."""
    x = torch.from_numpy(rng.uniform(0, 1, (1, 32, 32, cin)).astype(np.float32))
    p = codec.pack(torch.from_numpy(rng.normal(0, 0.1, (cout, cin, 3, 3)).astype(np.float32)),
                   torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32)))
    _bound_holds_for_three_products_only(
        codec.conv3x3_plain(x, p, relu=relu, pool=pool).double(),
        _tf32_conv(x, p, relu, pool, ("hh", "hl", "lh")),
        _tf32_conv(x, p, relu, pool, ("hh",)))


@pytest.mark.parametrize("c", [64, 128])
def test_3xtf32_upconv_holds_the_kernel_bound(c, rng):
    """upconv_p2's arithmetic: the folded taps split as pack_up splits them,
    the coarse input as the kernel splits it, three products per tap summed
    in float64: within 2e-5 x max|plain| of the f32 plain version (upsample,
    reflect pad, 9-tap conv) on a 16 x 16 coarse input; one product misses."""
    x = torch.from_numpy(rng.uniform(0, 1, (1, 16, 16, c)).astype(np.float32))
    p = codec.pack_up(torch.from_numpy(rng.normal(0, 0.1, (c, c, 3, 3)).astype(np.float32)),
                      torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
    fh, fl = codec.split_tf32(codec.fold_up(p.w_hwio))
    xh, xl = codec.split_tf32(x)
    part = {k: _folded_conv(xa.double(), fa.double())
            for k, (xa, fa) in {"hh": (xh, fh), "hl": (xh, fl), "lh": (xl, fh)}.items()}
    bias = p.b.double()
    three = torch.relu(part["lh"] + part["hl"] + part["hh"] + bias)
    one = torch.relu(part["hh"] + bias)
    _bound_holds_for_three_products_only(
        codec.conv3x3_plain(x, p, relu=True, up=True).double(), three, one)


# ---------------------------------------------------------------------------
# conv64: the wgmma A operand


@pytest.fixture(scope="module")
def proto():
    """tools/pallas_conv_proto.py, loaded from its path. Its import points
    JAX's persistent compilation cache elsewhere; the settings the other
    tests run with are restored right after."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "pallas_conv_proto", os.path.join(REPO, "tools", "pallas_conv_proto.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def test_conv64_pack_tc_is_the_weight_matrix(proto, rng):
    """pack_tc(wrow)[co, 64 (3r + s) + ci] = w[r, s, ci, co]: unpack_wrow
    rearranged, and the same from the JAX tool's own pack_wrow."""
    w = rng.normal(0, 0.1, (3, 3, 64, 64)).astype(np.float32)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    a = conv64.pack_tc(conv64.pack_wrow(wb))
    assert a.shape == (64, 576) and a.dtype == torch.bfloat16
    assert torch.equal(a, conv64.unpack_wrow(conv64.pack_wrow(wb))
                       .permute(3, 0, 1, 2).reshape(64, 576))
    assert torch.equal(a.reshape(64, 3, 3, 64), wb.permute(3, 0, 1, 2))
    jrow = np.asarray(proto.pack_wrow(jnp.asarray(w, jnp.bfloat16)), np.float32)
    a_jax = conv64.pack_tc(torch.from_numpy(jrow))
    np.testing.assert_array_equal(a_jax.numpy(), a.float().numpy())
