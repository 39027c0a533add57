"""The tensor-core kernels' arithmetic and layouts, on the CPU.

``conv3x3_full`` runs 3xTF32 on ``mma.sync`` and ``conv64`` runs bf16 on
``wgmma``; neither runs here. What they rest on does: ``codec.split_tf32``
(the hi/lo split the kernel makes with ``cvt.rna.tf32.f32``), the packed
hi/lo weights ``codec.pack_tc``, a float64 emulation of the 3xTF32 conv held
to the kernel's bound against the plain version (and a 1xTF32 one that
misses it: why the kernel sums three products), and ``conv64.pack_tc``, the
weight matrix the conv64 kernel builds from ``wrow``, against the JAX tool's
packing."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from optimaltextures_tpu_torch.ops import codec, conv64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the kernel-vs-plain bound of the codec kernels (chip_smoke.py, tests/test_torch_cuda.py)
REL_TOL = 2e-5


def _unpack_tc(w_tc):
    """codec.pack_tc's inverse: the (hi, lo) halves as (3, 3, Cin, 128)."""
    c8, _, j, _, _ = w_tc.shape
    f = w_tc.reshape(c8, 9, j, 8, 4, 4).permute(1, 0, 4, 2, 3, 5)  # tap c t j g .
    hi = torch.stack([f[..., 0], f[..., 1]], 2)     # (tap, c, k-half, t, j, g)
    lo = torch.stack([f[..., 2], f[..., 3]], 2)
    return hi.reshape(3, 3, 8 * c8, 8 * j), lo.reshape(3, 3, 8 * c8, 8 * j)


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


@pytest.mark.parametrize("cin", [64, 128])
def test_pack_tc_hi_lo_rebuild_w_hwio(cin, rng):
    w = torch.from_numpy(rng.normal(0, 0.1, (128, cin, 3, 3)).astype(np.float32))
    p = codec.pack(w, torch.zeros(128))
    assert p.w_tc.shape == (cin // 8, 9, 16, 32, 4) and p.w_tc.dtype == torch.float32
    hi, lo = _unpack_tc(p.w_tc)
    want_hi, want_lo = codec.split_tf32(p.w_hwio)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    rebuilt = hi.double() + lo.double()
    assert bool(((rebuilt - p.w_hwio.double()).abs()
                 <= 2.0 ** -22 * p.w_hwio.double().abs()).all())
    # the fragment order itself: chunk c, tap, n8 tile j, lane 4g + t holds
    # {hi(k), hi(k + 4), lo(k), lo(k + 4)} of w[tap, 8c + k, 8j + g] at k = t
    taps = p.w_hwio.reshape(9, cin, 128)
    for c, tap, j, g, t in [(0, 0, 0, 0, 0), (cin // 8 - 1, 8, 15, 7, 3),
                            (3, 4, 9, 5, 2)]:
        v = taps[tap, 8 * c + t, 8 * j + g], taps[tap, 8 * c + t + 4, 8 * j + g]
        h, l = codec.split_tf32(torch.stack(v))
        assert p.w_tc[c, tap, j, 4 * g + t].tolist() == [*h.tolist(), *l.tolist()]


def test_pack_tc_only_for_the_128_channel_convs():
    assert codec.pack(torch.zeros(64, 128, 3, 3), torch.zeros(64)).w_tc is None
    assert codec.pack(torch.zeros(3, 64, 3, 3), torch.zeros(3)).w_tc is None
    assert codec.pack(torch.zeros(128, 64, 3, 3), torch.zeros(128)).w_tc is not None


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


@pytest.mark.parametrize("cin,relu,pool", [(64, True, False), (128, True, True)])
def test_3xtf32_conv_holds_the_kernel_bound(cin, relu, pool, rng):
    """hi*hi + hi*lo + lo*hi stays within 2e-5 x max|plain| of the f32 plain
    version on 32 x 32 inputs; hi*hi alone (one TF32 product) does not."""
    x = torch.from_numpy(rng.uniform(0, 1, (1, 32, 32, cin)).astype(np.float32))
    p = codec.pack(torch.from_numpy(rng.normal(0, 0.1, (128, cin, 3, 3)).astype(np.float32)),
                   torch.from_numpy(rng.normal(0, 0.1, 128).astype(np.float32)))
    ref = codec.conv3x3_plain(x, p, relu=relu, pool=pool).double()
    bound = REL_TOL * float(ref.abs().max())
    three = _tf32_conv(x, p, relu, pool, ("hh", "hl", "lh"))
    one = _tf32_conv(x, p, relu, pool, ("hh",))
    assert three.shape == ref.shape
    assert float((three - ref).abs().max()) <= bound
    assert float((one - ref).abs().max()) > bound


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
