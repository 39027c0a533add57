"""The bf16 wgmma kernel's layouts and its three modes, on the CPU.

``csrc/conv_wg.cu`` (``conv3x3_wg<COUT, CIN>``: the bf16 ``conv3x3_p2`` at
COUT 64 and ``conv3x3_full`` at COUT 128; ``upconv_wg<C>``: the bf16
``upconv_p2``) cannot run here, so its addressing is modelled in torch with
the kernel's own formulas:

* ``codec.pack_wg`` and ``codec.pack_wg_up`` (the A operand, one kind of
  block's weights as they lie in shared memory) read back through the
  128-byte-swizzled K-major descriptor (the swizzle applied to the address
  bits, as the hardware does) rebuild the bf16 HWIO weights or the folded
  upconv taps bit for bit; ``codec.pack`` / ``pack_up`` fill them for bf16
  weights and the f32 fragments for f32.
* A model of the whole kernel in each mode: the kinds of block, the
  producer's halo rows (the conv's reflect, the upconv's clamp, per row and
  per pixel, ring slot g % 8, the group pitch), each tap's B operand formed
  from the unswizzled descriptor's (start, LBO, SBO) over the flat ring
  (the upconv's phase (a, b) shifting its rows by a and its pixels by b),
  the K loop, bias, ReLU and the pool as the epilogue computes them, the
  strips, bands and (strided, in the upconv) stores, and the ring's
  releases (every halo row freed once by each consumer warpgroup, in
  order, before its slot is loaded again). Held against the bf16 plain
  version, and once a mode against JAX's Pallas kernel in interpret mode,
  within one bf16 rounding (2^-7 x max|ref|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimaltextures_tpu.ops.pallas import codec as jcodec
from optimaltextures_tpu_torch.ops import codec

BF = torch.bfloat16
ONE_ROUNDING = 2.0 ** -7
RING = 8          # halo row slots (kRing)
BLOCK = 64 * 128  # bytes of A for one tap and 64-ci block (kBlockBytes)


def _cfg(cin, up=False):
    """(strip width NS, halo pixels a row, group pitch, slot bytes) as
    ``Cfg<CIN, NS, TAPS>`` and ``kStrip<UP, CIN>`` set them."""
    ns = 64 if cin == 64 or up else 32
    px = ns + 2
    pitch = (px if px % 2 else px + 1) * 16
    return ns, px, pitch, cin // 8 * pitch


def _reflect1(i, n):
    i = -i if i < 0 else i
    return 2 * n - 2 - i if i >= n else i


def _clamp1(i, n):
    return min(max(i, 0), n - 1)


def _a_addr(start):
    """(64, 16) byte addresses of A (co rows, k16) read through a K-major
    128-byte-swizzle descriptor at ``start`` (SBO 1024): the logical address
    of (m, k), then the swizzle on its bits (16-byte chunk ^ bits 7-9)."""
    m = torch.arange(64).reshape(64, 1)
    k = torch.arange(16).reshape(1, 16)
    logical = start + (m // 8) * 1024 + (m % 8) * 128 + 2 * k
    return logical ^ (((logical >> 7) & 7) << 4)


def _b_addr(start, lbo, sbo, n):
    """(16, n) byte addresses of B (k16, pixels) read through a K-major
    unswizzled descriptor: core matrices of 8 pixels x 16 bytes, 8-pixel
    groups SBO apart, the two 8-channel k groups LBO apart."""
    k = torch.arange(16).reshape(16, 1)
    p = torch.arange(n).reshape(1, n)
    return start + (p // 8) * sbo + (p % 8) * 16 + (k // 8) * lbo + (k % 8) * 2


def _weights(cin, seed, cout=128):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(0, 0.1, (cout, cin, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32))
    return w.to(BF), b.to(BF)


def _a_block(image, tap, kk, cin):
    """The (64, 16) A operand of (tap, k16 step kk): block tap * Cin/64 +
    kk / 4, start + 32 (kk % 4) bytes; and the byte addresses it reads."""
    addr = _a_addr((tap * (cin // 64) + kk // 4) * BLOCK + (kk % 4) * 32)
    return image[addr // 2], addr


def _bits(t):
    return t.contiguous().view(torch.int16)


# --- the weight images -------------------------------------------------------

@pytest.mark.parametrize("cout,cin,half", [
    (128, 64, 0), (128, 64, 1), (128, 128, 0), (128, 128, 1), (64, 64, 0),
    (64, 128, 0)])
def test_pack_wg_reads_back_as_the_weights(cout, cin, half):
    """Every A operand the conv mode reads (tap, k16 step kk) is W[r, s,
    16 kk:16 kk + 16, 64 half:64 half + 64] transposed, bit for bit, and
    together they cover the image; one image a co half."""
    w, b = _weights(cin, cin + half + cout, cout)
    p = codec.pack(w, b)
    assert p.w_wg.shape == (cout // 64, 9, cin // 64, 64, 64) and p.w_wg.dtype == BF
    image = p.w_wg[half].reshape(-1)          # the shared-memory bytes / 2
    hwio = w.permute(2, 3, 1, 0)
    seen = torch.zeros(image.numel(), dtype=torch.bool)
    for tap in range(9):
        for kk in range(cin // 16):
            a, addr = _a_block(image, tap, kk, cin)
            want = hwio[tap // 3, tap % 3, 16 * kk:16 * kk + 16,
                        64 * half:64 * half + 64].t()
            assert torch.equal(_bits(a), _bits(want))
            seen[addr.reshape(-1) // 2] = True
    assert bool(seen.all())


@pytest.mark.parametrize("c,kind", [(64, 0), (64, 1), (64, 2), (64, 3),
                                    (128, 0), (128, 3), (128, 5), (128, 6)])
def test_pack_wg_up_reads_back_as_the_folded_taps(c, kind):
    """Kind (2a + b) C/64 + half of ``pack_wg_up``: every A operand the
    upconv mode reads (tap 2u + v, k16 step kk) is fold[a, b, u, v, 16 kk:
    16 kk + 16, 64 half:64 half + 64] transposed (``fold_up``'s bf16 sums,
    bit-equal to JAX's ``pack_upconv_fold``), bit for bit, covering the
    image."""
    halves = c // 64
    p = codec.pack_up(*_weights(c, c + kind, c))
    assert p.w_wg.shape == (4 * halves, 4, c // 64, 64, 64) and p.w_wg.dtype == BF
    half, (a, b) = kind % halves, divmod(kind // halves, 2)
    image = p.w_wg[kind].reshape(-1)
    seen = torch.zeros(image.numel(), dtype=torch.bool)
    for tap in range(4):
        u, v = divmod(tap, 2)
        for kk in range(c // 16):
            got, addr = _a_block(image, tap, kk, c)
            want = p.w_fold[a, b, u, v, 16 * kk:16 * kk + 16,
                            64 * half:64 * half + 64].t()
            assert torch.equal(_bits(got), _bits(want))
            seen[addr.reshape(-1) // 2] = True
    assert bool(seen.all())


@pytest.mark.parametrize("cout,cin,dtype,field", [
    (128, 64, BF, "w_wg"), (128, 128, BF, "w_wg"), (64, 64, BF, "w_wg"),
    (64, 128, BF, "w_wg"), (128, 64, torch.float32, "w_tc"),
    (128, 128, torch.float32, "w_tc"), (64, 128, torch.float32, "w_tc"),
    (64, 3, BF, None), (3, 64, BF, None)])
def test_pack_fills_w_wg_for_bf16_and_w_tc_for_f32(cout, cin, dtype, field):
    """bf16 64|128 -> 64|128 weights carry the wgmma image and no fragments;
    f32 ones carry the 3xTF32 fragments; the narrow convs neither.
    ``pack_wg`` refuses what the kernel does not take, ``pack_tc`` bf16."""
    p = codec.pack(torch.zeros(cout, cin, 3, 3, dtype=dtype),
                   torch.zeros(cout, dtype=dtype))
    assert (p.w_wg is not None) == (field == "w_wg")
    assert (p.w_tc is not None) == (field == "w_tc")
    if field != "w_wg":
        with pytest.raises(ValueError):
            codec.pack_wg(p.w.permute(2, 3, 1, 0))
    else:
        with pytest.raises(ValueError):
            codec.pack_tc(p.w.permute(2, 3, 1, 0))


@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_pack_up_fills_w_wg_for_bf16_and_w_up_for_f32(c, dtype):
    """An upconv's bf16 weights carry the wgmma images of its 4 C/64 kinds,
    its f32 ones the 3xTF32 fragments; both the folded taps."""
    p = codec.pack_up(torch.zeros(c, c, 3, 3, dtype=dtype), torch.zeros(c, dtype=dtype))
    assert p.w_fold.shape == (2, 2, 2, 2, c, c) and p.w_tc is None
    if dtype == BF:
        assert p.w_up is None and p.w_wg.shape == (4 * c // 64, 4, c // 64, 64, 64)
    else:
        assert p.w_wg is None and p.w_up.shape == (c // 8, 16, c // 8, 32, 4)
        with pytest.raises(ValueError):
            codec.pack_wg_up(p.w_fold)


# --- a model of the kernel ---------------------------------------------------

def _model_wg(x, p, band, up, relu, pool):
    """What ``conv3x3_wg`` (``up`` False) or ``upconv_wg`` (True) computes,
    step by step with its formulas: per kind of block (a co half; the
    upconv's (row phase a, column phase b, co half)), the items (image,
    band, strip) in order, the producer's rows into ring slot g % 8 (the
    conv reflects, the upconv clamps, per row and per pixel; 16 bytes a ci
    group at group pitch), each pair's K loop over B operands formed from
    the unswizzled descriptor (start slot(row + r) + 2 kk pitch + 16 s,
    LBO = pitch, SBO = 128; the upconv's tap (u, v) reads row a + u, pixel
    b + v) and A from the kind's weight image, then the epilogue and its
    stores (the upconv's coarse row y + j to fine row 2 (y + j) + a, pixel
    px to fine column 2 (w0 + px) + b). Sums in float64, one rounding to
    bf16. Asserts the ring protocol: the block's row pairs alternate
    between two warpgroups, each of which frees the rows below its pair's
    end after the pair and the rest of the band at the band's end, in
    order; a slot is loaded only after both have freed its previous row,
    and every row is freed once by each."""
    n_img, h, w, cin = x.shape
    cout = p.b.shape[0]
    halves = cout // 64
    kinds, taps = p.w_wg.shape[:2]
    assert kinds == (4 if up else 1) * halves and taps == (4 if up else 9)
    ns, npx, pitch, slot = _cfg(cin, up)
    strips = -(-w // ns)
    bands = -(-h // band)
    if up:
        oh, ow = 2 * h, 2 * w
    else:
        oh, ow = ((h + 1) // 2, (w + 1) // 2) if pool else (h, w)
    out = torch.full((n_img, oh, ow, cout), float("nan"), dtype=torch.float64)
    xb = x.to(BF).double()
    kks = cin // 16
    b_rel = _b_addr(0, pitch, 128, ns)                  # (16, ns) bytes
    # the producer's 16-byte stores of one row: ci group gi of halo pixel q
    # at gi * pitch + 16 q, 8 bf16 each
    lane_off = (torch.arange(cin // 8).reshape(-1, 1, 1) * pitch
                + torch.arange(npx).reshape(1, -1, 1) * 16) // 2 \
        + torch.arange(8).reshape(1, 1, 8)
    pad = _clamp1 if up else (lambda i, n: _reflect1(min(i, n), n))
    for kind in range(kinds):
        half, (pa, pb) = kind % halves, divmod(kind // halves, 2)
        image = p.w_wg[kind].reshape(-1).double()
        a_all = torch.stack([_a_block(image, tap, kk, cin)[0]
                             for tap in range(taps) for kk in range(kks)])
        # tap -> (ring row offset, pixel shift): conv (r, s); upconv (a + u,
        # b + v)
        offs = [(pa + t // 2, pb + t % 2) if up else (t // 3, t % 3)
                for t in range(taps)]
        bias = p.b[64 * half:64 * half + 64].double().reshape(64, 1)
        ring = torch.zeros(RING * slot // 2, dtype=torch.float64)
        freed, loaded, g, pair = {}, 0, 0, 0
        upto = [0, 0]                   # rows each warpgroup has freed

        def release(wg, end):
            for r in range(upto[wg], end):
                freed[r] = freed.get(r, ()) + (wg,)
            upto[wg] = max(upto[wg], end)

        for it in range(n_img * bands * strips):
            strip, rest = it % strips, it // strips
            y0, n = (rest % bands) * band, rest // bands
            w0 = strip * ns
            np_ = (min(band, h - y0) + 1) // 2

            def load(r):
                gg = g + r
                assert gg < RING or len(freed.get(gg - RING, ())) == 2, "slot in use"
                iy = pad(y0 - 1 + r, h)
                cols = [pad(w0 - 1 + q, w) for q in range(npx)]
                vals = xb[n, iy, cols].reshape(npx, cin // 8, 8).permute(1, 0, 2)
                ring[(gg % RING) * slot // 2 + lane_off] = vals

            for pr in range(np_):
                g0 = g + 2 * pr
                while loaded < 2 * pr + 4:
                    load(loaded)
                    loaded += 1
                bb = torch.stack([
                    torch.stack([
                        ring[(((g0 + j + offs[t][0]) % RING) * slot + 2 * kk * pitch
                              + offs[t][1] * 16 + b_rel) // 2]
                        for t in range(taps) for kk in range(kks)])
                    for j in range(2)])                  # (2, taps kks, 16, ns)
                acc = torch.einsum("tmk,jtkn->jmn", a_all, bb) + bias
                if relu:
                    acc = acc.clamp_min(0)
                release(pair % 2, g0 + 4)
                pair += 1
                yr = y0 + 2 * pr
                co = slice(64 * half, 64 * half + 64)
                if pool:
                    col = w0 + torch.arange(ns)
                    ok = (col < w).reshape(1, 1, ns) & torch.tensor(
                        [True, yr + 1 < h]).reshape(2, 1, 1)
                    m = acc.masked_fill(~ok, float("-inf")).amax(0)
                    m = m.reshape(64, ns // 2, 2).amax(2)             # (co, q)
                    q = min(ns // 2, ow - w0 // 2)
                    out[n, yr // 2, w0 // 2:w0 // 2 + q, co] = m[:, :q].t()
                    continue
                q = min(ns, w - w0)
                for j in range(2):
                    if yr + j >= h:
                        continue
                    if up:
                        out[n, 2 * (yr + j) + pa, 2 * w0 + pb:2 * (w0 + q):2, co] = \
                            acc[j, :, :q].t()
                    else:
                        out[n, yr + j, w0:w0 + q, co] = acc[j, :, :q].t()
            while loaded < 2 * np_ + 2:
                load(loaded)
                loaded += 1
            g += 2 * np_ + 2
            release(0, g)
            release(1, g)
            loaded = 0
        assert sorted(freed) == list(range(g))
        assert all(sorted(v) == [0, 1] for v in freed.values())
    assert not bool(out.isnan().any())
    return out.to(BF)


def model_conv3x3_wg(x, p, relu, pool, band):
    """The conv mode (``conv3x3_wg<COUT, CIN>``, COUT from ``p``)."""
    return _model_wg(x, p, band, False, relu, pool)


def model_upconv_wg(x, p, band):
    """The upconv mode (``upconv_wg<C>``) on the coarse ``x``, bands of
    coarse rows."""
    return _model_wg(x, p, band, True, True, False)


def _hold(got, ref):
    assert got.shape == ref.shape and ref.dtype == BF
    scale = float(ref.float().abs().max())
    assert float((got.float() - ref.float()).abs().max()) <= ONE_ROUNDING * scale


def _input(n, h, w, c, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((n, h, w, c)).astype(np.float32)).to(BF)


# (Cin, N, H, W, relu, pool, band): strips at both image edges, W not a
# multiple of the strip (35, 19, 33 = one past a 32-wide strip), W = 2,
# H = 2 (one row pair) and H = 3 (a pair and a lone last row) with the pool,
# odd H in bands, bands of one pair, and a band of the whole image, whose
# 18 halo rows wrap the 8-slot ring
CASES = [
    (64, 1, 16, 35, True, False, 16), (64, 2, 9, 19, False, False, 4),
    (64, 1, 3, 19, True, True, 4), (64, 1, 2, 2, True, False, 2),
    (64, 1, 16, 35, True, True, 2), (128, 1, 16, 35, True, True, 16),
    (128, 2, 9, 19, False, False, 4), (128, 1, 2, 19, True, True, 2),
    (128, 1, 5, 33, True, True, 6), (128, 1, 3, 35, False, True, 2),
]


@pytest.mark.parametrize("cin,n,h,w,relu,pool,band", CASES)
def test_model_of_the_kernel_matches_plain(cin, n, h, w, relu, pool, band):
    """The conv mode at COUT 128 (the bf16 conv3x3_full)."""
    x = _input(n, h, w, cin, cin + 7 * h + w)
    p = codec.pack(*_weights(cin, h + w))
    _hold(model_conv3x3_wg(x, p, relu, pool, band),
          codec.conv3x3_plain(x, p, relu=relu, pool=pool))


# the conv mode at COUT 64 (one kind: every block takes every item): W one
# past a 64-wide strip (65) and a 32-wide one (33) with a band of the whole
# image (18 halo rows wrap the ring), odd H in bands, H = 2 and 3 with the
# pool, W = 2
P2_CASES = [
    (64, 1, 16, 65, True, True, 16), (64, 2, 9, 19, False, False, 4),
    (64, 1, 3, 19, True, True, 4), (64, 1, 2, 2, True, False, 2),
    (128, 1, 16, 33, True, False, 16), (128, 2, 9, 19, False, True, 4),
    (128, 1, 3, 35, True, True, 2), (128, 1, 5, 33, False, False, 6),
]


@pytest.mark.parametrize("cin,n,h,w,relu,pool,band", P2_CASES)
def test_model_of_the_p2_mode_matches_plain(cin, n, h, w, relu, pool, band):
    """The conv mode at COUT 64 (the bf16 conv3x3_p2)."""
    x = _input(n, h, w, cin, cin + 5 * h + w)
    p = codec.pack(*_weights(cin, 3 * h + w, 64))
    _hold(model_conv3x3_wg(x, p, relu, pool, band),
          codec.conv3x3_plain(x, p, relu=relu, pool=pool))


# (C, N, Hc, Wc, band), coarse: Wc one past a strip (65) with a band of the
# whole image (16 or 12 coarse rows: 18 or 14 halo rows wrap the ring), Hc =
# 1, 2 and 3 (a lone last coarse row), Wc = 1 (fine W = 2), odd sizes in
# bands, two images
UP_CASES = [
    (64, 1, 16, 65, 16), (64, 2, 3, 9, 2), (64, 1, 1, 5, 2), (64, 1, 2, 1, 2),
    (64, 1, 9, 7, 4), (128, 1, 12, 65, 12), (128, 2, 3, 7, 2), (128, 1, 5, 33, 6),
]


@pytest.mark.parametrize("c,n,hc,wc,band", UP_CASES)
def test_model_of_the_upconv_mode_matches_plain(c, n, hc, wc, band):
    """The upconv mode against the bf16 plain upconv (its folded bf16 taps
    on the edge-padded coarse image)."""
    x = _input(n, hc, wc, c, c + 3 * hc + wc)
    p = codec.pack_up(*_weights(c, hc + 5 * wc, c))
    got = model_upconv_wg(x, p, band)
    assert got.shape == (n, 2 * hc, 2 * wc, c)
    _hold(got, codec.conv3x3_plain(x, p, relu=True, up=True))


def _jb(a):
    return jnp.asarray(a, jnp.bfloat16)


def _oihw(w_hwio):
    return torch.from_numpy(w_hwio).to(BF).permute(3, 2, 0, 1)


def _against_jax(model, x, ref):
    """Images 0 and 127 of a B = 128 batch through the model, each within
    one rounding of the JAX kernel's output for it."""
    for i in (0, 127):
        got = model(torch.from_numpy(x[i:i + 1]).to(BF))
        scale = float(np.abs(ref[i]).max())
        assert float(np.abs(got[0].float().numpy() - ref[i]).max()) <= ONE_ROUNDING * scale


def test_model_of_the_kernel_matches_jax_pallas():
    """Images 0 and 127 of a B = 128, 16 x 16, Cin 64 batch: the model
    against JAX's Pallas conv3x3_full (bf16, ReLU) in interpret mode."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((128, 16, 16, 64)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 64, 128)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(128) * 0.1).astype(np.float32)
    wr, bb = jcodec.pack_conv_full(_jb(w), _jb(b))
    ref = np.asarray(jcodec.tcb_to_nhwc(jcodec.conv3x3_full(
        jcodec.nhwc_to_tcb(_jb(x)), wr, bb, relu=True, interpret=True)), np.float32)
    p = codec.pack(_oihw(w), torch.from_numpy(b).to(BF))
    _against_jax(lambda xi: model_conv3x3_wg(xi, p, True, False, 16), x, ref)


def test_model_of_the_p2_mode_matches_jax_pallas():
    """Images 0 and 127 of a B = 128, 16 x 32, Cin 64 batch (the Pallas
    kernel's tiles need W >= 32): the COUT-64 model against JAX's Pallas
    conv3x3_p2 (bf16, ReLU and pool) in interpret mode."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((128, 16, 32, 64)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 64, 64)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(64) * 0.1).astype(np.float32)
    wr, b2 = jcodec.pack_conv_p2(_jb(w), _jb(b))
    ref = np.asarray(jcodec.tcb_to_nhwc(jcodec.conv3x3_p2(
        jcodec.nhwc_to_tcb(_jb(x)), wr, b2, relu=True, pool=True, interpret=True)),
        np.float32)
    p = codec.pack(_oihw(w), torch.from_numpy(b).to(BF))
    _against_jax(lambda xi: model_conv3x3_wg(xi, p, True, True, 16), x, ref)


def test_model_of_the_upconv_mode_matches_jax_pallas():
    """Images 0 and 127 of a B = 128, 8 x 16 coarse, C 64 batch (the Pallas
    kernel's tiles need a fine W >= 32): the upconv model against JAX's
    Pallas upconv_p2 (bf16) in interpret mode."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((128, 8, 16, 64)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 64, 64)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(64) * 0.1).astype(np.float32)
    wa0, wa1, bu = jcodec.pack_upconv_fold(_jb(w), _jb(b))
    ref = np.asarray(jcodec.tcb_to_nhwc(jcodec.upconv_p2(
        jcodec.nhwc_to_tcb(_jb(x)), wa0, wa1, bu, interpret=True)), np.float32)
    p = codec.pack_up(_oihw(w), torch.from_numpy(b).to(BF))
    _against_jax(lambda xi: model_upconv_wg(xi, p, 8), x, ref)
