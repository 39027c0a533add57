"""The bf16 ``conv3x3_full`` wgmma kernel's layouts, on the CPU.

``csrc/conv_wg.cu`` cannot run here, so its addressing is modelled in torch
with the kernel's own formulas:

* ``codec.pack_wg`` (the A operand, one co half's weights as they lie in
  shared memory) read back through the 128-byte-swizzled K-major
  descriptor (the swizzle applied to the address bits, as the hardware
  does) rebuilds the bf16 HWIO weights bit for bit; ``codec.pack`` fills it
  for bf16 Cout-128 weights only.
* A model of the whole kernel: the producer's halo rows (reflect per row and
  per pixel, ring slot g % 8, the group pitch), each tap's B operand formed
  from the unswizzled descriptor's (start, LBO, SBO) over the flat ring,
  the K loop, bias, ReLU and the pool as the epilogue computes them, the
  strips, bands and stores, and the ring's releases (every halo row freed
  once by each consumer warpgroup, in order, before its slot is loaded
  again). Held against the
  bf16 plain version, and once against JAX's Pallas ``conv3x3_full`` in
  interpret mode, within one bf16 rounding (2^-7 x max|ref|).
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


def _cfg(cin):
    """(strip width NS, halo pixels a row, group pitch, slot bytes) as
    ``Cfg<CIN, NS>`` sets them."""
    ns = 64 if cin == 64 else 32
    px = ns + 2
    pitch = (px if px % 2 else px + 1) * 16
    return ns, px, pitch, cin // 8 * pitch


def _reflect1(i, n):
    i = -i if i < 0 else i
    return 2 * n - 2 - i if i >= n else i


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


def _weights(cin, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(0, 0.1, (128, cin, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, 128).astype(np.float32))
    return w.to(BF), b.to(BF)


# --- the weight image --------------------------------------------------------

@pytest.mark.parametrize("half", [0, 1])
@pytest.mark.parametrize("cin", [64, 128])
def test_pack_wg_reads_back_as_the_weights(cin, half):
    """Every A operand the kernel reads (tap, k16 step kk: block tap * Cin/64
    + kk / 4, start + 32 (kk % 4) bytes) is W[r, s, 16 kk:16 kk + 16,
    64 half:64 half + 64] transposed, bit for bit, and together they cover
    the image."""
    w, b = _weights(cin, cin + half)
    p = codec.pack(w, b)
    assert p.w_wg.shape == (2, 9, cin // 64, 64, 64) and p.w_wg.dtype == BF
    image = p.w_wg[half].reshape(-1)          # the shared-memory bytes / 2
    hwio = w.permute(2, 3, 1, 0)
    seen = torch.zeros(image.numel(), dtype=torch.bool)
    for tap in range(9):
        for kk in range(cin // 16):
            start = (tap * (cin // 64) + kk // 4) * BLOCK + (kk % 4) * 32
            addr = _a_addr(start)
            a = image[addr // 2]
            want = hwio[tap // 3, tap % 3, 16 * kk:16 * kk + 16,
                        64 * half:64 * half + 64].t()
            assert torch.equal(a.view(torch.int16), want.contiguous().view(torch.int16))
            seen[addr.reshape(-1) // 2] = True
    assert bool(seen.all())


@pytest.mark.parametrize("cout,cin,dtype,field", [
    (128, 64, BF, "w_wg"), (128, 128, BF, "w_wg"), (64, 64, BF, "w_tc"),
    (64, 128, BF, "w_tc"), (128, 64, torch.float32, "w_tc"),
    (128, 128, torch.float32, "w_tc"), (64, 3, BF, None), (3, 64, BF, None)])
def test_pack_fills_w_wg_only_for_bf16_cout_128(cout, cin, dtype, field):
    """bf16 64|128 -> 128 weights carry the wgmma image and no fragments;
    every other tensor-core conv carries fragments; the narrow convs
    neither. ``pack_wg`` refuses what the kernel does not take."""
    p = codec.pack(torch.zeros(cout, cin, 3, 3, dtype=dtype),
                   torch.zeros(cout, dtype=dtype))
    assert (p.w_wg is not None) == (field == "w_wg")
    assert (p.w_tc is not None) == (field == "w_tc")
    if field != "w_wg":
        with pytest.raises(ValueError):
            codec.pack_wg(p.w.permute(2, 3, 1, 0))


# --- a model of the kernel ---------------------------------------------------

def model_conv3x3_wg(x, p, relu, pool, band):
    """What ``conv3x3_wg`` computes, step by step with its formulas: per co
    half, the items (image, band, strip) in order, the producer's rows into
    ring slot g % 8 (reflect per row and per pixel, 16 bytes a ci group at
    group pitch), each pair's K loop over B operands formed from the
    unswizzled descriptor (start slot(row + r) + 2 kk pitch + 16 s, LBO =
    pitch, SBO = 128) and A from the weight image, then the epilogue. Sums
    in float64, one rounding to bf16. Asserts the ring protocol: the
    block's row pairs alternate between two warpgroups, each of which frees
    the rows below its pair's end after the pair and the rest of the band
    at the band's end, in order; a slot is loaded only after both have
    freed its previous row, and every row is freed once by each."""
    n_img, h, w, cin = x.shape
    ns, npx, pitch, slot = _cfg(cin)
    strips = -(-w // ns)
    bands = -(-h // band)
    oh, ow = ((h + 1) // 2, (w + 1) // 2) if pool else (h, w)
    out = torch.full((n_img, oh, ow, 128), float("nan"), dtype=torch.float64)
    xb = x.to(BF).double()
    kks = cin // 16
    b_rel = _b_addr(0, pitch, 128, ns)                  # (16, ns) bytes
    for half in range(2):
        image = p.w_wg[half].reshape(-1).double()
        a_all = torch.stack([
            image[_a_addr((tap * (cin // 64) + kk // 4) * BLOCK + (kk % 4) * 32) // 2]
            for tap in range(9) for kk in range(kks)])   # (9 kks, 64, 16)
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
                iy = _reflect1(min(y0 - 1 + r, h), h)
                cols = [_reflect1(min(w0 - 1 + q, w), w) for q in range(npx)]
                base = (gg % RING) * slot
                for gi in range(cin // 8):
                    for q, ix in enumerate(cols):
                        o = (base + gi * pitch + q * 16) // 2
                        ring[o:o + 8] = xb[n, iy, ix, 8 * gi:8 * gi + 8]

            for pr in range(np_):
                g0 = g + 2 * pr
                while loaded < 2 * pr + 4:
                    load(loaded)
                    loaded += 1
                bb = torch.stack([
                    torch.stack([
                        ring[(((g0 + j + tap // 3) % RING) * slot + 2 * kk * pitch
                              + (tap % 3) * 16 + b_rel) // 2]
                        for tap in range(9) for kk in range(kks)])
                    for j in range(2)])                  # (2, 9 kks, 16, ns)
                acc = torch.einsum("tmk,jtkn->jmn", a_all, bb) + bias
                if relu:
                    acc = acc.clamp_min(0)
                release(pair % 2, g0 + 4)
                pair += 1
                yr = y0 + 2 * pr
                if pool:
                    col = w0 + torch.arange(ns)
                    ok = (col < w).reshape(1, 1, ns) & torch.tensor(
                        [True, yr + 1 < h]).reshape(2, 1, 1)
                    m = acc.masked_fill(~ok, float("-inf")).amax(0)
                    m = m.reshape(64, ns // 2, 2).amax(2)             # (co, q)
                    q = min(ns // 2, ow - w0 // 2)
                    out[n, yr // 2, w0 // 2:w0 // 2 + q, 64 * half:64 * half + 64] = \
                        m[:, :q].t()
                else:
                    q = min(ns, ow - w0)
                    for j in range(2):
                        if yr + j < h:
                            out[n, yr + j, w0:w0 + q, 64 * half:64 * half + 64] = \
                                acc[j, :, :q].t()
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
    rng = np.random.default_rng(cin + 7 * h + w)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin)).astype(np.float32)).to(BF)
    p = codec.pack(*_weights(cin, h + w))
    got = model_conv3x3_wg(x, p, relu, pool, band)
    ref = codec.conv3x3_plain(x, p, relu=relu, pool=pool)
    assert got.shape == ref.shape and ref.dtype == BF
    scale = float(ref.float().abs().max())
    assert float((got.float() - ref.float()).abs().max()) <= ONE_ROUNDING * scale


def test_model_of_the_kernel_matches_jax_pallas():
    """Images 0 and 127 of a B = 128, 16 x 16, Cin 64 batch: the model
    against JAX's Pallas conv3x3_full (bf16, ReLU) in interpret mode."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((128, 16, 16, 64)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 64, 128)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(128) * 0.1).astype(np.float32)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    wr, bb = jcodec.pack_conv_full(jb(w), jb(b))
    ref = np.asarray(jcodec.tcb_to_nhwc(jcodec.conv3x3_full(
        jcodec.nhwc_to_tcb(jb(x)), wr, bb, relu=True, interpret=True)), np.float32)
    p = codec.pack(torch.from_numpy(w).to(BF).permute(3, 2, 0, 1),
                   torch.from_numpy(b).to(BF))
    for i in (0, 127):
        got = model_conv3x3_wg(torch.from_numpy(x[i:i + 1]).to(BF), p, True, False, 16)
        scale = float(np.abs(ref[i]).max())
        assert float(np.abs(got[0].float().numpy() - ref[i]).max()) <= ONE_ROUNDING * scale
