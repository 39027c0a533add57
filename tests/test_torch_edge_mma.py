"""The bf16 narrow convs on mma.sync (``csrc/edge_mma.cu``), on the CPU.

``rgb_to_relu1_mma`` (3 -> 64 + ReLU) and ``final_to_rgb_mma`` (64 -> 3,
the next renorm folded in) cannot run here, so their addressing is
modelled in torch with the kernels' own formulas:

* ``codec.pack`` fills ``w_edge`` (the m16n8k16 B fragments in lane order,
  ``codec.pack_edge``) for bf16 (3, 64) and (64, 3) convs only; read back
  through a lane's registers (b0: k = 16 s + 2 t, + 1; b1: + 8, + 9; column
  8 j + g) it is the HWIO weights (``pack_final``'s folded ones for the
  final conv), with exact zeros past k = 26 (entry) or column 26 (final).
* A model of ``rgb_to_relu1_mma``: the tiles' halos as the kernel fetches
  them (reflect resolved, rows and columns past the image clamped, rounded
  to bf16, [ci][row][col]), each lane's A gathered at its 8 precomputed
  halo offsets plus the pixel offset, the k >= 27 values the constant 0,
  f32 products of bf16-exact values, the f32 bias, ReLU, one rounding.
* A model of ``final_to_rgb_mma``: the TMA box (zeros outside the image)
  with the reflect repaired in shared memory (columns, then rows), the 21
  m16 tiles of 16 consecutive halo pixels (the padding rows clamped to
  pixel 323, never stored) times B into Z[j][p], then the shift-sum in the
  kernel's order (the bias, then taps 0 .. 8).

Both models are held against the bf16 plain versions at ragged sizes and
against JAX's interpret-mode Pallas kernels (B = 128, as
tests/test_torch_bf16.py runs them), within one bf16 rounding (2^-7 x
max|ref|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimaltextures_tpu.ops.pallas import codec as jcodec
from optimaltextures_tpu_torch.ops import codec

BF = torch.bfloat16
ONE_ROUNDING = 2.0 ** -7
TILE, HALO = 16, 18
HALO_PX = HALO * HALO          # 324
M_TILES = (HALO_PX + 15) // 16  # 21


def _reflect1(i, n):
    i = -i if i < 0 else i
    return 2 * n - 2 - i if i >= n else i


def _weights(cin, cout, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(0, 0.1, (cout, cin, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32))
    return w.to(BF), b.to(BF)


def _renorm(seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(0, 0.5, (3, 3, 1, 1)).astype(np.float32)).to(BF),
            torch.from_numpy(rng.normal(0, 0.1, 3).astype(np.float32)).to(BF))


def _read_b(w_edge):
    """The (16 KS, 8 NT) B matrix a warp's registers hold, read from the
    fragments with the kernel's formulas (``load_b``: the 16 bytes of (s,
    jp, lane) are b0, b1 of n8 tile 2 jp, then of 2 jp + 1), each element
    once."""
    ks, njp = w_edge.shape[:2]
    regs = w_edge.reshape(ks, njp, 32, 2, 2, 2)     # (s, jp, lane, jj, reg, half)
    out = torch.zeros((16 * ks, 16 * njp), dtype=BF)
    seen = torch.zeros(out.shape, dtype=torch.int32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for s in range(ks):
            for jp in range(njp):
                for jj in range(2):
                    n = 8 * (2 * jp + jj) + g
                    for r in range(2):                  # b0: k 2t, b1: k 2t + 8
                        for e in range(2):              # the register's low, high half
                            k = 16 * s + 8 * r + 2 * t + e
                            out[k, n] = regs[s, jp, lane, jj, r, e]
                            seen[k, n] += 1
    assert bool((seen == 1).all())
    return out


# --- the packing ---------------------------------------------------------------

@pytest.mark.parametrize("cin,cout,dtype,edge", [
    (3, 64, BF, True), (64, 3, BF, True), (3, 64, torch.float32, False),
    (64, 3, torch.float32, False), (64, 64, BF, False)])
def test_pack_fills_w_edge_for_bf16_narrow_convs(cin, cout, dtype, edge):
    """w_edge for a bf16 3 -> 64 or 64 -> 3 conv, (K/16, N/16, 32, 8) bf16;
    None in f32 (the FFMA kernels take w_hwio) and for the wide convs
    (w_wg)."""
    w, b = _weights(cin, cout, cin + cout)
    p = codec.pack(w.to(dtype), b.to(dtype))
    if not edge:
        assert p.w_edge is None
        return
    assert p.w_edge.dtype == BF
    assert tuple(p.w_edge.shape) == ((2, 4, 32, 8) if cout == 64 else (4, 2, 32, 8))
    assert p.w_wg is None and p.w_tc is None


@pytest.mark.parametrize("which", ["entry", "final", "final_folded"])
def test_w_edge_reads_back_as_the_weights(which):
    """Through the kernels' lane and register formulas the fragments are
    B[3 tap + ci][co] (entry) or B[ci][3 tap + co] (final; pack_final's
    folded weights), tap = 3 kh + kw, with exact zeros in the padding."""
    if which == "entry":
        w, b = _weights(3, 64, 1)
        p = codec.pack(w, b)
    else:
        w, b = _weights(64, 3, 2)
        p = codec.pack_final(w, b, _renorm(3) if which == "final_folded" else None)
    bmat = _read_b(p.w_edge)
    hwio = p.w.permute(2, 3, 1, 0)                      # the (folded) bf16 weights
    for kh in range(3):
        for kw in range(3):
            tap = 3 * kh + kw
            if which == "entry":
                got = bmat[3 * tap:3 * tap + 3, :]      # (ci, co)
            else:
                got = bmat[:, 3 * tap:3 * tap + 3]      # (ci, co)
            assert torch.equal(got, hwio[kh, kw])
    pad = bmat[27:] if which == "entry" else bmat[:, 27:]
    assert bool((pad == 0).all()) and not bool(pad.float().signbit().any())


# --- the kernel models -----------------------------------------------------------

def _entry_a_index():
    """(16, 32) halo offsets of the A operand of one m16 tile at tile row 0,
    from each lane's gather (``koff`` + the pixel offset g + 8 rr); -1 where
    the kernel writes the constant 0 (k >= 27)."""
    idx = torch.full((16, 32), -2, dtype=torch.long)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for s in range(2):
            for h in range(2):
                for e in range(2):
                    k = 16 * s + 8 * h + 2 * t + e
                    tap = k // 3
                    koff = (k % 3) * HALO_PX + (tap // 3) * HALO + tap % 3 if k < 27 else -1
                    for rr in range(2):
                        row = g + 8 * rr
                        assert idx[row, k] == -2
                        idx[row, k] = koff + row if koff >= 0 else -1
    assert bool((idx != -2).all())
    # the constant zeros are exactly k >= 27; the reads stay in the halo
    assert bool(((idx < 0) == (torch.arange(32) >= 27)).all())
    assert int(idx.max()) + 15 * HALO < 3 * HALO_PX
    return idx


def _tiles(n, h, w):
    return [(i, ty, tx) for i in range(n) for ty in range((h + TILE - 1) // TILE)
            for tx in range((w + TILE - 1) // TILE)]


def model_rgb_to_relu1_mma(x, p):
    """x (N, H, W, 3) f32 -> (N, H, W, 64) bf16, as rgb_to_relu1_mma
    computes it."""
    n, h, w, _ = x.shape
    idx = _entry_a_index()
    bmat = _read_b(p.w_edge).float()                    # (32, 64)
    y = torch.zeros((n, h, w, 64), dtype=BF)
    rows = torch.arange(HALO)
    for i, ty, tx in _tiles(n, h, w):
        y0, x0 = TILE * ty, TILE * tx
        gy = [_reflect1(min(y0 + r - 1, h), h) for r in rows.tolist()]
        gx = [_reflect1(min(x0 + c - 1, w), w) for c in rows.tolist()]
        halo = x[i][gy][:, gx].permute(2, 0, 1).reshape(-1)   # [ci][row][col]
        halo = halo.to(BF).float()                      # rounded as it is staged
        # A of tile row r: the offsets plus r * 18; the constant zeros
        a_idx = idx[None] + HALO * torch.arange(TILE)[:, None, None]
        a = torch.where(idx[None] >= 0, halo[a_idx.clamp(min=0)], torch.zeros(()))
        c = a.reshape(TILE * TILE, 32) @ bmat           # f32 products of bf16 values
        out = torch.relu(c + p.b).to(BF).reshape(TILE, TILE, 64)
        hh, ww = min(TILE, h - y0), min(TILE, w - x0)
        y[i, y0:y0 + hh, x0:x0 + ww] = out[:hh, :ww]
    return y


def _final_box(x, i, y0, x0):
    """The 18 x 18 x 64 box TMA lands for tile (y0, x0) of image i (zeros
    outside the image), the reflect then repaired as the kernel does it:
    halo columns, then whole rows."""
    _, h, w, c = x.shape
    box = torch.zeros((HALO, HALO, c), dtype=x.dtype)
    ys, xs = max(y0 - 1, 0), max(x0 - 1, 0)
    ye, xe = min(y0 + TILE + 1, h), min(x0 + TILE + 1, w)
    box[ys - y0 + 1:ye - y0 + 1, xs - x0 + 1:xe - x0 + 1] = x[i, ys:ye, xs:xe]
    if x0 == 0:
        box[:, 0] = box[:, 2]
    if x0 + TILE >= w:
        box[:, w - x0 + 1] = box[:, w - x0 - 1]
    if y0 == 0:
        box[0] = box[2]
    if y0 + TILE >= h:
        box[h - y0 + 1] = box[h - y0 - 1]
    return box.reshape(HALO_PX, c)


def model_final_to_rgb_mma(x, p):
    """x (N, H, W, 64) bf16 -> (N, H, W, 3) f32, as final_to_rgb_mma
    computes it."""
    n, h, w, _ = x.shape
    bmat = _read_b(p.w_edge).float()                    # (64, 32)
    # the 21 m16 tiles' rows: 16 consecutive halo pixels, padding clamped
    rows = torch.arange(16 * M_TILES).clamp(max=HALO_PX - 1)
    oy, ox = torch.meshgrid(torch.arange(TILE), torch.arange(TILE), indexing="ij")
    y = torch.zeros((n, h, w, 3), dtype=torch.float32)
    for i, ty, tx in _tiles(n, h, w):
        y0, x0 = TILE * ty, TILE * tx
        a = _final_box(x, i, y0, x0).float()[rows]      # (336, 64)
        z = (a @ bmat)[:HALO_PX, :27].t()               # Z[j][p]; padding never stored
        s = p.b[None, None, :].expand(TILE, TILE, 3).clone()
        for tap in range(9):
            q = (oy + tap // 3) * HALO + ox + tap % 3
            s = s + z[3 * tap:3 * tap + 3][:, q].permute(1, 2, 0)
        hh, ww = min(TILE, h - y0), min(TILE, w - x0)
        y[i, y0:y0 + hh, x0:x0 + ww] = s[:hh, :ww]
    return y


def _hold(got, ref):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    assert err <= ONE_ROUNDING * scale, (err, scale)


def _input(shape, seed, wide):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=shape).astype(np.float32)
    if wide:   # magnitudes over 1e-3 .. 1e3, both signs
        mag = 10.0 ** rng.uniform(-3, 3, size=shape)
        x = np.where(x < 0.5, -mag, mag).astype(np.float32)
    return torch.from_numpy(x)


# sizes: one pixel past a tile, H = 2, W = 2, both, a whole tile, batch 1-3
SIZES = [(1, 17, 33, False), (2, 2, 37, True), (3, 45, 2, False), (2, 33, 17, True),
         (1, 2, 2, False), (3, 16, 16, True)]


@pytest.mark.parametrize("n,h,w,wide", SIZES)
def test_model_of_rgb_to_relu1_mma_matches_plain(n, h, w, wide):
    wt, b = _weights(3, 64, n + h + w)
    p = codec.pack(wt, b)
    x = _input((n, h, w, 3), 7 * h + w, wide)
    got = model_rgb_to_relu1_mma(x, p)
    ref = codec.conv3x3_plain(x, p, relu=True)
    assert got.dtype == ref.dtype == BF
    _hold(got, ref)


@pytest.mark.parametrize("n,h,w,wide", SIZES)
def test_model_of_final_to_rgb_mma_matches_plain(n, h, w, wide):
    wt, b = _weights(64, 3, n + h + w)
    p = codec.pack_final(wt, b, _renorm(h))
    x = _input((n, h, w, 64), 5 * h + w, wide).to(BF)
    got = model_final_to_rgb_mma(x, p)
    ref = codec.conv3x3_plain(x, p, out_dtype=torch.float32)
    assert got.dtype == ref.dtype == torch.float32
    _hold(got, ref)


# --- the models against the Pallas kernels -------------------------------------

B, H, W = 128, 16, 32


def _jbf(a):
    return jnp.asarray(np.array(a, np.float32), jnp.bfloat16)


def _oihw(w_hwio):
    return torch.from_numpy(np.asarray(w_hwio, np.float32).transpose(3, 2, 0, 1).copy()).to(BF)


def _f32(a):
    return np.array(jnp.asarray(a, jnp.float32))


def test_model_of_rgb_to_relu1_mma_matches_pallas():
    """The entry model against ops/pallas/codec.py:578 rgb_to_relu1 in
    interpret mode (bf16 weights, f32 RGB in, bf16 out) on the same numpy
    inputs."""
    rng = np.random.default_rng(13)
    rgb = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    we = rng.normal(0, 0.1, (3, 3, 3, 64)).astype(np.float32)
    be = rng.normal(0, 0.1, 64).astype(np.float32)
    rgb8 = jnp.pad(jnp.asarray(rgb), ((0, 0),) * 3 + ((0, 5),))
    jw, jb = jcodec.pack_entry_rgb(_jbf(we), _jbf(be))
    ref = jcodec.tcb_to_nhwc(jcodec.rgb_to_relu1(
        jcodec.nhwc_to_tcb(rgb8), jw, jb, out_dtype=jnp.bfloat16, interpret=True))
    got = model_rgb_to_relu1_mma(torch.from_numpy(rgb),
                                 codec.pack(_oihw(we), torch.from_numpy(be).to(BF)))
    _hold(got, torch.from_numpy(_f32(ref)))


def test_model_of_final_to_rgb_mma_matches_pallas():
    """The final model against ops/pallas/codec.py:515 final_to_rgb in
    interpret mode, both with the renorm folded in by their own packers
    (pack_final_rgb, pack_final), on the same numpy inputs."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((B, H, W, 64)).astype(np.float32)
    wf = rng.normal(0, 0.1, (3, 3, 64, 3)).astype(np.float32)
    bf = rng.normal(0, 0.1, 3).astype(np.float32)
    wrn = rng.normal(0, 0.5, (1, 1, 3, 3)).astype(np.float32)
    brn = rng.normal(0, 0.1, 3).astype(np.float32)
    w3, b3 = jcodec.pack_final_rgb(_jbf(wf), _jbf(bf), _jbf(wrn), _jbf(brn))
    ref = jcodec.tcb_to_nhwc(jcodec.final_to_rgb(
        jcodec.nhwc_to_tcb(_jbf(x)), w3, b3, interpret=True))[..., :3]
    bfl = lambda a: torch.from_numpy(a).to(BF)
    p = codec.pack_final(_oihw(wf), bfl(bf), (_oihw(wrn), bfl(brn)))
    got = model_final_to_rgb_mma(bfl(x), p)
    _hold(got, torch.from_numpy(_f32(ref)))
