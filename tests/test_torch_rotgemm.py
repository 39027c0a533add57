"""The cdf/sort step's rotation products (``ops/rotgemm.py``,
``csrc/rotgemm.cu``).

On the CPU: the plain versions are the step's own expressions (the step and
the cdf matcher give the numbers they gave before); the tiling fits every C
the kernels take; a numpy model of the kernel's fragment loads, products and
epilogue, and of its copy walk, gives the product the kernel must give.

On the card (``-m cuda``; this file imports no jax, so
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_rotgemm.py``): the kernels against a float64 product
(within 4x the error of torch.matmul in float32, which a single TF32
product misses), the ranges equal to torch.aminmax, ragged and misaligned
operands, repeated launches bit-equal, and the launches of a cdf stage.
"""

import numpy as np
import pytest
import torch

from optimaltextures_tpu_torch import core, transport
from optimaltextures_tpu_torch.ops import cuda_build, histmatch, rotgemm

# C of the cdf steps: the color tail (3), relu1 (24), relu3 (174), and odd,
# wide and single-channel widths
CS = (1, 3, 24, 67, 174, 256)


def _rot(c: int, seed: int, device="cpu") -> torch.Tensor:
    g = np.random.default_rng(seed).standard_normal((c, c))
    q, r = np.linalg.qr(g)
    return torch.as_tensor(q * np.sign(np.diag(r)), dtype=torch.float32,
                           device=device)


def _cloud(n: int, c: int, seed: int, device="cpu") -> torch.Tensor:
    """(N, C) samples like a PCA-projected feature cloud: channels of
    decreasing spread around a common offset."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c)) * np.linspace(3.0, 0.1, c) + 0.5
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# CPU


@pytest.mark.parametrize("c", CS)
def test_plain_versions_are_the_step_expressions(c):
    n = 1001                      # a multiple of no tile
    x, rot = _cloud(n, c, c), _rot(c, c + 1)
    before = dict(rotgemm.LAUNCHES)
    rows, lo, hi = rotgemm.rotate_rows(x, rot)
    want = rot.T @ x.T
    assert rows.shape == (c, n) and rows.is_contiguous()
    assert torch.equal(rows, want)
    wlo, whi = torch.aminmax(want, dim=1)
    assert torch.equal(lo, wlo) and torch.equal(hi, whi)
    back = rotgemm.unrotate_rows(rows, rot)
    assert back.shape == (n, c) and back.is_contiguous()
    assert torch.equal(back, want.T @ rot.T)
    assert rotgemm.LAUNCHES == before      # plain versions do not count


def test_cdf_match_rows_with_given_ranges_equals_without():
    rng = np.random.default_rng(3)
    t = torch.as_tensor(rng.standard_normal((24, 3001)), dtype=torch.float32)
    s = torch.as_tensor(rng.standard_normal((24, 777)) * 2, dtype=torch.float32)
    want = histmatch.cdf_match_rows(t, s)
    got = histmatch.cdf_match_rows(t, s, t_range=torch.aminmax(t, dim=1),
                                   s_range=torch.aminmax(s, dim=1))
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["cdf", "sort"])
def test_sampled_step_on_cpu_is_the_former_expressions(mode):
    c = 24
    feature = _cloud(2 * 16 * 16, c, 5).reshape(2, 16, 16, c)
    samples, rot = _cloud(500, c, 6), _rot(c, 7)
    got = transport._sampled_step_with_rot(rot, feature, samples, mode)
    rf = rot.T @ feature.reshape(-1, c).T
    rs = rot.T @ samples.T
    matched = (histmatch.cdf_match_rows(rf, rs) if mode == "cdf"
               else histmatch.sort_match_rows(rf, rs))
    assert torch.equal(got, (matched.T @ rot.T).reshape(feature.shape))


def test_wrappers_refuse_bad_operands():
    x, rot = _cloud(10, 4, 0), _rot(4, 1)
    with pytest.raises(ValueError):
        rotgemm.rotate_rows(x, _rot(5, 1))
    with pytest.raises(ValueError):
        rotgemm.unrotate_rows(x, rot)          # (10, 4) rows need a 10 x 10 rot
    with pytest.raises(ValueError):
        rotgemm.rotate_rows(x[:0], rot)
    with pytest.raises(ValueError):
        rotgemm.plan(513, 100, True, 132)


@pytest.mark.parametrize("forward", [True, False])
def test_plan_fits_every_c(forward):
    for c in range(1, rotgemm.MAX_C + 1):
        for n in (1, 5000, 2**25):
            p = rotgemm.plan(c, n, forward, 132)
            assert p.smem == rotgemm.smem_bytes(forward, c, p.nb, p.wg, p.kc,
                                                p.stages) <= rotgemm.SMEM_LIMIT
            assert p.nb in rotgemm.NBS and 8 * p.nb * (-(-c // 8) * 8) <= rotgemm.B_LIMIT
            assert p.slices == -(-c // p.nb) and p.grid % p.slices == 0
            assert p.kc % 8 == 0 and 8 <= p.kc <= 64 and 2 <= p.stages <= 4
            per_sm = 2 if p.smem <= rotgemm.SMEM_TWO and p.nb <= 64 else 1
            assert p.grid <= per_sm * 132
            assert p.grid // p.slices <= max(1, -(-n // (64 * p.wg)))
            # conflict-free A loads: forward sample rows (two apart) at 4 mod
            # 8 floats, back channel rows at 8 mod 16
            assert (p.kc + 4) % 8 == 4 and (64 * p.wg + 8) % 16 == 8
    # the cell's widths: one slice of 24 (two blocks an SM), one of 64 (one
    # block with a deeper ring), two of 88
    for c, nb, slices, grid in ((24, 24, 1, 264), (64, 64, 1, 132),
                                (174, 88, 2, 132)):
        p = rotgemm.plan(c, 2**21, True, 132)
        assert (p.nb, p.slices, p.grid) == (nb, slices, grid)


def _plane_offset(k: int, r: int, nb: int) -> int:
    """A (k, channel r) element's float offset in a rotation plane: the
    kernel's unswizzled K-major core matrices (8 channels x 4 k)."""
    return ((k >> 2) * (nb // 8) + (r >> 3)) * 32 + (r & 7) * 4 + (k & 3)


def _warpgroup_model(forward: bool, nb: int, kp: int, rng):
    """A warpgroup's 64 samples x NB channels in numpy, as the kernel computes
    them: the rotation planes written by the kernel's prologue (forward: the
    k of each 8 in the A fragments' order), A fragments loaded as load_a
    loads them, each wgmma by the PTX layouts of m64nNk8 (warp w holds rows
    16w..16w + 15 of A and D; A: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3
    (g + 8, t + 4); B read from the planes by the descriptor's core
    matrices; D: d[4i + e] at row g + 8 (e >> 1), column 8i + 2t + (e & 1)),
    and the epilogue's (channel, sample). Returns (out (NB, 64), the true
    product (NB, 64))."""
    R = rng.standard_normal((kp, kp))           # the rotation (C = kp here)
    X = rng.standard_normal((64, kp))           # the samples, (N, C)
    want = (R.T @ X.T)[:nb] if forward else (X @ R.T).T[:nb]
    plane = np.zeros(nb * kp)
    for k in range(kp):
        for r in range(nb):
            kk = (k & ~7) | ((k & 3) << 1) | ((k >> 2) & 1) if forward else k
            plane[_plane_offset(k, r, nb)] = R[kk, r] if forward else R[r, kk]
    xs = X if forward else X.T                  # forward [sample][k], back [k][sample]
    acc = np.zeros((4, 32, nb // 2))            # warp, lane, register
    for ks in range(kp // 8):
        A = np.zeros((64, 8))
        for w in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                if forward:
                    v0 = xs[16 * w + 2 * g, 8 * ks + 2 * t:8 * ks + 2 * t + 2]
                    v1 = xs[16 * w + 2 * g + 1, 8 * ks + 2 * t:8 * ks + 2 * t + 2]
                    a = v0[0], v1[0], v0[1], v1[1]
                else:
                    v0 = xs[8 * ks + t, 16 * w + 2 * g:16 * w + 2 * g + 2]
                    v1 = xs[8 * ks + t + 4, 16 * w + 2 * g:16 * w + 2 * g + 2]
                    a = v0[0], v0[1], v1[0], v1[1]
                (A[16 * w + g, t], A[16 * w + g + 8, t], A[16 * w + g, t + 4],
                 A[16 * w + g + 8, t + 4]) = a
        B = np.array([[plane[_plane_offset(8 * ks + l, n, nb)] for n in range(nb)]
                      for l in range(8)])
        D = A @ B
        for w in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for i in range(nb // 8):
                    for e in range(4):
                        acc[w, lane, 4 * i + e] += D[16 * w + g + 8 * (e >> 1),
                                                     8 * i + 2 * t + (e & 1)]
    out = np.full((nb, 64), np.nan)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for i in range(nb // 8):
                for e in range(4):
                    out[8 * i + 2 * t + (e & 1), 16 * w + 2 * g + (e >> 1)] = \
                        acc[w, lane, 4 * i + e]
    return out, want


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("nb,kp", [(8, 8), (24, 24), (16, 32)])
def test_kernel_fragment_model_gives_the_product(forward, nb, kp):
    out, want = _warpgroup_model(forward, nb, kp, np.random.default_rng(kp + nb))
    assert not np.isnan(out).any()         # every (channel, sample) stored once
    np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)


def _copy_walk(outer, inner, v, threads, outer_ok, inner_ok):
    """copy_block's walk: {(o, w): thread} and the zero-filled copies."""
    W, warps = inner // v, threads // 32
    seen, zero = {}, set()

    def copy(tid, o, w):
        assert (o, w) not in seen
        seen[(o, w)] = tid
        if not (o < outer_ok and w * v < inner_ok):
            zero.add((o, w))

    for tid in range(threads):
        lane, warp = tid % 32, tid // 32
        if W <= 32:
            rpw = 32 // W
            lr, w = lane // W, lane % W
            if lr >= rpw:
                continue
            for o in range(warp * rpw + lr, outer, warps * rpw):
                copy(tid, o, w)
        else:
            for o in range(warp, outer, warps):
                for w in range(lane, W, 32):
                    copy(tid, o, w)
    return seen, zero


@pytest.mark.parametrize("outer,inner,v,threads,outer_ok,inner_ok", [
    (128, 24, 4, 256, 128, 24),     # relu1 forward, 16-byte copies
    (128, 32, 2, 256, 37, 22),      # relu3 forward, ragged N, the last chunk past C
    (128, 64, 1, 256, 128, 46),
    (24, 128, 4, 256, 24, 100),     # back, ragged N
    (8, 128, 1, 256, 3, 127),       # back, C = 3
])
def test_copy_walk_covers_each_copy_once(outer, inner, v, threads, outer_ok,
                                         inner_ok):
    seen, zero = _copy_walk(outer, inner, v, threads, outer_ok, inner_ok)
    assert set(seen) == {(o, w) for o in range(outer) for w in range(inner // v)}
    assert zero == {(o, w) for (o, w) in seen
                    if o >= outer_ok or w * v >= inner_ok}


@pytest.mark.parametrize("name", [*cuda_build.RUN_LIBRARIES, "conv64"])
def test_first_load_of_a_run_library_builds_them_together(name, monkeypatch):
    """The first load of any of a run's libraries builds all of them in one
    parallel batch (the rotation kernels among them); another library
    builds alone."""
    calls, opened = [], []
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build, "build", lambda *names: calls.append(
        names) or [f"lib{n}.so" for n in names])
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", opened.append)
    cuda_build.load(name)
    cuda_build.load(name)
    assert "rotgemm" in cuda_build.RUN_LIBRARIES
    assert calls == [cuda_build.RUN_LIBRARIES if name != "conv64" else (name,)]
    assert opened == [f"lib{name}.so"]


# ---------------------------------------------------------------------------
# the card


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels do not run on the CPU")
    core.full_f32_precision()


def _rel_rms(got, ref64):
    return float(torch.linalg.vector_norm(got.double() - ref64)
                 / torch.linalg.vector_norm(ref64))


# the last pass's shapes of bf16-b128-cdf (batch 128, 512 px) at the PCA
# widths its traced calls take most: relu1 (C 25, 128 x 512^2 samples; 2^22
# here, the error does not depend on N), relu2 (C 75: the staged back
# store), relu3 (C 177: 96-channel slices; 128 x 128^2), and relu3 at C 174
# (88-channel slices)
CELL_SHAPES = [(25, 2**22), (75, 2**22), (177, 2**21), (174, 2**21)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,n", CELL_SHAPES)
def test_products_are_f32_accurate(c, n):
    """Relative RMS error against a float64 product at most 4x that of
    torch.matmul in float32 (TF32 off); a single TF32 product fails it."""
    _need_gpu()
    x, rot = _cloud(n, c, c, "cuda"), _rot(c, c + 1, "cuda")
    want = (rot.double().T @ x.double().T)
    rows, _, _ = rotgemm.rotate_rows(x, rot)
    back = rotgemm.unrotate_rows(rows, rot)
    want_back = rows.double().T @ rot.double().T
    lib_f = _rel_rms(rot.T @ x.T, want)
    lib_b = _rel_rms(rows.T @ rot.T, want_back)
    got_f, got_b = _rel_rms(rows, want), _rel_rms(back, want_back)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_f = _rel_rms(rot.T @ x.T, want)
        tf32_b = _rel_rms(rows.T @ rot.T, want_back)
    finally:
        core.full_f32_precision()
    print(f"C {c} N {n}: forward {got_f:.3e} (matmul f32 {lib_f:.3e}, tf32 "
          f"{tf32_f:.3e}); back {got_b:.3e} ({lib_b:.3e}, {tf32_b:.3e})")
    assert got_f <= 4 * lib_f and got_b <= 4 * lib_b
    assert tf32_f > 4 * lib_f and tf32_b > 4 * lib_b


# widths and ragged sample counts the tiling must take: one channel, the
# color tail, odd, the cell's (two slices of 88, and of 96 past 176), four
# slices, sixteen
@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 24, 25, 67, 174, 180, 256, 512])
@pytest.mark.parametrize("n", [1, 7, 1001, 70001])
def test_kernels_match_plain_with_exact_ranges(c, n):
    _need_gpu()
    x, rot = _cloud(n, c, c + n, "cuda"), _rot(c, c, "cuda")
    before = dict(rotgemm.LAUNCHES)
    rows, lo, hi = rotgemm.rotate_rows(x, rot)
    back = rotgemm.unrotate_rows(rows, rot)
    torch.cuda.synchronize()
    assert rotgemm.LAUNCHES["rotate_rows"] == before["rotate_rows"] + 1
    assert rotgemm.LAUNCHES["unrotate_rows"] == before["unrotate_rows"] + 1
    assert rows.shape == (c, n) and back.shape == (n, c)
    want = (rot.double().T @ x.double().T)
    assert _rel_rms(rows, want) < 1e-5
    assert _rel_rms(back, rows.double().T @ rot.double().T) < 1e-5
    wlo, whi = torch.aminmax(rows, dim=1)
    assert torch.equal(lo, wlo) and torch.equal(hi, whi)


@pytest.mark.cuda
@pytest.mark.parametrize("c,n", [(24, 4099), (174, 1003), (6, 4096)])
def test_misaligned_operands(c, n):
    """Views whose base is 4 bytes past 16-byte alignment take the 4- and
    8-byte copies; the result equals the aligned one's bit for bit."""
    _need_gpu()
    rot = _rot(c, 9, "cuda")
    buf = torch.empty(n * c + 1, device="cuda")
    x = buf[1:].view(n, c)
    x.copy_(_cloud(n, c, 2, "cuda"))
    rows, lo, hi = rotgemm.rotate_rows(x, rot)
    rows_a, lo_a, hi_a = rotgemm.rotate_rows(x.clone(), rot)
    assert torch.equal(rows, rows_a) and torch.equal(lo, lo_a)
    assert torch.equal(hi, hi_a)
    rbuf = torch.empty(n * c + 1, device="cuda")
    r = rbuf[1:].view(c, n)
    r.copy_(rows)
    assert torch.equal(rotgemm.unrotate_rows(r, rot),
                       rotgemm.unrotate_rows(rows, rot))


@pytest.mark.cuda
def test_nan_rows_read_nan_ranges():
    _need_gpu()
    c, n = 24, 5000
    x, rot = _cloud(n, c, 1, "cuda"), _rot(c, 2, "cuda")
    x[1234, 5] = float("nan")
    rows, lo, hi = rotgemm.rotate_rows(x, rot)
    wlo, whi = torch.aminmax(rows, dim=1)
    assert torch.isnan(lo).all() and torch.isnan(hi).all()
    assert torch.isnan(wlo).all() and torch.isnan(whi).all()


@pytest.mark.cuda
@pytest.mark.parametrize("c,n", CELL_SHAPES)
def test_repeated_launches_bit_equal(c, n):
    _need_gpu()
    x, rot = _cloud(n, c, 4, "cuda"), _rot(c, 5, "cuda")
    rows, lo, hi = rotgemm.rotate_rows(x, rot)
    back = rotgemm.unrotate_rows(rows, rot)
    for _ in range(20):
        r2, l2, h2 = rotgemm.rotate_rows(x, rot)
        assert torch.equal(r2, rows) and torch.equal(l2, lo) and torch.equal(h2, hi)
        assert torch.equal(rotgemm.unrotate_rows(rows, rot), back)


@pytest.mark.cuda
def test_a_cdf_stage_launches_two_forward_and_one_back_a_step():
    _need_gpu()
    c = 24
    feature = _cloud(2 * 64 * 64, c, 8, "cuda").reshape(2, 64, 64, c)
    stats = transport.StyleStats(mu=None, cov_raw=None,
                                 samples=_cloud(64 * 64, c, 9, "cuda"))
    gen = torch.Generator(device="cuda").manual_seed(3)
    rotgemm.reset_launches()
    out = transport.transport_loop(gen, feature, stats, 5, "cdf")
    torch.cuda.synchronize()
    assert rotgemm.LAUNCHES == {"rotate_rows": 10, "unrotate_rows": 5}
    assert out.shape == feature.shape and torch.isfinite(out).all()
