"""Kernel 8, the legacy fused cdf apply, as it is laid out for the card
(``csrc/cdf.cu`` ``cdf_segments``), on the CPU: a torch model of the
kernel, step for step, held bit for bit against ``cdf.cdf_remap_plain``.

The model builds a block's tables as the kernel does (the cdfs by 32-wide
inclusive scans plus the prefix of the 8 warp totals, the right edges, the
remap table by an 8-step binary search, the segment table ``(slope, edge,
value, previous edge)``), then maps each sample through its guessed segment
``clip(ceil((x - lo) / step_safe) - 1, 0, 255)``, verified against the
edges around it, with the binary search where the check fails. Its index
must be ``min(#(edges < x), 255)`` (``torch.searchsorted``, clipped) on
every sample, and its output the plain version's, on ordinary rows, a
constant channel, a top-edge pile, samples on and one ulp either side of
every edge, rows whose f32 edges collapse, and out-of-range samples. The
kernel itself runs only on a GPU (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from optimaltextures_tpu.ops.pallas.cdf_remap import cdf_remap as jcdf_remap
from optimaltextures_tpu_torch.ops import cdf

BINS, WARP = 256, 32


def _search(x, xp):
    """The kernel's search256: min(#(xp < x), 255) on non-decreasing rows,
    by 8 halving steps (x (C, Q), xp (C, 256))."""
    i = torch.zeros(x.shape, dtype=torch.int64)
    step = BINS // 2
    while step:
        i = i + step * (torch.gather(xp, 1, i + step - 1) < x)
        step //= 2
    return i


def _lerp_fallback(x, slope, xp_i, fp_i, xp_n, fp_n):
    f0 = slope * (x - xp_i) + fp_i
    f1 = slope * (x - xp_n) + fp_n
    return torch.where(torch.isfinite(f0), f0,
                       torch.where(torch.isfinite(f1), f1, fp_i))


def _scan_as_kernel(h):
    """Inclusive cdf counts and the total, in the kernel's order: a
    Hillis-Steele scan within each 32-bin warp, then the warp totals before
    it added one by one; the total is the 8 warp totals summed in order."""
    c = h.shape[0]
    w = h.reshape(c, BINS // WARP, WARP).clone()
    off = 1
    while off < WARP:
        shifted = torch.zeros_like(w)
        shifted[..., off:] = w[..., :-off]
        w = w + shifted
        off *= 2
    totals = w[..., -1]
    prefix = torch.zeros_like(totals)
    total = torch.zeros(c, dtype=h.dtype)
    for k in range(BINS // WARP):
        prefix[:, k + 1:] = prefix[:, k + 1:] + totals[:, k:k + 1]
        total = total + totals[:, k]
    return (w + prefix[..., None]).reshape(c, BINS), total


def kernel_model(t, t_hist, s_hist, lo, hi):
    """The kernel on (C, N) rows -> (output, segment index, guess hit)."""
    c = t.shape[0]
    tc, t_total = _scan_as_kernel(t_hist)
    sc, s_total = _scan_as_kernel(s_hist)
    t_cdf = tc / t_total[:, None]
    s_cdf = sc / s_total[:, None]
    width = hi - lo
    step = width / 256.0
    j1 = torch.arange(1, BINS + 1, dtype=torch.float32)
    edges = torch.where((width > 0)[:, None], lo[:, None] + j1 * step[:, None],
                        lo[:, None].expand(c, BINS))
    # remapped[j] = interp(t_cdf[j]; s_cdf -> edges), one binary search a bin
    i = _search(t_cdf, s_cdf)
    nx = (i + 1).clamp(max=BINS - 1)
    g = lambda a, k: torch.gather(a, 1, k)
    slope = (g(edges, nx) - g(edges, i)) / (g(s_cdf, nx) - g(s_cdf, i))
    remapped = _lerp_fallback(t_cdf, slope, g(s_cdf, i), g(edges, i),
                              g(s_cdf, nx), g(edges, nx))
    # the segment table: (slope_j, edges[j], remapped[j], edges[j-1] or -inf)
    jn = (torch.arange(BINS) + 1).clamp(max=BINS - 1)
    seg_slope = (remapped[:, jn] - remapped) / (edges[:, jn] - edges)
    prev = torch.cat([torch.full((c, 1), -float("inf")), edges[:, :-1]], dim=1)
    # each sample: the guess, its check, the binary search on a miss
    step_safe = torch.where(step > 0, step, torch.ones_like(step))
    u = torch.ceil((t - lo[:, None]) / step_safe[:, None])
    guess = torch.nan_to_num(u, nan=0.0).clamp(1, BINS).to(torch.int64) - 1
    hit = (g(prev, guess) < t) & ((t <= g(edges, guess)) | (guess == BINS - 1))
    idx = torch.where(hit, guess, _search(t, edges))
    nxt = (idx + 1).clamp(max=BINS - 1)
    s = g(seg_slope, idx)
    out = _lerp_fallback(t, s, g(edges, idx), g(remapped, idx), g(edges, nxt),
                         g(remapped, nxt))
    return out, idx, hit


def _plain_edges(lo, hi):
    """cdf_remap_plain's right edges."""
    width = hi - lo
    j = torch.arange(1, BINS + 1, dtype=torch.float32)
    edges = lo[:, None] + j * (width / BINS)[:, None]
    return torch.where((width > 0)[:, None], edges, lo[:, None].expand_as(edges))


def _ranges(t, s):
    return (torch.minimum(t.min(dim=1).values, s.min(dim=1).values),
            torch.maximum(t.max(dim=1).values, s.max(dim=1).values))


def _case(name, rng):
    """(t, s, lo, hi) as float32 tensors for one kind of row."""
    c, n = 5, 1500
    t = rng.normal(0, 2, (c, n)).astype(np.float32)
    s = rng.normal(1, 1.5, (c, n + 300)).astype(np.float32)
    if name == "collapsed":
        # rows at 1e3 and 1e6 whose 256 f32 edges collapse to fewer values
        t = t * np.float32(1e-3)
        s = s * np.float32(1e-3)
        t[:3] += np.float32(1e3)
        s[:3] += np.float32(1e3)
        t[3:] = t[3:] * np.float32(500) + np.float32(1e6)
        s[3:] = s[3:] * np.float32(500) + np.float32(1e6)
    if name == "constant":
        t[1] = 0.5
        s[1] = 0.5
    t, s = torch.from_numpy(t), torch.from_numpy(s)
    lo, hi = _ranges(t, s)
    if name == "pile":
        t[3, :300] = hi[3]
        t[0, :100] = lo[0]
    if name == "edges":
        # every edge, and one ulp below and above it, as target samples
        e = _plain_edges(lo, hi)
        t = torch.cat([e, torch.nextafter(e, torch.full_like(e, -np.inf)),
                       torch.nextafter(e, torch.full_like(e, np.inf)), t], dim=1)
    if name == "out_of_range":
        # the range of the inner samples only; the rest lie outside it
        lo, hi = _ranges(t[:, :1000], s[:, :1000])
        t[:, 0], t[:, 1] = lo - 1.0, hi + 1.0
        t[:, 2], t[:, 3] = -1e30, 1e30
        t[:, 4], t[:, 5] = -np.inf, np.inf
    return t.contiguous(), s, lo, hi


CASES = ["gaussian", "constant", "pile", "edges", "collapsed", "out_of_range"]


@pytest.mark.parametrize("name", CASES)
def test_kernel_model_is_bit_equal_to_plain(name, rng):
    t, s, lo, hi = _case(name, rng)
    t_hist, s_hist = cdf.histogram_plain(t, lo, hi), cdf.histogram_plain(s, lo, hi)
    out, idx, hit = kernel_model(t, t_hist, s_hist, lo, hi)
    ref = cdf.cdf_remap_plain(t, t_hist, s_hist, lo, hi)
    assert not torch.isnan(ref).any()
    assert torch.equal(out, ref)
    edges = _plain_edges(lo, hi)
    assert torch.equal(idx, torch.searchsorted(edges, t).clamp(max=BINS - 1))
    # the binary search alone is the same index on every sample
    assert torch.equal(_search(t, edges), idx)
    miss = 1.0 - hit.float().mean().item()
    if name in ("gaussian", "pile"):
        assert miss == 0.0
    if name == "edges":
        # samples on and beside the edges miss only where the division's
        # rounding moves them over one; the ordinary rows behind them do not
        assert bool(hit[:, 3 * BINS:].all())
    if name == "collapsed":
        distinct = [len(torch.unique(r)) for r in edges]
        assert max(distinct) < BINS                # the f32 edges collapse
        assert miss > 0.05                         # and the guess misses
    if name == "constant":
        assert bool((out[1] == out[1, 0]).all())   # one value for a flat range


def test_collapsed_rows_plain_matches_pallas_kernel(rng):
    """The plain version vs JAX's Pallas cdf_remap (interpret mode) on rows
    whose f32 edges collapse, at tests/test_torch_legacy_kernels.py's
    2e-5 x max|ref|."""
    t, s, lo, hi = _case("collapsed", rng)
    t_hist, s_hist = cdf.histogram_plain(t, lo, hi), cdf.histogram_plain(s, lo, hi)
    args = [a.numpy() for a in (t, t_hist, s_hist, lo, hi)]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jcdf_remap(*map(jnp.asarray, args)))
    got = cdf.cdf_remap(t, t_hist, s_hist, lo, hi).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * np.abs(ref).max())
