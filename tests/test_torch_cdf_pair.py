"""The cdf step's two kernels as they are laid out for the card, on the CPU:
the histogram of both clouds of a step in one call (``cdf.histogram_pair``)
against two plain histograms and JAX's ``batched_histogram`` in interpret
mode, and the remap's plain version in the kernel's table order against
the per-sample form it replaced, bit for bit. The kernels themselves run
only on a GPU (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from optimaltextures_tpu.ops.pallas.histogram import batched_histogram as jhist
from optimaltextures_tpu_torch.ops import cdf
from optimaltextures_tpu_torch.ops import histmatch as thm


def _clouds(rng, c, nt, ns):
    """Target and source rows with their shared ranges: channel 1 constant
    on both sides (a degenerate range), channel 0 with a pile on the top
    edge, channel 2 (when there is one) with a pile on the bottom edge."""
    t = rng.normal(0, 2, (c, nt)).astype(np.float32)
    s = rng.normal(0.5, 1.5, (c, ns)).astype(np.float32)
    t[1], s[1] = 1.25, 1.25
    lo = np.minimum(t.min(axis=1), s.min(axis=1))
    hi = np.maximum(t.max(axis=1), s.max(axis=1))
    t[0, : nt // 5] = hi[0]
    s[0, : ns // 9] = hi[0]
    if c > 2:
        s[2, : ns // 4] = lo[2]
    return t, s, lo, hi


@pytest.mark.parametrize("c,nt,ns", [(3, 1000, 1000), (4, 777, 1203),
                                     (9, 4096, 513), (2, 5, 3)])
def test_histogram_pair_matches_plain_and_jax_exactly(c, nt, ns, rng):
    t, s, lo, hi = _clouds(rng, c, nt, ns)
    tt, st, lot, hit = (torch.from_numpy(a) for a in (t, s, lo, hi))
    got_t, got_s = cdf.histogram_pair(tt, st, lot, hit)
    for got, x, n in ((got_t, t, nt), (got_s, s, ns)):
        assert got.shape == (c, 256) and got.dtype == torch.float32
        assert torch.equal(got, cdf.histogram_plain(torch.from_numpy(x), lot, hit))
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jhist(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi)))
        np.testing.assert_array_equal(got.numpy(), ref)
        assert got[1, 0] == n                 # width 0 -> everything in bin 0
        np.testing.assert_array_equal(got.sum(dim=1).numpy(), n)
    assert got_t[0, 255] >= nt // 5           # the top-edge pile lands in bin 255
    assert cdf.LAUNCHES["batched_histogram"] == 0   # plain versions never count


def test_histogram_pair_checks_its_operands(rng):
    t, s, lo, hi = (torch.from_numpy(a) for a in _clouds(rng, 3, 100, 80))
    with pytest.raises(ValueError):
        cdf.histogram_pair(t, s[:2], lo, hi)          # channel counts differ
    with pytest.raises(ValueError):
        cdf.histogram_pair(t, s[0], lo, hi)           # not (C, N)
    with pytest.raises(ValueError):
        cdf.histogram_pair(t, s, lo[:2], hi[:2])


def test_cdf_match_rows_takes_both_histograms_in_one_call(rng, monkeypatch):
    """A cdf step asks for its two clouds' counts in one histogram_pair
    call (one launch on a GPU) and never calls batched_histogram."""
    t, s, _, _ = (torch.from_numpy(a) for a in _clouds(rng, 4, 600, 900))
    calls = []
    pair = cdf.histogram_pair

    def counted(*args):
        calls.append(tuple(a.shape for a in args))
        return pair(*args)

    monkeypatch.setattr(cdf, "histogram_pair", counted)
    monkeypatch.setattr(cdf, "batched_histogram", None)
    got = thm.cdf_match_rows(t, s)
    assert calls == [((4, 600), (4, 900), (4,), (4,))]
    plain = thm.cdf_match_rows(t, s, use_pallas=False)
    assert len(calls) == 1 and torch.equal(got, plain)


# ---------------------------------------------------------------------------
# pwl_remap: the plain version in table order vs the per-sample form


def _pwl_per_sample(t, remapped, lo, hi):
    """The per-sample form of the remap (the plain version before it was
    laid out as the kernel's tables): every sample computes its segment's
    edges and slope itself."""
    bins = remapped.shape[1]
    width = hi - lo
    step = (hi - lo) / bins
    step_safe = torch.where(step > 0, step, torch.ones_like(step))
    j = cdf.pwl_bin_index(t, lo, step_safe, bins).to(torch.int64)
    rnext = torch.cat([remapped[:, 1:], remapped[:, -1:]], dim=1)
    fp_i = torch.gather(remapped, 1, j)
    fp_n = torch.gather(rnext, 1, j)
    jf = (j + 1).to(t.dtype)
    xp_i = lo[:, None] + jf * step[:, None]
    xp_n = lo[:, None] + torch.clamp(jf + 1.0, max=float(bins)) * step[:, None]
    slope = (fp_n - fp_i) / (xp_n - xp_i)
    f = slope * (t - xp_i) + fp_i
    f = torch.where(j >= bins - 1, fp_i, f)
    return torch.where((width > 0)[:, None], f, remapped[:, :1])


def _edge_samples(rng, lo, hi, n):
    """Per channel: every right edge lo + (j+1)*step exactly, lo and hi,
    the last bin, its lower edge, and random samples in the range."""
    c = lo.shape[0]
    step = (hi - lo) / np.float32(256)
    j = np.arange(1, 257, dtype=np.float32)
    edges = lo[:, None] + j[None, :] * step[:, None]
    last = hi[:, None] - rng.uniform(0, 1, (c, 16)).astype(np.float32) * step[:, None]
    rand = lo[:, None] + rng.uniform(0, 1, (c, n)).astype(np.float32) * (hi - lo)[:, None]
    cols = [edges, lo[:, None], hi[:, None], last, edges[:, 254:255], rand]
    return np.concatenate(cols, axis=1).astype(np.float32)


@pytest.mark.parametrize("table", ["matched", "random"])
def test_pwl_remap_plain_in_table_order_is_bit_equal_to_per_sample(table, rng):
    c = 6
    lo = rng.normal(0, 2, c).astype(np.float32)
    hi = lo + rng.uniform(0.5, 4, c).astype(np.float32)
    hi[2] = lo[2]                              # degenerate: width 0
    hi[3] = lo[3] - 1.0                        # degenerate: width < 0
    lo[4], hi[4] = 3.0, np.float32(3.0) + np.float32(2.0 ** -20)   # a few ulps
    t = _edge_samples(rng, lo, hi, 500)
    if table == "matched":
        s = _edge_samples(rng, lo, hi, 700)
        s = s + rng.normal(0, 0.05, s.shape).astype(np.float32)
        s = np.clip(s, lo[:, None], np.maximum(lo, hi)[:, None])
        tt, st, lot, hit = (torch.from_numpy(np.ascontiguousarray(a))
                            for a in (t, s, lo, hi))
        t_cdf, s_cdf = thm.cdf_cdfs_rows(cdf.histogram_plain(tt, lot, hit),
                                         cdf.histogram_plain(st, lot, hit))
        remapped = thm._remap_table_rows(t_cdf, s_cdf, thm._edges_rows(lot, hit, 256))
    else:
        tt, lot, hit = (torch.from_numpy(a) for a in (t, lo, hi))
        # any table, repeated values included (zero-slope segments)
        remapped = torch.from_numpy(np.round(rng.normal(0, 3, (c, 256)), 1
                                             ).astype(np.float32))
    got = cdf.pwl_remap(tt, remapped, lot, hit)
    want = _pwl_per_sample(tt, remapped, lot, hit)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert np.isfinite(got.numpy()[[0, 1, 5]]).all()
    np.testing.assert_array_equal(got[2].numpy(), remapped[2, 0].numpy())
    np.testing.assert_array_equal(got[3].numpy(), remapped[3, 0].numpy())
    # hi and the last bin map to the table's last value
    np.testing.assert_array_equal(got[[0, 1, 5], 257].numpy(),
                                  remapped[[0, 1, 5], 255].numpy())
    assert cdf.LAUNCHES["pwl_remap"] == 0


def test_pwl_step_is_the_kernels_two_rounded_operations(rng):
    """The kernel takes step = __fdiv_rn(__fsub_rn(hi, lo), 256.0f): an f32
    subtraction, then an f32 division, each rounded to nearest. numpy's
    float32 arithmetic rounds each operation the same way."""
    lo = rng.normal(0, 1e3, 64).astype(np.float32)
    hi = lo + rng.uniform(-1, 1e3, 64).astype(np.float32)
    lo[:4] = [0.0, 1e-38, -3.0, 1e30]
    hi[:4] = [1e-42, 2e-38, -3.0, 3e30]       # subnormal, tiny, zero, huge widths
    with np.errstate(all="ignore"):
        want = np.subtract(hi, lo, dtype=np.float32) / np.float32(256.0)
    got = cdf.pwl_step(torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
