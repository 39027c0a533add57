"""The torch port's cdf/sort half against the JAX package, on the CPU: the
plain versions of the two cdf kernels (ops/cdf.py) against the Pallas
kernels in interpret mode and against their XLA twins, the table work and
the matchers of ops/histmatch.py, the sampled and content branches of
transport_loop with injected rotations, and ops/colors.py. The kernels
themselves run only on a GPU: tests/test_torch_cuda.py holds them against
these plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from optimaltextures_tpu import transport as jtransport
from optimaltextures_tpu.ops import colors as jcolors
from optimaltextures_tpu.ops import histmatch as jhm
from optimaltextures_tpu.ops import rotation as jrot
from optimaltextures_tpu.ops.pallas.histogram import batched_histogram as jhist
from optimaltextures_tpu.ops.pallas.pwl_remap import pwl_remap as jpwl
from optimaltextures_tpu_torch import transport as ttransport
from optimaltextures_tpu_torch.ops import cdf
from optimaltextures_tpu_torch.ops import colors as tcolors
from optimaltextures_tpu_torch.ops import histmatch as thm
from optimaltextures_tpu_torch.ops import rotation as trot


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# kernel 6: batched_histogram (plain version) — exact


@pytest.mark.parametrize("c,n", [(3, 1000), (8, 512), (5, 700), (16, 4096)])
def test_histogram_plain_matches_jax_exactly(c, n, rng):
    x = rng.normal(0, 2, (c, n)).astype(np.float32)
    x[c // 2] = 1.25                          # a constant channel
    lo, hi = x.min(axis=1), x.max(axis=1)
    ref = np.asarray(jhm.histogram_rows(_j(x), _j(lo), _j(hi), use_pallas=False))
    with pltpu.force_tpu_interpret_mode():
        ref_kernel = np.asarray(jhist(_j(x), _j(lo), _j(hi)))
    got = cdf.batched_histogram(_t(x), _t(lo), _t(hi)).numpy()
    assert got.shape == (c, 256) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, ref_kernel)
    assert got[c // 2, 0] == n                # width 0 -> everything in bin 0
    # torch.histc's binning on every non-degenerate channel
    for i in range(c):
        if i != c // 2:
            np.testing.assert_array_equal(
                got[i], torch.histc(_t(x[i]), 256, float(lo[i]),
                                    float(hi[i])).numpy())
    assert cdf.LAUNCHES["batched_histogram"] == 0   # plain versions never count


def test_histogram_rows_routes_and_checks(rng):
    x = _t(rng.normal(size=(4, 300)))
    lo, hi = x.min(dim=1).values, x.max(dim=1).values
    kern = thm.histogram_rows(x, lo, hi)
    plain = thm.histogram_rows(x, lo, hi, use_pallas=False)
    assert torch.equal(kern, plain)
    # other bin counts: the plain formulation (legacy oracle binning)
    h100 = thm.histogram_rows(x, lo, hi, bins=100)
    ref = np.asarray(jhm.histogram_rows(_j(x), _j(lo), _j(hi), bins=100,
                                        use_pallas=False))
    np.testing.assert_array_equal(h100.numpy(), ref)
    with pytest.raises(ValueError):
        cdf.batched_histogram(x, lo[:3], hi[:3])
    with pytest.raises(ValueError):
        cdf.batched_histogram(x[0], lo, hi)


# ---------------------------------------------------------------------------
# kernel 7: pwl_remap (plain version) — <= 1e-5 x max|ref|


def _pwl_inputs(rng, c=5, n=700):
    t = rng.normal(0, 3, (c, n)).astype(np.float32)
    s = rng.normal(1, 2, (c, 1200)).astype(np.float32)
    t[3] = 2.5                      # constant target channel
    s[4] = -1.0                     # constant source channel
    lo = np.minimum(t.min(axis=1), s.min(axis=1))
    hi = np.maximum(t.max(axis=1), s.max(axis=1))
    t[2, :50] = hi[2]               # a pile on the top edge
    return t, s, lo, hi


def test_pwl_remap_plain_matches_jax(rng):
    t, s, lo, hi = _pwl_inputs(rng)
    t_hist = jhm.histogram_rows(_j(t), _j(lo), _j(hi), use_pallas=False)
    s_hist = jhm.histogram_rows(_j(s), _j(lo), _j(hi), use_pallas=False)
    t_cdf, s_cdf = jhm.cdf_cdfs_rows(t_hist, s_hist)
    edges = jhm._edges_rows(_j(lo), _j(hi), 256)
    remapped = jhm._remap_table_rows(t_cdf, s_cdf, edges)
    want = np.asarray(jhm._pwl_apply_rows(_j(t), remapped, _j(lo), _j(hi)))
    with pltpu.force_tpu_interpret_mode():
        want_kernel = np.asarray(jpwl(_j(t), remapped, _j(lo), _j(hi)))
    got = cdf.pwl_remap(_t(t), _t(remapped), _t(lo), _t(hi)).numpy()
    assert _rel_err(got, want) <= 1e-5
    assert _rel_err(got, want_kernel) <= 1e-5
    # the segment index is the XLA twin's, sample for sample
    step = cdf.pwl_step(_t(lo), _t(hi))
    step_safe = torch.where(step > 0, step, torch.ones_like(step))
    j_ref = np.asarray(jhm._pwl_bin_index(_j(t), _j(lo), _j(step_safe.numpy()),
                                          256))
    np.testing.assert_array_equal(
        cdf.pwl_bin_index(_t(t), _t(lo), step_safe).numpy(), j_ref)
    # the constant target channel maps to remapped[0] only when its range
    # is degenerate; the top-edge pile maps to the last table value
    np.testing.assert_array_equal(got[2, :50], np.asarray(remapped)[2, -1])


# ---------------------------------------------------------------------------
# the table work and the matchers


def test_cdfs_edges_and_remap_table_match_jax_exactly(rng):
    t, s, lo, hi = _pwl_inputs(rng, c=7, n=900)
    t_hist = jhm.histogram_rows(_j(t), _j(lo), _j(hi), use_pallas=False)
    s_hist = jhm.histogram_rows(_j(s), _j(lo), _j(hi), use_pallas=False)
    jt_cdf, js_cdf = jhm.cdf_cdfs_rows(t_hist, s_hist)
    tt_cdf, ts_cdf = thm.cdf_cdfs_rows(_t(t_hist), _t(s_hist))
    np.testing.assert_array_equal(tt_cdf.numpy(), np.asarray(jt_cdf))
    np.testing.assert_array_equal(ts_cdf.numpy(), np.asarray(js_cdf))
    edges = jhm._edges_rows(_j(lo), _j(hi), 256)
    np.testing.assert_array_equal(thm._edges_rows(_t(lo), _t(hi), 256).numpy(),
                                  np.asarray(edges))
    ref = np.asarray(jhm._remap_table_rows(jt_cdf, js_cdf, edges))
    got = thm._remap_table_rows(tt_cdf, ts_cdf, _t(edges)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape_t,shape_s", [((1, 24, 24, 6), (1, 20, 20, 6)),
                                             ((2, 9, 11, 3), (1, 30, 7, 3))])
def test_cdf_match_and_rows_match_jax(shape_t, shape_s, rng):
    t = rng.normal(0, 2, shape_t).astype(np.float32)
    s = rng.normal(1, 3, shape_s).astype(np.float32)
    t[..., 1] = 0.5                           # a constant target channel
    ref = np.asarray(jhm.cdf_match(_j(t), _j(s), use_pallas=False))
    for use_pallas in (True, False):
        got = thm.cdf_match(_t(t), _t(s), use_pallas=use_pallas).numpy()
        assert got.shape == t.shape
        assert _rel_err(got, ref) <= 2e-5
    c = t.shape[-1]
    rows_t, rows_s = t.reshape(-1, c).T, s.reshape(-1, c).T
    ref_rows = np.asarray(jhm.cdf_match_rows(_j(rows_t), _j(rows_s),
                                             use_pallas=False))
    got_rows = thm.cdf_match_rows(_t(rows_t), _t(rows_s)).numpy()
    assert _rel_err(got_rows, ref_rows) <= 2e-5


def test_cdf_match_legacy_bins_matches_jax(rng):
    """bins != 256: the per-channel searchsorted oracle (interp_ref)."""
    t = rng.normal(0, 2, (1, 16, 16, 5)).astype(np.float32)
    s = rng.normal(1, 1, (1, 12, 12, 5)).astype(np.float32)
    for bins in (64, 100):
        ref = np.asarray(jhm.cdf_match(_j(t), _j(s), bins=bins))
        got = thm.cdf_match(_t(t), _t(s), bins=bins).numpy()
        assert _rel_err(got, ref) <= 2e-5
    # and the oracle agrees with the fast path at 256 bins
    legacy = torch.stack([thm._cdf_match_channel(a, b, 256) for a, b in
                          zip(_t(t.reshape(-1, 5).T), _t(s.reshape(-1, 5).T))])
    fast = thm.cdf_match(_t(t), _t(s)).numpy().reshape(-1, 5).T
    assert _rel_err(legacy.numpy(), fast) <= 1e-4
    x = _t(np.sort(rng.normal(size=20)))
    q = _t(rng.normal(size=50) * 1.5)
    np.testing.assert_allclose(
        thm.interp_ref(q, x, x * 2 + 1).numpy(),
        np.asarray(jhm.interp_ref(_j(q), _j(x), _j(x * 2 + 1))), atol=1e-6)


@pytest.mark.parametrize("nt,ns", [(400, 400), (300, 700), (700, 300)])
def test_sort_match_matches_jax_exactly(nt, ns, rng):
    t = rng.normal(0, 2, (1, nt, 1, 4)).astype(np.float32)
    s = rng.normal(1, 3, (1, ns, 1, 4)).astype(np.float32)
    t[0, :20, 0, 2] = 0.0                     # ties
    ref = np.asarray(jhm.sort_match(_j(t), _j(s)))
    np.testing.assert_array_equal(thm.sort_match(_t(t), _t(s)).numpy(), ref)


def test_sort_match_channel_blocks(rng, monkeypatch):
    t = _t(rng.normal(size=(5, 64)))
    s = _t(rng.normal(size=(5, 80)))
    whole = thm.sort_match_rows(t, s)
    monkeypatch.setattr(thm, "_SORT_BLOCK_ELEMS", 2 * 80)   # 2-row blocks
    assert torch.equal(thm.sort_match_rows(t, s), whole)


@pytest.mark.parametrize("mode", ["chol", "cdf", "sort"])
def test_hist_match_and_reference_step_match_jax(mode, rng):
    t = rng.normal(0, 2, (1, 10, 10, 3)).astype(np.float32)
    s = rng.normal(1, 1, (1, 12, 12, 3)).astype(np.float32)
    ref = np.asarray(jhm.hist_match(_j(t), _j(s), mode))
    got = thm.hist_match(_t(t), _t(s), mode).numpy()
    assert _rel_err(got, ref) <= 2e-5
    key = jax.random.key(3)
    rot = np.asarray(jrot.random_rotation(key, 3))
    ref = np.asarray(jtransport.ot_step_reference(key, _j(t), _j(s), mode))
    got = ttransport.ot_step_reference(None, _t(t), _t(s), mode,
                                       rotation=_t(rot)).numpy()
    assert _rel_err(got, ref) <= 1e-4


def test_random_rotation_is_special_orthogonal():
    for n in (3, 8):
        q = trot.random_rotation(trot.generator("cpu", 1, n), n).double()
        assert float((q @ q.T - torch.eye(n, dtype=q.dtype)).abs().max()) < 1e-5
        assert float(torch.linalg.det(q)) > 0
    a = trot.random_rotation(trot.generator("cpu", 2), 3)
    assert torch.equal(a, trot.random_rotation(trot.generator("cpu", 2), 3))


# ---------------------------------------------------------------------------
# transport_loop: the sampled branch and the composed-with-content branch


def _loop_inputs(rng, c=8):
    feat = rng.normal(1.0, 2.0, (1, 12, 12, c)).astype(np.float32)
    style = rng.normal(-0.5, 1.5, (1, 10, 10, c)).astype(np.float32)
    content = rng.normal(0.3, 1.0, (1, 12, 12, c)).astype(np.float32)
    return feat, style, content


@pytest.mark.parametrize("mode", ["cdf", "sort"])
@pytest.mark.parametrize("strength", [0.0, 0.05])
def test_sampled_transport_loop_matches_jax(mode, strength, rng, monkeypatch):
    """8 iterations, injected rotations, with and without the content pull.

    sort: the whole loop within 1e-3 x max|ref|. cdf: every iteration within
    1e-3 x max|ref| from the same (JAX) state, and the whole loop by its
    per-channel means and standard deviations within 1e-2 x max|ref|. The
    whole cdf loop is not held pixel by pixel because the two f32 GEMMs
    round the rotated clouds differently (summation order): on this input
    the states drift 2.5e-5 apart in three iterations, a sample then falls
    into the neighbouring bin (iteration 3, channel 1, bin 88), and with 144
    samples on 256 bins one moved count reshapes the remap table — the
    reference's cdf mode is chaotic at this granularity."""
    key = jax.random.key(11)
    n_iters, c = 8, 8
    feat, style, content = _loop_inputs(rng, c)
    rots = np.asarray(jrot.stage_rotations(key, n_iters, c))
    j_stats = jtransport.style_stats(_j(style), True)
    t_stats = ttransport.style_stats(_t(style), need_samples=True)
    j_cf = _j(content) if strength else None
    t_cf = _t(content) if strength else None

    def jax_loop(x, rot_stack):
        monkeypatch.setattr("optimaltextures_tpu.transport.stage_rotations",
                            lambda k, n, cc: jnp.asarray(rot_stack))
        return np.asarray(jtransport.transport_loop(
            key, _j(x), j_stats, len(rot_stack), mode, content_feature=j_cf,
            content_strength=strength, use_pallas=False))

    def port_loop(x, rot_stack):
        return ttransport.transport_loop(
            None, _t(x), t_stats, len(rot_stack), mode, content_feature=t_cf,
            content_strength=strength, rotations=_t(rot_stack)).numpy()

    ref = jax_loop(feat, rots)
    got = port_loop(feat, rots)
    assert got.shape == feat.shape
    if mode == "sort":
        assert _rel_err(got, ref) <= 1e-3
    else:
        state = feat
        for i in range(n_iters):
            step_ref = jax_loop(state, rots[i:i + 1])
            assert _rel_err(port_loop(state, rots[i:i + 1]), step_ref) <= 1e-3
            state = step_ref
        scale = float(np.abs(ref).max())
        g, r = got.reshape(-1, c), ref.reshape(-1, c)
        assert float(np.abs(g.mean(0) - r.mean(0)).max()) <= 1e-2 * scale
        assert float(np.abs(g.std(0) - r.std(0)).max()) <= 1e-2 * scale
    # the clouds really moved toward the style
    assert abs(float(got.mean()) - float(style.mean())) < \
        abs(float(feat.mean()) - float(style.mean()))


@pytest.mark.parametrize("mode", ["chol", "pca", "sym"])
def test_composed_content_branch_matches_jax(mode, rng):
    key = jax.random.key(5)
    n_iters, c = 12, 8
    feat, style, content = _loop_inputs(rng, c)
    ref = np.asarray(jtransport.transport_loop(
        key, _j(feat), jtransport.style_stats(_j(style), False), n_iters, mode,
        content_feature=_j(content), content_strength=0.05))
    rots = np.asarray(jrot.stage_rotations(key, n_iters, c))
    got = ttransport.transport_loop(
        None, _t(feat), ttransport.style_stats(_t(style)), n_iters, mode,
        content_feature=_t(content), content_strength=0.05,
        rotations=_t(rots)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=1e-4)


def test_ot_step_cdf_matches_jax_color_step(rng):
    """The color tail's pixel-space step: 3x3 QR rotation, the lum target's
    own pixels as the sample cloud."""
    key = jax.random.key(8)
    img = rng.uniform(size=(1, 16, 16, 3)).astype(np.float32)
    target = rng.uniform(size=(1, 16, 16, 3)).astype(np.float32) ** 2
    samples = target.reshape(-1, 3)
    ref = np.asarray(jtransport.ot_step_cdf(key, _j(img), _j(samples),
                                            use_pallas=False))
    rot = np.asarray(jrot.random_rotation(key, 3))
    got = ttransport.ot_step_cdf(None, _t(img), _t(samples),
                                 rotation=_t(rot)).numpy()
    assert _rel_err(got, ref) <= 1e-5


# ---------------------------------------------------------------------------
# ops/colors.py — <= 1e-6


def test_colors_match_jax(rng):
    rgb = rng.random((1, 8, 16, 3), dtype=np.float32)
    rgb[0, 0, :7] = np.array([[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0],
                              [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32)
    hls_ref = np.asarray(jcolors.rgb_to_hls(_j(rgb)))
    np.testing.assert_allclose(tcolors.rgb_to_hls(_t(rgb)).numpy(), hls_ref,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tcolors.hls_to_rgb(_t(hls_ref)).numpy(),
                               np.asarray(jcolors.hls_to_rgb(_j(hls_ref))),
                               rtol=0, atol=1e-6)
    past = rng.random((1, 8, 16, 3), dtype=np.float32)
    np.testing.assert_allclose(
        tcolors.swap_lightness(_t(rgb), _t(past)).numpy(),
        np.asarray(jcolors.swap_lightness(_j(rgb), _j(past))), rtol=0, atol=1e-6)
