"""The port's last two kernels against the JAX package, on the CPU:
``ops/cdf.cdf_remap`` (the legacy fused cdf apply) against the Pallas
``cdf_remap`` in interpret mode and the XLA legacy oracle, and
``ops/conv64`` (the 64 -> 64 conv prototype) against
``tools/pallas_conv_proto.py`` — its packing, and its Pallas kernel in
interpret mode — plus the port of that tool on the CPU."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from optimaltextures_tpu.ops import histmatch as jhistmatch
from optimaltextures_tpu.ops.pallas.cdf_remap import cdf_remap as jcdf_remap
from optimaltextures_tpu_torch.ops import cdf, conv64
from optimaltextures_tpu_torch.tools import conv_proto

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# ---------------------------------------------------------------------------
# kernel 8: cdf_remap


def _hist(x, lo, hi):
    return cdf.histogram_plain(torch.from_numpy(x), torch.from_numpy(lo),
                               torch.from_numpy(hi)).numpy()


def _remap_inputs(case, rng):
    """tests/test_pallas_histogram.py:44-66's inputs (5 x 1500 target, 5 x
    1800 source), optionally with a constant channel (a degenerate shared
    range) and a pile of target samples on the top edge."""
    c, n = 5, 1500
    t = rng.normal(0, 2, (c, n)).astype(np.float32)
    s = rng.normal(3, 1, (c, n + 300)).astype(np.float32)
    if case == "constant":
        t[1] = 0.5
        s[1] = 0.5
    lo = np.minimum(t.min(1), s.min(1))
    hi = np.maximum(t.max(1), s.max(1))
    if case == "pile":
        t[3, :200] = hi[3]
    return t, s, lo, hi


@pytest.mark.parametrize("case", ["generic", "constant", "pile"])
def test_cdf_remap_plain_matches_pallas_kernel(case, rng):
    """Plain version vs the Pallas kernel (interpret mode): <= 2e-5 *
    max|ref| (the two pick a sample's segment by the same count, but the
    Pallas edges and tables round in XLA's fused order; the map is
    value-continuous across a segment boundary)."""
    t, s, lo, hi = _remap_inputs(case, rng)
    t_hist, s_hist = _hist(t, lo, hi), _hist(s, lo, hi)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jcdf_remap(*map(jnp.asarray, (t, t_hist, s_hist, lo, hi))))
    cdf.reset_launches()
    got = cdf.cdf_remap(*map(torch.from_numpy, (t, t_hist, s_hist, lo, hi))).numpy()
    assert cdf.LAUNCHES["cdf_remap"] == 0        # the CPU ran the plain version
    assert got.shape == ref.shape == t.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * np.abs(ref).max())
    if case == "constant":
        assert np.all(got[1] == got[1, 0])        # one value for a flat range


def test_cdf_remap_plain_matches_legacy_oracle(rng):
    """Plain version vs the JAX package's per-channel legacy oracle
    (histmatch._cdf_apply_channel), at the JAX test's own 2e-3."""
    t, s, lo, hi = _remap_inputs("generic", rng)
    t_hist, s_hist = _hist(t, lo, hi), _hist(s, lo, hi)
    ref = np.stack([np.asarray(jhistmatch._cdf_apply_channel(
        *map(jnp.asarray, (t[i], t_hist[i], s_hist[i], lo[i], hi[i])), 256))
        for i in range(t.shape[0])])
    got = cdf.cdf_remap_plain(*map(torch.from_numpy, (t, t_hist, s_hist, lo, hi)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-3)


def test_cdf_remap_checks_its_operands():
    t = torch.zeros(3, 10)
    lo, hi = torch.zeros(3), torch.ones(3)
    with pytest.raises(ValueError):
        cdf.cdf_remap(t, torch.zeros(3, 128), torch.zeros(3, 256), lo, hi)
    with pytest.raises(ValueError):
        cdf.cdf_remap(t, torch.zeros(3, 256), torch.zeros(3, 256), lo[:2], hi)


# ---------------------------------------------------------------------------
# kernel 9: conv64


def test_pack_wrow_matches_the_tool(proto, rng):
    w = rng.normal(0, 0.1, (3, 3, 64, 64)).astype(np.float32)
    want = np.asarray(proto.pack_wrow(jnp.asarray(w, jnp.bfloat16)), np.float32)
    got = conv64.pack_wrow(torch.from_numpy(w).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the kernel reads every tap back from the phase-0 rows
    np.testing.assert_array_equal(
        conv64.unpack_wrow(got).float().numpy(),
        torch.from_numpy(w).to(torch.bfloat16).float().numpy())


def test_conv64_plain_matches_pallas_kernel(proto, rng):
    """The plain version vs conv64_pallas in interpret mode at the tool's
    smallest tile, (10, 18, 64, 128) bf16: <= 2^-7 * max|ref| (one bf16
    rounding of two f32 sums taken in other orders), compared in f32."""
    x = rng.normal(0, 1, (10, 18, 64, 128)).astype(np.float32)
    w = rng.normal(0, 0.1, (3, 3, 64, 64)).astype(np.float32)
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(proto.conv64_pallas(xj, proto.pack_wrow(wj)), np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wrow = conv64.pack_wrow(torch.from_numpy(w).to(torch.bfloat16))
    conv64.reset_launches()
    got = conv64.conv64(xt, wrow)
    assert conv64.LAUNCHES["conv64"] == 0
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape == (8, 16, 64, 128)
    scale = float(np.abs(ref).max())
    assert float(np.abs(got.float().numpy() - ref).max()) <= 2.0 ** -7 * scale
    assert float((got.float() == 0).float().mean()) > 0.3      # ReLU applied


def test_conv64_checks_its_operands():
    wrow = torch.zeros(3, 128, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        conv64.conv64(torch.zeros(4, 4, 32, 2, dtype=torch.bfloat16), wrow)
    with pytest.raises(ValueError):
        conv64.conv64(torch.zeros(4, 4, 64, 2, dtype=torch.bfloat16), wrow[:, :64])


def test_conv_tool_checks_on_cpu(capsys):
    assert conv_proto.main(["--check_only", "--device", "cpu", "--check_size",
                            "12", "--batch", "3"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("correctness 12px (batch 3, cpu): max abs err")
    with pytest.raises(SystemExit):
        conv_proto.main(["--device", "cpu"])       # timing needs the GPU
