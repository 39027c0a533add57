"""The torch port's OT half against the JAX package: polar rotations from the
same Gaussian, the moment half of histmatch (including near-singular and
constant channels), PCA spectra and the k rule, and the composed
transport_loop with the JAX rotation stacks injected (the
tests/test_transport.py pattern). CPU only, float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimaltextures_tpu import transport as jtransport
from optimaltextures_tpu.ops import histmatch as jhm
from optimaltextures_tpu.ops import rotation as jrot
from optimaltextures_tpu_torch import transport as ttransport
from optimaltextures_tpu_torch.ops import histmatch as thm
from optimaltextures_tpu_torch.ops import rotation as trot

MODES = ["chol", "pca", "sym"]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, ref, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", [3, 16, 64])
def test_polar_rotations_match_jax_from_same_gaussian(n):
    key = jax.random.key(n)
    g = np.asarray(jax.random.normal(key, (6, n, n), dtype=jnp.float32))
    ref = np.asarray(jrot.random_rotations_polar(key, 6, n))
    got = trot.polar_rotations(_t(g)).numpy()
    _close(got, ref, atol=2e-5)
    # as orthogonal as JAX's (30 iterations leave an occasional ill-conditioned
    # 64x64 draw short of convergence on both sides), and det = +1
    for q, qr in zip(got.astype(np.float64), ref.astype(np.float64)):
        own = np.abs(q @ q.T - np.eye(n)).max()
        assert own <= np.abs(qr @ qr.T - np.eye(n)).max() + 1e-4
        assert np.linalg.det(q) > 0


def test_generator_streams_are_deterministic():
    a = trot.stage_rotations(trot.generator("cpu", 5, 0, 1), 4, 8)
    b = trot.stage_rotations(trot.generator("cpu", 5, 0, 1), 4, 8)
    c = trot.stage_rotations(trot.generator("cpu", 5, 0, 2), 4, 8)
    assert torch.equal(a, b) and not torch.equal(a, c)


def _features(rng, kind, shape=(2, 9, 11, 12)):
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    if kind == "near_singular":
        x[..., 5] = x[..., 4] * 1.0001 + 1e-4 * x[..., 3]
    elif kind == "constant":
        x[..., 2] = 3.0
    return x


@pytest.mark.parametrize("kind", ["plain", "near_singular", "constant"])
@pytest.mark.parametrize("mode", MODES)
def test_moment_transform_matches_jax(mode, kind, rng):
    tgt = _features(rng, kind)
    src = _features(rng, kind, (1, 8, 8, 12)) * 0.7 - 0.3
    mu_j, cov_j = jhm.moment_stats(jnp.asarray(tgt))
    mu_t, cov_t = thm.moment_stats(_t(tgt))
    _close(mu_t.numpy(), mu_j, atol=1e-5)
    _close(cov_t.numpy(), cov_j, atol=1e-4, rtol=1e-5)
    _, covs_j = jhm.moment_stats(jnp.asarray(src))
    ref = np.asarray(jhm.moment_transform(cov_j, covs_j, mode))
    got = thm.moment_transform(_t(cov_j), _t(covs_j), mode).numpy()
    _close(got, ref, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("mode", MODES)
def test_style_factors_and_pre_transform_match_jax(mode, rng):
    c, n = 10, 5
    rots = np.asarray(jrot.random_rotations_polar(jax.random.key(1), n, c))
    x = rng.normal(0.0, 1.5, (1, 12, 12, c)).astype(np.float32)
    _, cov_s = jhm.moment_stats(jnp.asarray(x))
    _, cov_t = jhm.moment_stats(jnp.asarray(x[..., ::-1] * 2.0 + 1.0))
    ref_rot = np.asarray(jhm.style_congruence_batch(jnp.asarray(rots), cov_s))
    got_rot = thm.style_congruence_batch(_t(rots), _t(cov_s)).numpy()
    _close(got_rot, ref_rot, atol=1e-4, rtol=1e-5)
    ref_f = np.asarray(jhm.style_factor_batch(jnp.asarray(ref_rot), mode))
    got_f = thm.style_factor_batch(_t(ref_rot), mode).numpy()
    _close(got_f, ref_f, atol=2e-4, rtol=1e-4)
    ref_a = np.asarray(jhm.moment_transform_pre(cov_t, jnp.asarray(ref_f[0]), mode))
    got_a = thm.moment_transform_pre(_t(cov_t), _t(ref_f[0]), mode).numpy()
    _close(got_a, ref_a, atol=2e-4, rtol=1e-3)


def test_psd_sqrt_and_inv_match_jax(rng):
    a = rng.normal(size=(16, 16)).astype(np.float32)
    cov = a @ a.T + np.eye(16, dtype=np.float32)
    qj, qij = jhm._psd_sqrt_and_inv(jnp.asarray(cov))
    qt, qit = thm._psd_sqrt_and_inv(_t(cov))
    _close(qt.numpy(), qj, atol=1e-4, rtol=1e-4)
    _close(qit.numpy(), qij, atol=1e-5, rtol=1e-4)
    _close(qt.numpy() @ qt.numpy(), cov, atol=1e-3, rtol=1e-4)


def test_pca_spectrum_and_choose_k_match_jax(rng):
    x = (rng.normal(size=(1, 20, 20, 32)) * np.linspace(3.0, 0.1, 32)
         ).astype(np.float32)
    sj, vj = jtransport.pca_spectrum(jnp.asarray(x))
    st, vt = ttransport.pca_spectrum(_t(x))
    _close(st.numpy(), sj, atol=1e-3, rtol=1e-4)
    k = jtransport.choose_k(np.asarray(sj))
    assert ttransport.choose_k(st) == k
    # eigenvector signs are the solver's: compare the projector V V^T
    pj = np.asarray(vj)[:, :k] @ np.asarray(vj)[:, :k].T
    pt = vt.numpy()[:, :k] @ vt.numpy()[:, :k].T
    _close(pt, pj, atol=1e-3)
    for s in ([5.0, 1.0, 1.0], [1.0] * 10, [9.5, 0.5]):
        assert ttransport.choose_k(s) == jtransport.choose_k(np.asarray(s))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("batch", [1, 2])
def test_transport_loop_with_injected_rotations_matches_jax(mode, batch, rng):
    key = jax.random.key(9)
    n_iters, c = 16, 8
    feat = rng.normal(1.0, 2.0, (batch, 12, 12, c)).astype(np.float32)
    style = rng.normal(-0.5, 1.5, (1, 10, 10, c)).astype(np.float32)
    ref = np.asarray(jtransport.transport_loop(
        key, jnp.asarray(feat), jtransport.style_stats(jnp.asarray(style), False),
        n_iters, mode))
    rots = np.asarray(jrot.stage_rotations(key, n_iters, c))
    got = ttransport.transport_loop(None, _t(feat),
                                    ttransport.style_stats(_t(style)), n_iters,
                                    mode, rotations=_t(rots)).numpy()
    _close(got, ref, atol=2e-3, rtol=1e-4)
    # and the result really moved to the style's moments
    _, cov_got = thm.moment_stats(torch.from_numpy(got))
    _, cov_style = thm.moment_stats(_t(style))
    assert float((cov_got - cov_style).abs().max()) < 0.5 * float(cov_style.abs().max())


def test_transport_loop_zero_iters_and_bad_rotations():
    x = torch.randn(1, 4, 4, 3)
    st = ttransport.style_stats(torch.randn(1, 4, 4, 3))
    assert ttransport.transport_loop(None, x, st, 0, "chol") is x
    with pytest.raises(ValueError):
        ttransport.transport_loop(None, x, st, 2, "chol",
                                  rotations=torch.eye(3).expand(3, 3, 3))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttransport.transport_loop(None, x, st, 2, "cdf")
