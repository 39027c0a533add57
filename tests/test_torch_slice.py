"""The torch port's main path end to end against the JAX package, on the CPU:
Synthesizer.run at 64 px, depth 3, the real weights, 2 passes, with the same
numpy noise and the same injected rotation stacks (the JAX side monkeypatches
transport.stage_rotations, as tests/test_reference_parity_ext.py does),
bounded by 5e-4 (tests/test_fastcodec.py's kernel-codec bound). PCA is off
for the pixel comparison — eigenvector signs differ between the two eigh
solvers and the chol transform is not basis-invariant — and a PCA-on case
checks the spectra, the chosen k of every (pass, layer) and the projector.
Plus the RNG contract and the CLI, on the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimaltextures_tpu import config as jconfig
from optimaltextures_tpu import core as jcore
from optimaltextures_tpu.utils import imageio as jimageio
from optimaltextures_tpu_torch import config as tconfig
from optimaltextures_tpu_torch import core as tcore
from optimaltextures_tpu_torch.ops import codec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "docs", "samples", "graffiti_cholhist_256.png")
PASSES = 2


class RotationStream:
    """Deterministic SO(n) stacks per (pass, stage), drawn with numpy (QR
    with the sign fix), handed to both packages."""

    def __init__(self, seed):
        self.seed, self.cache = seed, {}

    def __call__(self, p, i, n_iters, n):
        if (p, i) not in self.cache:
            rng = np.random.default_rng([self.seed, p, i])
            qs = []
            for _ in range(n_iters):
                q, r = np.linalg.qr(rng.standard_normal((n, n)))
                q = q * np.sign(np.diag(r))[None, :]
                if np.linalg.det(q) < 0:
                    q[:, -1] *= -1
                qs.append(q)
            self.cache[(p, i)] = np.stack(qs).astype(np.float32)
        assert self.cache[(p, i)].shape == (n_iters, n, n)
        return self.cache[(p, i)]


def _clear_jax_stage_caches():
    for fn in (jcore._run_stages_jit, jcore._run_stages_jit_nodonate,
               jcore._pass_stages_jit, jcore._pass_stages_jit_resize):
        fn.clear_cache()


def _jax_run(noise, style_img, stream, monkeypatch, cfg_kw):
    """JAX Synthesizer.run (fast_codec off) with the stream injected: the
    fused run program traces each stage's stage_rotations call once, in
    pass-major, deepest-first order."""
    order = [(p, i) for p in range(PASSES) for i in range(3)]
    calls = []

    def fake_stage_rotations(key, n_iters, n):
        p, i = order[len(calls)]
        calls.append((p, i))
        return jnp.asarray(stream(p, i, n_iters, n))

    _clear_jax_stage_caches()
    try:
        monkeypatch.setattr("optimaltextures_tpu.transport.stage_rotations",
                            fake_stage_rotations)
        synth = jcore.Synthesizer(jconfig.OptexConfig(fast_codec=False, **cfg_kw))
        out = np.asarray(synth.run(jnp.asarray(noise), [style_img]))
    finally:
        _clear_jax_stage_caches()     # drop the programs traced with the fake
    assert calls == order
    return out


def _cfg_kw(**extra):
    kw = dict(size=64, passes=PASSES, iters=60, no_multires=True, depth=3,
              seed=0, no_pca=True, style=["graffiti.png"])
    kw.update(extra)
    return kw


@pytest.fixture(scope="module")
def inputs():
    style = jimageio.load_image(SAMPLE, 64)
    noise = np.random.default_rng(5).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    return noise, style


def test_slice_matches_jax_synthesizer(inputs, monkeypatch):
    noise, style = inputs
    stream = RotationStream(17)
    ref = _jax_run(noise, style, stream, monkeypatch, _cfg_kw())

    synth = tcore.Synthesizer(tconfig.OptexConfig(**_cfg_kw()), device="cpu")
    assert all(min(row) > 0 for row in synth.iters_table)
    got = synth.run(noise, [style], rotations=stream).numpy()
    assert got.shape == ref.shape == (1, 64, 64, 3)
    err = float(np.abs(got - ref).max())
    assert err < 5e-4, err
    # the run really transported: the output is far from the noise
    assert float(np.abs(got - noise).mean()) > 0.05


def test_fast_codec_matches_plain_codec_in_port(inputs):
    """Inside the port: the kernel-covered codec path (plain versions on the
    CPU, with the renorm folding) vs the F.conv2d VGG path."""
    noise, style = inputs
    stream = RotationStream(3)
    outs = [tcore.Synthesizer(tconfig.OptexConfig(**_cfg_kw(fast_codec=fc)),
                              device="cpu").run(noise, [style], rotations=stream)
            for fc in (True, False)]
    assert float((outs[0] - outs[1]).abs().max()) < 5e-4


def test_pca_on_chooses_the_same_k_and_subspace(inputs):
    """PCA on, multires (3 passes at 256/192/128): per pass and layer, the
    port's style prep matches JAX's spectra, k, projector and the
    back-projected style covariance (all basis-independent)."""
    _, style = inputs
    kw = dict(size=128, passes=3, depth=3, seed=0, style=["graffiti.png"])
    js = jcore.Synthesizer(jconfig.OptexConfig(fast_codec=False, **kw))
    ts = tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu")
    plan = ts._plan_passes((128, 128))
    assert plan == [tuple(e) for e in js._plan_passes((128, 128), None)]
    assert [s for (s, _, _) in plan] == [256, 192, 128]
    t_style = [torch.from_numpy(style)]
    for size, rs, _ in plan:
        j_spec = js._dispatch_style_prep([jnp.asarray(style)], size, rs)
        j_ks, j_masks = js._choose_widths(j_spec)
        j_slim = js._finish_style_prep(j_spec, j_ks, j_masks, None, 1)
        t_spec = ts._dispatch_style_prep(t_style, size, rs)
        t_ks = ts._choose_widths(t_spec, [sv.numpy() for (_, sv, _) in t_spec])
        t_slim = ts._finish_style_prep(t_spec, t_ks)
        assert tuple(t_ks) == tuple(j_ks), (size, t_ks, j_ks)
        for (_, jsv, _), (_, tsv, _), (jv, jst, _), (tv, tst, _) in zip(
                j_spec, t_spec, j_slim, t_slim):
            jsv = np.asarray(jsv)
            np.testing.assert_allclose(tsv.numpy(), jsv, rtol=0,
                                       atol=1e-4 * float(jsv[0]))
            jv, tv = np.asarray(jv, np.float64), tv.numpy().astype(np.float64)
            np.testing.assert_allclose(tv @ tv.T, jv @ jv.T, atol=2e-3)
            jcov = jv @ np.asarray(jst.cov_raw, np.float64) @ jv.T
            tcov = tv @ tst.cov_raw.numpy().astype(np.float64) @ tv.T
            np.testing.assert_allclose(tcov, jcov, rtol=0,
                                       atol=2e-3 * float(np.abs(jcov).max()))


def test_rng_contract():
    """An explicit seed gives identical reruns; unseeded runs differ."""
    kw = dict(size=32, passes=1, iters=8, no_multires=True, depth=1,
              style=["x.png"])
    style = np.random.default_rng(1).uniform(size=(1, 32, 32, 3)).astype(np.float32)
    noise = np.random.default_rng(2).uniform(size=(1, 32, 32, 3)).astype(np.float32)
    seeded = tcore.Synthesizer(tconfig.OptexConfig(seed=4, **kw), device="cpu")
    a = seeded.run(noise, [style])
    b = seeded.run(noise, [style])
    assert torch.equal(a, b)
    assert seeded.next_run_key() == seeded.next_run_key() == 4
    free = tcore.Synthesizer(tconfig.OptexConfig(seed=None, **kw), device="cpu")
    k1, k2 = free.next_run_key(), free.next_run_key()
    assert k1 != k2
    assert not torch.equal(free.run(noise, [style], key=k1),
                           free.run(noise, [style], key=k2))
    o1, _ = tcore.synthesize(tconfig.OptexConfig(seed=4, **kw), [style], device="cpu")
    o2, _ = tcore.synthesize(tconfig.OptexConfig(seed=4, **kw), [style], device="cpu")
    assert torch.equal(o1, o2)


def test_cli_on_cpu_writes_png(tmp_path):
    from optimaltextures_tpu_torch import cli

    codec.reset_launches()
    rc = cli.main(["--style", SAMPLE, "--size", "64", "--passes", "1",
                   "--iters", "8", "--no_multires", "--depth", "2", "--seed", "1",
                   "--device", "cpu", "--output_dir", str(tmp_path), "--quiet"])
    assert rc == 0
    assert (tmp_path / "graffiti_cholhist_256_cholhist_no_multires_64.png").exists()
    # on the CPU the wrappers ran their plain versions: no kernel launched
    assert all(v == 0 for v in codec.LAUNCHES.values())
