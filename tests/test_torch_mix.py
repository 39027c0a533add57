"""Texture mixing in the torch port against the JAX package, on the CPU: the
nearest mask resize, the 2-style and N-style blends in every hist mode, and
whole mixing runs through Synthesizer.run at 64 px, depth 3, the real
weights, with the same numpy noise, the same injected stage rotations and
the same mask draws on both sides (the test draws JAX's own masks from the
run key, ``fold_in(fold_in(key, p), 7919)``, and hands them to the port
through ``run(mix_draws=)``). Plus the RNG contract, the validation, the
api and the CLI."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimaltextures_tpu import config as jconfig
from optimaltextures_tpu import core as jcore
from optimaltextures_tpu.ops import resize as jresize
from optimaltextures_tpu.utils import imageio as jimageio
from optimaltextures_tpu_torch import api as tapi
from optimaltextures_tpu_torch import config as tconfig
from optimaltextures_tpu_torch import core as tcore
from optimaltextures_tpu_torch.ops import cdf
from optimaltextures_tpu_torch.ops.resize import resize_nearest_nhwc
from test_torch_slice import RotationStream, _clear_jax_stage_caches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = os.path.join(REPO, "docs", "samples")
STYLE_A = os.path.join(SAMPLES, "graffiti_cholhist_256.png")
STYLE_B = os.path.join(SAMPLES, "zebra_pattern_lava_mix3_256.png")
STYLE_C = os.path.join(SAMPLES, "graffiti_sort_512.png")
SEED = 0
MODES = ["chol", "pca", "sym", "cdf", "sort"]


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def styles():
    return [jimageio.load_image(p, 64) for p in (STYLE_A, STYLE_B, STYLE_C)]


@pytest.mark.parametrize("hw_in,hw_out", [((7, 9), (13, 5)), ((32, 32), (15, 17)),
                                          ((5, 11), (5, 11)), ((9, 3), (27, 2))])
def test_resize_nearest_matches_jax(hw_in, hw_out, rng):
    x = rng.normal(size=(2, *hw_in, 3)).astype(np.float32)
    ref = np.asarray(jresize.resize_nearest_nhwc(jnp.asarray(x), hw_out))
    got = resize_nearest_nhwc(torch.from_numpy(x), hw_out).numpy()
    np.testing.assert_array_equal(got, ref)


def _maps(rng, n, c=6):
    """n (1, 12, 10, c) feature maps with distinct statistics."""
    return [(rng.normal(i, 1 + i, (1, 12, 10, c)) ** (1 + i % 2)).astype(np.float32)
            for i in range(n)]


@pytest.mark.parametrize("mode", MODES)
def test_mix_pair_matches_jax(mode, rng):
    a, b = _maps(rng, 2)
    mask = np.ceil(rng.uniform(size=(1, 12, 10, 1)) - 0.3).astype(np.float32)
    ref = np.asarray(jcore._mix_pair_jit(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(mask), mode=mode, alpha=0.3))
    # the port's one blend: the N-style blend with weights (1 - alpha, alpha)
    # and the one-hot [m, 1 - m]
    m = torch.from_numpy(mask)
    got = tcore._mix_multi_impl([torch.from_numpy(a), torch.from_numpy(b)],
                                torch.cat([m, 1 - m], dim=-1),
                                torch.tensor([0.7, 0.3]), mode=mode)
    assert _rel_err(got.numpy(), ref) <= 2e-5


@pytest.mark.parametrize("mode", MODES)
def test_mix_multi_matches_jax(mode, rng):
    sfs = _maps(rng, 3)
    w = np.asarray([0.5, 0.3, 0.2], np.float32)
    onehot = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (1, 12, 10))]
    ref = np.asarray(jcore._mix_multi_jit(tuple(map(jnp.asarray, sfs)),
                                          jnp.asarray(onehot), jnp.asarray(w),
                                          mode=mode))
    got = tcore._mix_multi_impl([torch.from_numpy(s) for s in sfs],
                                torch.from_numpy(onehot), torch.from_numpy(w),
                                mode=mode)
    assert _rel_err(got.numpy(), ref) <= 2e-5


@pytest.mark.parametrize("mode", ["chol", "cdf"])
def test_two_style_multi_blend_is_the_pair_blend(mode, rng):
    """From the uniform on: the port's 2-style regions (the inverse cdf of
    (1 - alpha, alpha)) are the reference's ``ceil(u - alpha)`` threshold,
    ties at u == alpha included, and the blend under them is JAX's pair
    blend."""
    a, b = _maps(rng, 2)
    u = rng.uniform(size=(12, 10)).astype(np.float32)
    u[0, :3] = np.float32(0.4)
    synth = tcore.Synthesizer(tconfig.OptexConfig(
        size=32, depth=1, style=["a", "b"], mixing_alpha=0.4), device="cpu")
    w = synth._mix_weights(2)
    regions = tcore._mix_regions(torch.from_numpy(u), w)
    ref_mask = jnp.ceil(jnp.asarray(u) - 0.4)[None, :, :, None]
    np.testing.assert_array_equal(regions.numpy(),
                                  1 - np.asarray(ref_mask)[0, :, :, 0])
    ref = np.asarray(jcore._mix_pair_jit(jnp.asarray(a), jnp.asarray(b), ref_mask,
                                         mode=mode, alpha=0.4))
    got = tcore._mix_multi_impl(
        [torch.from_numpy(a), torch.from_numpy(b)],
        torch.nn.functional.one_hot(regions, 2).float()[None], w, mode=mode)
    assert _rel_err(got.numpy(), ref) <= 1e-5


# ---------------------------------------------------------------------------
# whole runs against JAX Synthesizer.run


def _jax_mask_draws(key, weights=None, alpha=0.5):
    """JAX's own mask draw of pass p as regions: the 2-style blend's
    uniform thresholded as ``ceil(u - alpha)`` (region 1, the second style,
    where that is 0), or (N-style) the categorical regions over the
    normalised weights."""
    def draws(p, hw, n_styles):
        mkey = jax.random.fold_in(jax.random.fold_in(key, p), 7919)
        if weights is None:
            m = jnp.ceil(jax.random.uniform(mkey, hw) - alpha)
            return np.asarray(m == 0).astype(np.int64)
        w = np.asarray(weights, np.float64)
        w = jnp.asarray(w / w.sum(), jnp.float32)
        return np.asarray(jax.random.categorical(mkey, jnp.log(w), shape=hw))
    return draws


def _jax_run(cfg_kw, noise, styles, stream, key, monkeypatch, content=None):
    """JAX Synthesizer.run (fast_codec off, explicit key) with the stage
    rotations injected (tests/test_torch_slice.py)."""
    passes = cfg_kw["passes"]
    order = [(p, i) for p in range(passes) for i in range(3)]
    calls = []

    def fake_stage_rotations(k, n_iters, n):
        p, i = order[len(calls)]
        calls.append((p, i))
        return jnp.asarray(stream(p, i, n_iters, n))

    _clear_jax_stage_caches()
    try:
        monkeypatch.setattr("optimaltextures_tpu.transport.stage_rotations",
                            fake_stage_rotations)
        synth = jcore.Synthesizer(jconfig.OptexConfig(fast_codec=False, **cfg_kw))
        out = np.asarray(synth.run(
            jnp.asarray(noise), list(styles),
            None if content is None else jnp.asarray(content), key=key))
    finally:
        _clear_jax_stage_caches()
    assert calls == order
    return out


def _kw(n_styles, **extra):
    kw = dict(size=64, passes=2, iters=60, no_multires=True, depth=3, seed=SEED,
              no_pca=True, style=["a.png", "b.png", "c.png"][:n_styles])
    kw.update(extra)
    return kw


@pytest.mark.parametrize("n_styles,weights", [(2, None), (3, [1.0, 2.0, 3.0])])
def test_mixing_run_matches_jax_synthesizer(n_styles, weights, styles,
                                            monkeypatch):
    """2 passes of chol, no PCA: the reference's alpha blend (2 styles) and
    the weighted N-style blend, pixel by pixel within 5e-4 (the chol
    synthesis bound)."""
    kw = _kw(n_styles, mixing_weights=weights)
    noise = np.random.default_rng(5).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    stream, key = RotationStream(13), jax.random.key(SEED)
    ref = _jax_run(kw, noise, styles[:n_styles], stream, key, monkeypatch)
    seen = []
    draws = _jax_mask_draws(key, weights)

    def mix_draws(p, hw, n):
        seen.append((p, hw, n))
        return draws(p, hw, n)

    synth = tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu")
    got = synth.run(noise, styles[:n_styles], rotations=stream,
                    mix_draws=mix_draws).numpy()
    # one draw per pass, at relu2's size (the second-deepest depth)
    assert seen == [(0, (32, 32), n_styles), (1, (32, 32), n_styles)]
    assert got.shape == ref.shape == (1, 64, 64, 3)
    assert float(np.abs(got - ref).max()) <= 5e-4
    # the mix really shows: the output differs from the style-A-only run
    single = tcore.Synthesizer(tconfig.OptexConfig(**_kw(1)), device="cpu").run(
        noise, styles[:1], rotations=stream).numpy()
    assert float(np.abs(got - single).mean()) > 0.02


def test_mixing_with_content_matches_jax_synthesizer(styles, monkeypatch):
    """Mixing composes with style transfer: the content is re-centred at
    the PRE-mix style means, then the lum color tail; chol, no PCA, within
    5e-4."""
    kw = _kw(2, content="c.png", content_strength=0.2, color_transfer="lum")
    content = styles[2]
    noise = np.random.default_rng(7).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    stream, key = RotationStream(19), jax.random.key(SEED)
    ref = _jax_run(kw, noise, styles[:2], stream, key, monkeypatch, content)
    got = tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu").run(
        noise, styles[:2], content, rotations=stream,
        mix_draws=_jax_mask_draws(key)).numpy()
    assert got.shape == ref.shape == (1, 64, 64, 3)
    assert float(np.abs(got - ref).max()) <= 5e-4


def test_cdf_mixing_run_matches_jax_by_distribution(styles, monkeypatch):
    """One 64-px cdf pass, two styles: held by the output's distribution
    with the cdf synthesis bounds of tests/test_torch_transfer.py (per
    channel mean 3e-3, std 5e-3, sorted pixels 1e-2 on average): cdf mode
    is chaotic at pass granularity (ROADMAP section 3)."""
    kw = _kw(2, passes=1, hist_mode="cdf")
    noise = np.random.default_rng(6).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    stream, key = RotationStream(43), jax.random.key(SEED)
    ref = _jax_run(kw, noise, styles[:2], stream, key, monkeypatch)
    cdf.reset_launches()
    got = tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu").run(
        noise, styles[:2], rotations=stream,
        mix_draws=_jax_mask_draws(key)).numpy()
    assert all(v == 0 for v in cdf.LAUNCHES.values())
    assert np.isfinite(got).all()
    g, r = got.reshape(-1, 3), ref.reshape(-1, 3)
    assert float(np.abs(g.mean(0) - r.mean(0)).max()) <= 3e-3
    assert float(np.abs(g.std(0) - r.std(0)).max()) <= 5e-3
    assert float(np.abs(np.sort(g, 0) - np.sort(r, 0)).mean()) <= 1e-2


# ---------------------------------------------------------------------------
# RNG contract, validation, api, CLI


def test_mixing_rng_contract(styles):
    kw = dict(size=32, passes=2, iters=8, no_multires=True, depth=2,
              style=["a", "b"])
    noise = np.random.default_rng(2).uniform(size=(1, 32, 32, 3)).astype(np.float32)
    pair = [s[:, :32, :32] for s in styles[:2]]
    seeded = tcore.Synthesizer(tconfig.OptexConfig(seed=4, **kw), device="cpu")
    a = seeded.run(noise, pair)
    assert torch.equal(a, seeded.run(noise, pair))
    o1, _ = tcore.synthesize(tconfig.OptexConfig(seed=4, **kw), pair, device="cpu")
    o2, _ = tcore.synthesize(tconfig.OptexConfig(seed=4, **kw), pair, device="cpu")
    assert torch.equal(o1, o2)
    # another key draws other masks (and rotations)
    assert not torch.equal(a, seeded.run(noise, pair, key=5))
    # passes draw different masks; the pair's draw is regions 0 and 1
    w = seeded._mix_weights(2)
    r0 = seeded._mix_draw(4, 0, (16, 16), w)
    assert torch.equal(r0, seeded._mix_draw(4, 0, (16, 16), w))
    assert not torch.equal(r0, seeded._mix_draw(4, 1, (16, 16), w))
    assert r0.dtype == torch.int64 and set(r0.unique().tolist()) == {0, 1}


def test_categorical_regions_follow_the_weights():
    synth = tcore.Synthesizer(tconfig.OptexConfig(
        size=32, depth=1, style=["a", "b", "c"], mixing_weights=[0.7, 0.2, 0.1]),
        device="cpu")
    w = synth._mix_weights(3)
    np.testing.assert_allclose(w.numpy(), [0.7, 0.2, 0.1], rtol=1e-6)
    regions = synth._mix_draw(11, 0, (256, 256), w)
    assert regions.dtype == torch.int64 and tuple(regions.shape) == (256, 256)
    freqs = np.asarray([(regions == i).float().mean() for i in range(3)])
    np.testing.assert_allclose(freqs, [0.7, 0.2, 0.1], atol=0.02)
    # two styles without weights blend by (1 - alpha, alpha), the second
    # style showing on a share alpha of the mask; three or more by the
    # weights, uniform by default
    pair = tcore.Synthesizer(tconfig.OptexConfig(
        size=32, depth=1, style=["a", "b"], mixing_alpha=0.3), device="cpu")
    w2 = pair._mix_weights(2)
    np.testing.assert_allclose(w2.numpy(), [0.7, 0.3], rtol=1e-6)
    share = float(pair._mix_draw(11, 0, (256, 256), w2).float().mean())
    assert abs(share - 0.3) <= 0.02
    np.testing.assert_allclose(tcore.Synthesizer(tconfig.OptexConfig(
        size=32, depth=1, style=["a", "b", "c"]), device="cpu")._mix_weights(3),
        [1 / 3] * 3, rtol=1e-6)


def test_mixing_validation(styles, tmp_path):
    # mixing is ported: two styles and three weighted styles construct
    tcore.Synthesizer(tconfig.OptexConfig(size=32, depth=1, style=["a", "b"]),
                      device="cpu")
    tcore.Synthesizer(tconfig.OptexConfig(size=32, depth=1, style=["a", "b", "c"],
                                          mixing_weights=[1, 2, 3]), device="cpu")
    for bad in (dict(mixing_weights=[1.0]), dict(mixing_weights=[1.0, -1.0])):
        with pytest.raises(ValueError):
            tconfig.OptexConfig(style=["a", "b"], **bad).validate()
    synth = tcore.Synthesizer(tconfig.OptexConfig(size=32, depth=1, passes=1,
                                                  iters=4, style=["a", "b"]),
                              device="cpu")
    with pytest.raises(ValueError, match="same shape"):
        synth.run(styles[0][:, :32, :32], [styles[0], styles[1][:, :48]])
    with pytest.raises(TypeError, match="keyword"):
        tapi.mix_textures(STYLE_A, STYLE_B, 0.5)
    with pytest.raises(ValueError, match="same shape"):
        tapi.mix_textures(STYLE_A, STYLE_C, size=400, device="cpu",
                          output_dir=str(tmp_path))


def test_api_mix_textures_on_cpu(tmp_path):
    out = tapi.mix_textures(STYLE_A, STYLE_B, alpha=0.3, size=64, passes=1,
                            iters=8, no_multires=True, depth=1, seed=2,
                            device="cpu", output_dir=str(tmp_path))
    assert out.shape == (1, 64, 64, 3) and np.isfinite(out).all()
    assert [p.name for p in tmp_path.iterdir()] == [
        "graffiti_cholhist_256_zebra_pattern_lava_mix3_256_blend0.3_cholhist_"
        "no_multires_64.png"]


@pytest.mark.parametrize("extra,tag", [([], "blend0.5"),
                                       (["--mixing_weights", "1", "2"],
                                        "blendw1.0-2.0")])
def test_cli_mixing_on_cpu_writes_png(extra, tag, tmp_path):
    from optimaltextures_tpu_torch import cli

    cdf.reset_launches()
    rc = cli.main(["--style", STYLE_A, STYLE_B, "--size", "64", "--passes", "1",
                   "--iters", "8", "--no_multires", "--depth", "2", "--seed",
                   "1", "--hist_mode", "cdf", "--device", "cpu", "--output_dir",
                   str(tmp_path), "--quiet", *extra])
    assert rc == 0
    name = (f"graffiti_cholhist_256_zebra_pattern_lava_mix3_256_{tag}_cdfhist_"
            "no_multires_64.png")
    assert (tmp_path / name).exists(), os.listdir(tmp_path)
    assert all(v == 0 for v in cdf.LAUNCHES.values())
