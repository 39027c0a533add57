"""The torch port's second slice end to end against the JAX package, on the
CPU: style transfer (a content image, chol, strength 0.2) with the lum and
opt color tails, and hist_mode="cdf" synthesis, through Synthesizer.run at
64 px, depth 3, the real weights, with the same numpy noise and the same
injected stage and color rotations on both sides (the JAX side
monkeypatches transport.stage_rotations and transport.random_rotation).
PCA is off for the pixel comparisons: torch's and JAX's eigh choose
different eigenvector signs, and the content's re-centring at the style's
scalar mean in PC space is not basis-invariant. Plus the CLI on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimaltextures_tpu import config as jconfig
from optimaltextures_tpu import core as jcore
from optimaltextures_tpu import transport as jtransport
from optimaltextures_tpu.ops import colors as jcolors
from optimaltextures_tpu.utils import imageio as jimageio
from optimaltextures_tpu_torch import api as tapi
from optimaltextures_tpu_torch import config as tconfig
from optimaltextures_tpu_torch import core as tcore
from optimaltextures_tpu_torch import transport as ttransport
from optimaltextures_tpu_torch.ops import cdf, codec
from optimaltextures_tpu_torch.ops import colors as tcolors
from test_torch_slice import RotationStream, _clear_jax_stage_caches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = os.path.join(REPO, "docs", "samples")
STYLE = os.path.join(SAMPLES, "graffiti_cholhist_256.png")
CONTENT = os.path.join(SAMPLES, "green-paint-large_city_lum_2048_half.png")
SEED = 0


def _color_rotations(seed=23):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(tcore.COLOR_STEPS):
        q, r = np.linalg.qr(rng.standard_normal((3, 3)))
        q = q * np.sign(np.diag(r))[None, :]
        if np.linalg.det(q) < 0:
            q[:, -1] *= -1
        out.append(q)
    return np.stack(out).astype(np.float32)


def _jax_run(cfg_kw, noise, style, content, stream, color_rots, monkeypatch):
    """JAX Synthesizer.run (fast_codec off) with the stage stream and the
    color rotations injected. The fused run program traces each stage's
    stage_rotations call once (pass-major, deepest first) and the color
    tail's loop body once, with a traced key: the fake random_rotation
    picks color_rots[i] by matching that key against fold_in(base, i)."""
    passes = len(jcore.Synthesizer(jconfig.OptexConfig(**cfg_kw)).sizes)
    order = [(p, i) for p in range(passes) for i in range(3)]
    calls = []

    def fake_stage_rotations(key, n_iters, n):
        p, i = order[len(calls)]
        calls.append((p, i))
        return jnp.asarray(stream(p, i, n_iters, n))

    base = jax.random.fold_in(jax.random.key(SEED), tcore.COLOR_KEY)
    wanted = jnp.stack([jax.random.key_data(jax.random.fold_in(base, i))
                        for i in range(tcore.COLOR_STEPS)])

    def fake_random_rotation(key, n, dtype=jnp.float32):
        assert n == 3
        hit = jnp.all(wanted == jax.random.key_data(key)[None], axis=1)
        return jnp.asarray(color_rots)[jnp.argmax(hit)]

    _clear_jax_stage_caches()
    jcore._pixel_ot_jit.clear_cache()
    try:
        monkeypatch.setattr("optimaltextures_tpu.transport.stage_rotations",
                            fake_stage_rotations)
        monkeypatch.setattr("optimaltextures_tpu.transport.random_rotation",
                            fake_random_rotation)
        synth = jcore.Synthesizer(jconfig.OptexConfig(fast_codec=False, **cfg_kw))
        out = np.asarray(synth.run(
            jnp.asarray(noise), [style],
            None if content is None else jnp.asarray(content)))
    finally:
        _clear_jax_stage_caches()     # drop the programs traced with the fakes
        jcore._pixel_ot_jit.clear_cache()
    assert calls == order
    return out


def _port_run(cfg_kw, noise, style, content, stream, color_rots):
    synth = tcore.Synthesizer(tconfig.OptexConfig(**cfg_kw), device="cpu")
    return synth.run(noise, [style], content, rotations=stream,
                     color_rotations=color_rots).numpy()


@pytest.fixture(scope="module")
def images():
    style = jimageio.load_image(STYLE, 64)
    content = jimageio.maybe_load_content(CONTENT, 96)       # (1, 64, 96, 3)
    return style, content


# (case, config, content shape, the expected pass plan, bound)
CASES = {
    # 2 multires passes at 256 and 96 px; the content loads at --size 96, so
    # the run keeps its 64x96 shape and the color tail applies
    "lum": (dict(size=96, color_transfer="lum"), (64, 96),
            [(256, True, (64, 96)), (96, False, None)], 5e-4),
    # opt: see test_opt_color_tail_matches_jax for the 1e-3 bound and why
    # the whole run is held by mean and max here
    "opt": (dict(size=96, color_transfer="opt"), (64, 96),
            [(256, True, (64, 96)), (96, False, None)], 5e-2),
    # passes at 256 and 32 px: pass 1 resizes the pastiche and the content
    # (from the original 64x48) to 32x32
    "content": (dict(size=32), (64, 48),
                [(256, True, (64, 64)), (32, True, (32, 32))], 5e-4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_transfer_matches_jax_synthesizer(case, images, monkeypatch):
    style, content = images
    extra, hw, want_plan, bound = CASES[case]
    content = np.ascontiguousarray(content[:, :hw[0], :hw[1]])
    noise = np.random.default_rng(5).uniform(size=content.shape).astype(np.float32)
    kw = dict(passes=2, iters=60, depth=3, seed=SEED, no_pca=True,
              style=["graffiti.png"], content="city.png", content_strength=0.2,
              **extra)
    synth = tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu")
    plan = synth._plan_passes(noise.shape[1:3], content.shape[1:3])
    assert plan == want_plan
    assert plan == [tuple(e) for e in jcore.Synthesizer(jconfig.OptexConfig(
        **kw))._plan_passes(noise.shape[1:3], content.shape[1:3])]
    stream, color_rots = RotationStream(31), _color_rotations()
    ref = _jax_run(kw, noise, style, content, stream, color_rots, monkeypatch)
    cdf.reset_launches()
    got = _port_run(kw, noise, style, content, stream, color_rots)
    assert all(v == 0 for v in cdf.LAUNCHES.values())
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= bound, err
    assert float(np.abs(got - ref).mean()) <= 1e-4 if case != "opt" else 1e-3
    if case == "content":
        # the content really pulled: the output is closer to the resized
        # content than the same run without it
        free = tcore.Synthesizer(
            tconfig.OptexConfig(**dict(kw, content=None)), device="cpu").run(
                noise, [style], rotations=stream).numpy()
        small = tcore.apply_resample(torch.from_numpy(content),
                                     *synth._resample_mats((64, 48), (32, 32)))
        assert np.abs(got - small.numpy()).mean() < \
            np.abs(free - small.numpy()).mean()


def test_opt_color_tail_matches_jax(images, monkeypatch):
    """The opt tail's three pixel-space cdf steps, each from the same (JAX)
    state, within 1e-3. The whole opt run above is held by its mean (1e-3)
    and max (5e-2) instead: the stages leave the two pastiches 1.1e-4 apart
    (within the lum bound), and in the tail's first step 25 of the 18,432
    rotated pastiche samples and 41 target samples then land in the
    neighbouring of 256 bins (the first: channel 0, pixel 836, at 142.0014
    bins on one side and 141.9957 on the other), each moving the remap of
    its bin by up to one bin width (~4e-3 of the pixel range)."""
    style, content = images
    extra, hw, _, _ = CASES["opt"]
    noise = np.random.default_rng(5).uniform(size=content.shape).astype(np.float32)
    kw = dict(passes=2, iters=60, depth=3, seed=SEED, no_pca=True,
              style=["graffiti.png"], content="city.png", content_strength=0.2,
              **dict(extra, color_transfer=None))
    stream, color_rots = RotationStream(31), _color_rotations()
    state = np.array(_jax_run(kw, noise, style, content, stream, None,
                              monkeypatch))
    target = jcolors.swap_lightness(jnp.asarray(content), jnp.asarray(state))
    samples = np.array(target).reshape(-1, 3)
    np.testing.assert_allclose(
        tcolors.swap_lightness(torch.from_numpy(content),
                               torch.from_numpy(state)).numpy(),
        np.asarray(target), rtol=0, atol=1e-6)
    for i in range(tcore.COLOR_STEPS):
        monkeypatch.setattr("optimaltextures_tpu.transport.random_rotation",
                            lambda k, n, _r=color_rots[i]: jnp.asarray(_r))
        ref = np.asarray(jtransport.ot_step_cdf(
            jax.random.key(i), jnp.asarray(state), jnp.asarray(samples),
            use_pallas=False))
        got = ttransport.ot_step_cdf(None, torch.from_numpy(state),
                                     torch.from_numpy(samples),
                                     rotation=torch.from_numpy(color_rots[i]))
        assert float(np.abs(got.numpy() - ref).max()) <= 1e-3
        state = np.array(ref)


def test_cdf_synthesis_matches_jax_synthesizer(images, monkeypatch):
    """One 64-px pass, 60 iterations of cdf at relu3/2/1 (C = 256/128/64,
    N = 256/1024/4096 samples), held by the output's distribution: per
    color channel the mean within 3e-3, the standard deviation within 5e-3,
    and the sorted pixel values within 1e-2 on average (the noise input
    sits 0.097 from the reference there).

    Not pixel by pixel (max 2e-3, mean 1e-4 were the aim): the two codecs
    hand relu3 features 5e-5 apart (of 38.8) to the first stage, and in its
    first iteration two rotated samples already fall into the neighbouring
    bin (the first: channel 17, sample 222, at 148.99995 bins on one side
    and 149.00002 on the other). With 256 samples on 256 bins each moved
    count reshapes the remap table; 19 iterations later the two textures
    differ pixel by pixel (94% of pixels by more than 1e-2) while their
    statistics agree — the reference's cdf mode is chaotic at this size."""
    style, _ = images
    noise = np.random.default_rng(6).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    kw = dict(size=64, passes=1, iters=60, no_multires=True, depth=3,
              seed=SEED, no_pca=True, hist_mode="cdf", style=["graffiti.png"])
    stream = RotationStream(41)
    ref = _jax_run(kw, noise, style, None, stream, None, monkeypatch)
    got = _port_run(kw, noise, style, None, stream, None)
    assert got.shape == ref.shape == (1, 64, 64, 3)
    assert np.isfinite(got).all()
    g, r = got.reshape(-1, 3), ref.reshape(-1, 3)
    assert float(np.abs(g.mean(0) - r.mean(0)).max()) <= 3e-3
    assert float(np.abs(g.std(0) - r.std(0)).max()) <= 5e-3
    assert float(np.abs(np.sort(g, 0) - np.sort(r, 0)).mean()) <= 1e-2
    assert float(np.abs(got - noise).mean()) > 0.05


def test_content_prep_matches_jax(images):
    """The content side alone, PCA off: multi-tap encode, re-centred at
    the style's scalar mean, per depth."""
    _, content = images
    kw = dict(size=96, depth=3, style=["s.png"], no_pca=True)
    js = jcore.Synthesizer(jconfig.OptexConfig(**kw))
    ts = tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu")
    means = [0.5, -0.25, 1.0]
    ref = jcore._content_prep_pass_jit(
        js.bank.enc_params[3], jnp.asarray(content), (None,) * 3,
        tuple(jnp.float32(m) for m in means), (None,) * 3, depth=3,
        use_pca=False)
    got = tcore._content_prep_pass(ts.bank.enc_params[3],
                                   torch.from_numpy(content), [None] * 3,
                                   [torch.tensor(m) for m in means], depth=3,
                                   use_pca=False)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-5 * float(np.abs(r).max()))


@pytest.mark.parametrize("anchor", ["index", "depth"])
def test_stage_strengths_follow_the_anchor_rule(anchor):
    kw = dict(size=64, depth=3, style=["s.png"], content="c.png",
              content_strength=0.2, content_anchor=anchor)
    synth = tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu")
    cf = torch.zeros(1, 4, 4, 2)
    stats = tcore.transport.style_stats(torch.ones(1, 4, 4, 2))
    targets = [tcore.LayerTargets(stats, None, cf) for _ in range(3)]
    adj, strengths = synth._stage_strengths(targets)
    # layer-loop positions l = 0, 1, 2 are depths 3, 2, 1
    want = ((0.2 / 16, 0.2 / 8, 0.2 / 4) if anchor == "index"
            else (0.2 / 4, 0.0, 0.0))
    assert strengths == pytest.approx(want)
    assert [t.content is not None for t in adj] == [s != 0 for s in want]


@pytest.mark.parametrize("extra,name", [
    (["--content", CONTENT, "--content_strength", "0.2", "--color_transfer",
      "opt"], "graffiti_cholhist_256_green-paint-large_city_lum_2048_half_"
              "strength0.2_cholhist_no_multires_opt_64.png"),
    (["--hist_mode", "cdf"], "graffiti_cholhist_256_cdfhist_no_multires_64.png")])
def test_cli_on_cpu_writes_png(extra, name, tmp_path):
    from optimaltextures_tpu_torch import cli

    codec.reset_launches()
    cdf.reset_launches()
    rc = cli.main(["--style", STYLE, "--size", "64", "--passes", "1",
                   "--iters", "8", "--no_multires", "--depth", "2", "--seed",
                   "1", "--device", "cpu", "--output_dir", str(tmp_path),
                   "--quiet", *extra])
    assert rc == 0
    assert (tmp_path / name).exists(), os.listdir(tmp_path)
    # on the CPU the wrappers ran their plain versions: no kernel launched
    assert all(v == 0 for v in codec.LAUNCHES.values())
    assert all(v == 0 for v in cdf.LAUNCHES.values())


def test_api_transfer_helpers_on_cpu(tmp_path):
    out = tapi.transfer_color(STYLE, CONTENT, mode="lum", size=64, passes=1,
                              iters=8, no_multires=True, depth=1, seed=2,
                              device="cpu", output_dir=str(tmp_path))
    assert out.shape == (1, 64, 64, 3) and np.isfinite(out).all()
    out = tapi.transfer_style(STYLE, CONTENT, size=64, passes=1, iters=8,
                              no_multires=True, depth=1, seed=2, device="cpu",
                              output_dir=str(tmp_path))
    assert out.shape == (1, 64, 64, 3) and np.isfinite(out).all()
