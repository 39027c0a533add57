"""The rest of the single-device Synthesizer's settings in the port, against
the JAX package on the CPU: ``out_width`` (the pass plan and whole runs),
``init`` through ``api.run_files``, the iterative ``cov_propagation=False``
loop, ``stage_rotations_masked``, the traced k rule, the ``styles_token``
fingerprint, the on-device uint8 quantize, the prep-prefetch estimate and
``utils/flops.run_flops``; plus the CLI's flags for them, ``validate()``'s
``batch_chunk`` refusals and the environment knobs read at call time.

Whole runs: 64 px, depth 2, 2 passes, no PCA, ``fast_codec=False`` on both
sides, the same numpy noise and the same injected rotation stacks (the JAX
side monkeypatches ``transport.stage_rotations``), within 5e-4
(tests/test_torch_slice.py's bound)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimaltextures_tpu import api as japi
from optimaltextures_tpu import config as jconfig
from optimaltextures_tpu import core as jcore
from optimaltextures_tpu import transport as jtransport
from optimaltextures_tpu.ops import rotation as jrot
from optimaltextures_tpu.utils import flops as jflops
from optimaltextures_tpu.utils import imageio as jimageio
from optimaltextures_tpu_torch import api as tapi
from optimaltextures_tpu_torch import cli
from optimaltextures_tpu_torch import config as tconfig
from optimaltextures_tpu_torch import core as tcore
from optimaltextures_tpu_torch import transport as ttransport
from optimaltextures_tpu_torch.ops import cuda_build
from optimaltextures_tpu_torch.ops import rotation as trot
from optimaltextures_tpu_torch.utils import flops as tflops
from test_torch_slice import SAMPLE, RotationStream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIT = os.path.join(REPO, "docs", "samples", "zebra_pattern_lava_mix3_256.png")
DEPTH = 2
BOUND = 5e-4


def _kw(**extra):
    kw = dict(size=64, passes=2, iters=40, no_multires=True, depth=DEPTH,
              seed=0, no_pca=True, style=["graffiti.png"])
    kw.update(extra)
    return kw


def clear_jax_stage_caches():
    for fn in (jcore._run_stages_jit, jcore._run_stages_jit_nodonate,
               jcore._pass_stages_jit, jcore._pass_stages_jit_resize,
               jcore._run_stages_chunked_jit,
               jcore._run_stages_chunked_jit_nodonate):
        fn.clear_cache()


def stage_order(passes: int, depth: int = DEPTH):
    return [(p, i) for p in range(passes) for i in range(depth)]


def jax_injected(monkeypatch, stream, passes, call):
    """``call()`` with the JAX package's stage_rotations replaced by the
    stream, in the order its run programs trace the stages (pass-major,
    deepest first)."""
    order, calls = stage_order(passes), []

    def fake_stage_rotations(key, n_iters, n):
        p, i = order[len(calls)]
        calls.append((p, i))
        return jnp.asarray(stream(p, i, n_iters, n))

    clear_jax_stage_caches()
    try:
        monkeypatch.setattr("optimaltextures_tpu.transport.stage_rotations",
                            fake_stage_rotations)
        out = np.asarray(call())
    finally:
        clear_jax_stage_caches()     # drop the programs traced with the fake
    assert calls == order
    return out


def jax_run(monkeypatch, cfg_kw, noise, style, stream):
    synth = jcore.Synthesizer(jconfig.OptexConfig(fast_codec=False, **cfg_kw))
    return jax_injected(monkeypatch, stream, cfg_kw["passes"],
                        lambda: synth.run(jnp.asarray(noise), [style]))


def port_run(cfg_kw, noise, style, stream):
    synth = tcore.Synthesizer(tconfig.OptexConfig(fast_codec=False, **cfg_kw),
                              device="cpu")
    return synth.run(noise, [style], rotations=stream).numpy()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are small; with one torch thread a core in each
    of several test processes, their OpenMP regions oversubscribe the CPU
    and run tens of times slower. One thread for this module's tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def style():
    return jimageio.load_image(SAMPLE, 64)


# ---------------------------------------------------------------------------
# out_width


@pytest.mark.parametrize("size,out_width,passes", [
    (64, 128, 2), (512, 576, 5), (512, 768, 5)])
def test_plan_passes_matches_jax(size, out_width, passes):
    kw = dict(size=size, out_width=out_width, passes=passes, depth=3,
              style=["x.png"])
    ts = tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu")
    js = jcore.Synthesizer(jconfig.OptexConfig(**kw))
    for entry in ((size, out_width), (size, size)):
        plan = ts._plan_passes(entry)
        assert plan == [tuple(e) for e in js._plan_passes(entry, None)]
        # the full (H, W) gate: the run ends at (size, out_width), and with
        # out_width 576 at size 512 no pass is skipped
        assert [hw for (_, rs, hw) in plan if rs][-1:] in ([], [(size, out_width)])
        if out_width == 576:
            assert all(rs for (_, rs, _) in plan)


def test_out_width_run_matches_jax(style, monkeypatch):
    """64 x 128 from a 64 x 96 pastiche: the first pass resizes to the
    out_width target, the second does not."""
    kw = _kw(out_width=128)
    noise = np.random.default_rng(5).uniform(size=(1, 64, 96, 3)).astype(np.float32)
    plan = tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu"
                             )._plan_passes((64, 96))
    assert plan == [(64, True, (64, 128)), (64, False, None)]
    stream = RotationStream(23)
    ref = jax_run(monkeypatch, kw, noise, style, stream)
    got = port_run(kw, noise, style, stream)
    assert got.shape == ref.shape == (1, 64, 128, 3)
    assert float(np.abs(got - ref).max()) < BOUND
    # synthesize's noise is (batch, size, out_width, 3)
    out, _ = tcore.synthesize(tconfig.OptexConfig(**_kw(out_width=96, iters=4,
                                                         passes=1)),
                              [style], device="cpu")
    assert out.shape == (1, 64, 96, 3)


# ---------------------------------------------------------------------------
# init


class _PortStream:
    """The port's transport.stage_rotations replaced by the stream, in call
    order (pass-major, deepest first)."""

    def __init__(self, stream, passes):
        self.stream, self.order, self.calls = stream, stage_order(passes), []

    def __call__(self, gen, n_iters, n, device="cpu"):
        p, i = self.order[len(self.calls)]
        self.calls.append((p, i))
        return torch.as_tensor(self.stream(p, i, n_iters, n))


def test_init_run_matches_jax(tmp_path, monkeypatch):
    """api.run_files with an init image on both sides: the init loads at
    ``size`` with oversize=False and starts the run in place of noise."""
    kw = _kw(style=[SAMPLE], init=INIT, fast_codec=False)
    stream = RotationStream(29)
    ref = jax_injected(monkeypatch, stream, 2, lambda: japi.run_files(
        jconfig.OptexConfig(output_dir=str(tmp_path / "jax"), **kw))[0])
    fake = _PortStream(stream, 2)
    monkeypatch.setattr("optimaltextures_tpu_torch.transport.stage_rotations",
                        fake)
    got, _, paths = tapi.run_files(tconfig.OptexConfig(
        output_dir=str(tmp_path / "torch"), **kw), device="cpu")
    assert fake.calls == stage_order(2)
    assert got.shape == ref.shape == (1, 64, 64, 3)
    assert float(np.abs(got - ref).max()) < BOUND
    assert "init-zebra_pattern_lava_mix3_256" in os.path.basename(paths[0])
    init_px = jimageio.load_image(INIT, 64, oversize=False)
    assert float(np.abs(got - init_px).mean()) > 0.02   # it was transported


def test_init_refusals(tmp_path):
    base = dict(size=64, passes=1, iters=4, depth=1, style=[SAMPLE], init=INIT,
                output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="identical"):
        tapi.run_files(tconfig.OptexConfig(batch=2, **base), device="cpu")
    # a content image that loads to another shape than the init
    with pytest.raises(ValueError, match="must match"):
        tapi.run_files(tconfig.OptexConfig(
            content=os.path.join(REPO, "docs", "samples",
                                 "graffiti_cholhist_tileable_256x512.png"),
            **base), device="cpu")


# ---------------------------------------------------------------------------
# the iterative loop


def test_cov_prop_off_matches_jax_and_composed(style, monkeypatch):
    noise = np.random.default_rng(6).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    stream = RotationStream(31)
    kw = _kw(cov_propagation=False)
    ref = jax_run(monkeypatch, kw, noise, style, stream)
    got = port_run(kw, noise, style, stream)
    assert float(np.abs(got - ref).max()) < BOUND
    composed = port_run(_kw(), noise, style, stream)
    # JAX's own bound between the two (tests/test_parallel.py)
    np.testing.assert_allclose(got, composed, rtol=2e-3, atol=2e-3)
    assert float(np.abs(got - composed).max()) > 0.0   # a different loop ran


@pytest.mark.parametrize("mode", ["chol", "pca", "sym"])
def test_moment_steps_match_jax(mode):
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((2, 6, 5, 8)).astype(np.float32)
    style = (rng.standard_normal((1, 7, 7, 8)) * 1.5 + 0.3).astype(np.float32)
    rot = RotationStream(2)(0, 0, 1, 8)[0]
    jst = jtransport.style_stats(jnp.asarray(style), False)
    tst = ttransport.style_stats(torch.from_numpy(style))
    ref = np.asarray(jtransport._moment_step_with_rot(
        jnp.asarray(rot), jnp.asarray(feat), jst, mode, 1.0))
    got = ttransport.ot_step_moment(None, torch.from_numpy(feat), tst, mode,
                                    rotation=torch.from_numpy(rot)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)


# ---------------------------------------------------------------------------
# bucketed and traced k


@pytest.mark.parametrize("n,k", [(8, 3), (16, 16), (12, 1)])
def test_stage_rotations_masked_matches_jax(n, k):
    key = jax.random.key(11)
    ref = np.asarray(jrot.stage_rotations_masked(key, 5, n, jnp.int32(k)))
    g = torch.from_numpy(np.array(jax.random.normal(key, (5, n, n),
                                                      dtype=jnp.float32)))
    got = trot.masked_polar_rotations(g, torch.tensor(k, dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    # blockdiag(SO(k), I): the pad block is exactly the identity
    assert np.array_equal(got[:, k:, k:], np.broadcast_to(np.eye(n - k), (5, n - k, n - k)))
    assert not got[:, :k, k:].any() and not got[:, k:, :k].any()
    np.testing.assert_allclose(np.linalg.det(got.astype(np.float64)), 1.0, atol=1e-4)
    # the generator path draws the stage's Gaussian and masks it
    gen = trot.generator("cpu", 4, 0, 1)
    full = trot.stage_rotations_masked(gen, 5, n, torch.tensor(k), "cpu")
    assert full.shape == (5, n, n)


def test_traced_ks_match_jax():
    rng = np.random.default_rng(0)
    svals = []
    for c in (16, 64, 128, 256):
        s = np.sort(rng.gamma(0.7, size=c))[::-1] ** 2
        svals.append(s.astype(np.float32))
    svals.append(np.array([10.0, 0.1, 0.1, 0.1], np.float32))   # k clamps to 1
    ref = [int(k) for k in jcore._traced_ks_jit(tuple(jnp.asarray(s) for s in svals))]
    got = tcore._traced_ks([torch.from_numpy(s) for s in svals])
    assert [int(k) for k in got] == ref
    assert all(k.dtype == torch.int32 and k.dim() == 0 for k in got)
    assert ref[-1] == 1
    # the host rule agrees away from the f32/f64 boundary
    assert [ttransport.choose_k(s) for s in svals] == ref


def test_choose_widths_bucket_and_traced():
    spectra_sv = [torch.tensor([5.0, 4.0, 3.0, 2.0, 1.0, 0.5, 0.1, 0.1] * 8)]
    spectra = [(torch.zeros(1, 4, 4, 64), spectra_sv[0], torch.eye(64))]
    true_k = ttransport.choose_k(spectra_sv[0])
    for kw, widths in ((dict(pca_bucket=16), (-(-true_k // 16) * 16,)),
                       (dict(pca_bucket=1024), (64,)),
                       (dict(pca_traced_k=True), (64,)),
                       (dict(), (true_k,)), (dict(no_pca=True), (0,))):
        synth = tcore.Synthesizer(tconfig.OptexConfig(size=32, depth=1,
                                                      style=["x"], **kw),
                                  device="cpu")
        got, masks = synth._choose_widths(spectra)
        assert got == widths, kw
        if kw.get("pca_bucket") or kw.get("pca_traced_k"):
            assert int(masks[0]) == true_k
        else:
            assert masks == (None,)


# ---------------------------------------------------------------------------
# the styles_token fingerprint, quantize, the prefetch estimate, flops


def test_styles_fingerprint_matches_jax():
    rng = np.random.default_rng(1)
    for shapes in ([(1, 64, 64, 3)], [(1, 37, 300, 3), (1, 37, 300, 3)],
                   [(1, 8, 8, 3)]):
        styles = [rng.uniform(size=s).astype(np.float32) for s in shapes]
        ref = jcore._styles_fingerprint(styles)
        assert tcore._styles_fingerprint(styles) == ref
        assert tcore._styles_fingerprint([torch.from_numpy(s) for s in styles]) == ref
    a = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    b = a.copy()
    b[0, 0, 0, 0] += 0.5            # a sampled pixel
    assert tcore._styles_fingerprint([a]) != tcore._styles_fingerprint([b])


def test_quantize_matches_jax():
    x = np.concatenate([
        np.random.default_rng(2).uniform(-0.2, 1.2, size=4000),
        [0.0, 1.0, -0.0, 0.5 / 255, 1.5 / 255, 254.5 / 255, 1e-9, 1 - 1e-7,
         np.nextafter(np.float32(0.5 / 255), 0)]]).astype(np.float32)
    ref = np.asarray(jcore._quant_u8_jit(jnp.asarray(x)))
    got = tcore._quant_u8(torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, ref)


@pytest.mark.parametrize("size,out_width,style_hw", [
    (512, None, (512, 512)), (4096, None, (4096, 4096)), (256, 384, (300, 517))])
def test_prep_prefetch_bytes_matches_jax(size, out_width, style_hw):
    kw = dict(size=size, out_width=out_width, passes=5, depth=3,
              style=["x.png"], style_scale=1.0)
    ts = tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu")
    js = jcore.Synthesizer(jconfig.OptexConfig(**kw))
    styles = [np.zeros((1, *style_hw, 3), np.float32)]
    hw = (size, out_width or size)
    plan = ts._plan_passes(hw)
    assert ts._prep_prefetch_bytes(plan, styles) == \
        js._prep_prefetch_bytes(js._plan_passes(hw, None), styles)


def test_run_flops_matches_jax():
    kw = dict(size=512, passes=5, depth=3, style=["x.png"])
    ts = tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu")
    js = jcore.Synthesizer(jconfig.OptexConfig(**kw))
    for ks in ([(40, 60, 120)] * 5, [(0, 0, 0)] * 5,
               [(10, 20, 30), (11, 21, 31), (12, 22, 32), (13, 23, 33),
                (64, 128, 256)]):
        for hw, style_hws in (((512, 512), [(512, 512)]),
                              ((256, 256), [(300, 517), (300, 517)])):
            assert tflops.run_flops(ts, hw, style_hws, ks) == \
                jflops.run_flops(js, hw, style_hws, ks)
    assert tflops.transport_loop_flops(4096, 37, 11) == \
        jflops.transport_loop_flops(4096, 37, 11)


def test_last_run_ks_feed_run_flops(style):
    synth = tcore.Synthesizer(tconfig.OptexConfig(**_kw(no_pca=False, iters=4,
                                                        passes=1)),
                              device="cpu")
    synth.run(np.zeros((1, 64, 64, 3), np.float32) + 0.5, [style])
    assert len(synth.last_run_ks) == 1 and len(synth.last_run_ks[0]) == DEPTH
    assert all(0 < k <= c for k, c in zip(synth.last_run_ks[0], (128, 64)))
    assert tflops.run_flops(synth, (64, 64), [(64, 64)], synth.last_run_ks) > 0


# ---------------------------------------------------------------------------
# config, environment, CLI


@pytest.mark.parametrize("override,match", [
    (dict(batch_chunk=2, hist_mode="cdf"), "moment hist_mode"),
    (dict(batch_chunk=2, hist_mode="sort"), "moment hist_mode"),
    (dict(batch_chunk=2, cov_propagation=False), "cov_propagation"),
    (dict(batch_chunk=3), "not divisible"),
    (dict(batch_chunk=2, content="c.png"), "synthesis only"),
    (dict(batch_chunk=2, spatial_devices=2), "spatial"),
    (dict(batch_chunk=4, num_devices=2), "per-device batch"),
    (dict(batch_chunk=-1), ">= 0")])
def test_validate_refuses_batch_chunk_like_jax(override, match):
    kw = dict(size=64, batch=4, style=["x.png"])
    kw.update(override)
    with pytest.raises(ValueError, match=match) as err:
        tconfig.OptexConfig(**kw).validate()
    with pytest.raises(ValueError) as jerr:
        jconfig.OptexConfig(**kw).validate()
    assert str(err.value) == str(jerr.value)
    ok = dict(size=64, batch=4, batch_chunk=2, style=["x.png"])
    tconfig.OptexConfig(**ok).validate()


def test_env_knobs_read_at_call_time(monkeypatch):
    monkeypatch.delenv("OPTEX_PREP_PREFETCH_GB", raising=False)
    monkeypatch.delenv("OPTEX_NO_COV_PROP", raising=False)
    assert tconfig.prep_prefetch_bytes() == 4 * 2 ** 30 == \
        jconfig.prep_prefetch_bytes()
    assert ttransport.cov_propagation_enabled()
    synth = tcore.Synthesizer(tconfig.OptexConfig(size=32, depth=1,
                                                  style=["x"]), device="cpu")
    monkeypatch.setenv("OPTEX_PREP_PREFETCH_GB", "0.5")
    monkeypatch.setenv("OPTEX_NO_COV_PROP", "1")
    assert tconfig.prep_prefetch_bytes() == 2 ** 29 == jconfig.prep_prefetch_bytes()
    assert synth._prep_budget_bytes() == 2 ** 29
    assert not ttransport.cov_propagation_enabled()
    assert tconfig.cov_propagation_env_off() == jconfig.cov_propagation_env_off()
    monkeypatch.setattr(tcore.Synthesizer, "_PREP_PREFETCH_BYTES", 123)
    assert synth._prep_budget_bytes() == 123
    # a chunked run refuses the env switch instead of running unchunked
    chunked = tcore.Synthesizer(tconfig.OptexConfig(
        size=32, depth=1, batch=2, batch_chunk=1, style=["x"]), device="cpu")
    with pytest.raises(ValueError, match="OPTEX_NO_COV_PROP"):
        chunked.run(np.zeros((2, 32, 32, 3), np.float32),
                    [np.zeros((1, 32, 32, 3), np.float32)])


def test_cli_parses_the_nine_flags():
    args = cli.build_parser().parse_args([
        "--style", "x.png", "--init", "i.png", "--out_width", "96",
        "--pca_bucket", "16", "--batch_chunk", "2", "--no_cov_prop",
        "--no_fast_codec", "--profile_dir", "p", "--cache_dir", "c"])
    assert (args.init, args.out_width, args.pca_bucket, args.batch_chunk,
            args.no_cov_prop, args.no_fast_codec, args.profile_dir,
            args.cache_dir) == ("i.png", 96, 16, 2, True, True, "p", "c")
    assert cli.build_parser().parse_args(
        ["--style", "x.png", "--pca_traced_k"]).pca_traced_k
    d = cli.build_parser().parse_args(["--style", "x.png"])
    assert (d.init, d.out_width, d.pca_bucket, d.pca_traced_k, d.batch_chunk,
            d.no_cov_prop, d.no_fast_codec, d.profile_dir, d.cache_dir) == \
        (None, None, 0, False, 0, False, False, None, "")
    assert cli.build_parser().parse_args(["--style", "x.png", "--tileable"]).tileable
    assert not d.tileable
    # the three multi-device flags of the JAX CLI, with its defaults
    m = cli.build_parser().parse_args(["--style", "x.png", "--num_devices",
                                       "2", "--spatial_devices", "4",
                                       "--style_parallel"])
    assert (m.num_devices, m.spatial_devices, m.style_parallel) == (2, 4, True)
    assert (d.num_devices, d.spatial_devices, d.style_parallel) == (1, 1, False)
    with pytest.raises(SystemExit):   # a switch takes no value
        cli.build_parser().parse_args(["--style", "x.png", "--style_parallel",
                                       "2"])


def test_cli_runs_the_new_settings_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    common = ["--style", SAMPLE, "--size", "64", "--passes", "1", "--iters",
              "6", "--no_multires", "--depth", "2", "--seed", "1", "--device",
              "cpu", "--quiet"]
    runs = [(["--init", INIT, "--pca_bucket", "16", "--no_cov_prop",
              "--no_fast_codec"], "init-zebra_pattern_lava_mix3_256",
             "cholhist_no_multires_64.png"),
            (["--out_width", "96", "--pca_traced_k", "--batch", "2",
              "--batch_chunk", "1", "--cache_dir", str(tmp_path / "kernels"),
              "--profile_dir", str(tmp_path / "prof")], "64x96", "64x96_1.png")]
    for extra, tag, tail in runs:
        out = tmp_path / tag
        assert cli.main(common + extra + ["--output_dir", str(out)]) == 0
        pngs = sorted(os.listdir(out))
        assert pngs and tag in pngs[0] and pngs[0].endswith(tail), pngs
    assert cuda_build.BUILD_DIR == str(tmp_path / "kernels")
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    cuda_build.set_build_dir("")
    assert cuda_build.BUILD_DIR == cuda_build.DEFAULT_BUILD_DIR
