"""Batch > 1 and ``conv_dtype="bfloat16"`` through the port's Synthesizer,
against the JAX package, on the CPU.

Whole runs at 64 px, depth 3, the real weights, 2 passes, no PCA, batch 2,
with the same numpy noise and the same injected rotation stacks on both
sides (one stack per stage serves the whole batch, as in the JAX package)
and ``fast_codec=False`` on both sides:

* float32: within 5e-4 of JAX's (tests/test_torch_slice.py's bound);
* bfloat16: ``max|port_bf16 - jax_bf16|`` no larger than JAX's own
  ``max|jax_bf16 - jax_f32|`` on the same inputs. bf16 roundings that land
  a rounding apart (torch's and XLA's CPU convs sum in another order) grow
  through the passes the way the bf16 rounding itself does; on these
  inputs the two numbers are 0.0977 and 0.1523;
* cdf mode by distribution, with ROADMAP section 3's bounds (channel mean
  3e-3, std 5e-3, sorted pixels 1e-2): cdf runs are chaotic at pass
  granularity.

Plus the batch contract (moments over B*H*W samples, the shared stats),
the CLI with ``--batch 2 --conv_dtype bfloat16``, and the settings that
stay unported."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimaltextures_tpu.ops import histmatch as jhm
from optimaltextures_tpu.utils import imageio as jimageio
from optimaltextures_tpu_torch import api as tapi
from optimaltextures_tpu_torch import config as tconfig
from optimaltextures_tpu_torch import core as tcore
from optimaltextures_tpu_torch import transport as ttransport
from optimaltextures_tpu_torch.ops import codec
from optimaltextures_tpu_torch.ops import histmatch as thm
from test_torch_slice import SAMPLE, RotationStream, _cfg_kw
from test_torch_transfer import _jax_run

BATCH = 2


@pytest.fixture(scope="module")
def inputs():
    style = jimageio.load_image(SAMPLE, 64)
    noise = np.random.default_rng(5).uniform(
        size=(BATCH, 64, 64, 3)).astype(np.float32)
    return noise, style


def _port(kw, noise, style, stream):
    synth = tcore.Synthesizer(tconfig.OptexConfig(fast_codec=False, **kw),
                              device="cpu")
    return synth.run(noise, [style], rotations=stream).numpy()


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """JAX's batch-2 chol runs in f32 and in bf16, same noise and stream."""
    noise, style = inputs
    mp = pytest.MonkeyPatch()
    try:
        return {dt: _jax_run(_cfg_kw(batch=BATCH, conv_dtype=dt), noise, style,
                             None, RotationStream(17), None, mp)
                for dt in ("float32", "bfloat16")}
    finally:
        mp.undo()


def test_batch2_f32_run_matches_jax(inputs, jax_runs):
    noise, style = inputs
    got = _port(_cfg_kw(batch=BATCH), noise, style, RotationStream(17))
    ref = jax_runs["float32"]
    assert got.shape == ref.shape == (BATCH, 64, 64, 3)
    assert float(np.abs(got - ref).max()) < 5e-4
    # the two images are two textures, each transported away from its noise
    assert float(np.abs(got[0] - got[1]).mean()) > 0.05
    assert float(np.abs(got - noise).mean()) > 0.05


def test_batch2_bf16_run_within_jax_bf16_gap(inputs, jax_runs):
    noise, style = inputs
    got = _port(_cfg_kw(batch=BATCH, conv_dtype="bfloat16"), noise, style,
                RotationStream(17))
    ref = jax_runs["bfloat16"]
    assert got.dtype == np.float32 and got.shape == ref.shape
    port_gap = float(np.abs(got - ref).max())
    jax_gap = float(np.abs(ref - jax_runs["float32"]).max())
    print(f"max|port_bf16 - jax_bf16| = {port_gap:.4f}, "
          f"max|jax_bf16 - jax_f32| = {jax_gap:.4f}")
    assert 0 < port_gap <= jax_gap
    # and bf16 is no f32 run: it moved by about what JAX's bf16 moved
    f32 = _port(_cfg_kw(batch=BATCH), noise, style, RotationStream(17))
    assert 0.2 * jax_gap < float(np.abs(got - f32).max()) <= 2 * jax_gap


@pytest.mark.parametrize("conv_dtype", ["float32", "bfloat16"])
def test_batch2_cdf_run_matches_jax_by_distribution(conv_dtype, inputs,
                                                    monkeypatch):
    noise, style = inputs
    kw = _cfg_kw(batch=BATCH, passes=1, hist_mode="cdf", conv_dtype=conv_dtype)
    stream = RotationStream(41)
    ref = _jax_run(kw, noise, style, None, stream, None, monkeypatch)
    got = _port(kw, noise, style, stream)
    assert got.shape == ref.shape == (BATCH, 64, 64, 3)
    assert np.isfinite(got).all()
    g, r = got.reshape(-1, 3), ref.reshape(-1, 3)
    assert float(np.abs(g.mean(0) - r.mean(0)).max()) <= 3e-3
    assert float(np.abs(g.std(0) - r.std(0)).max()) <= 5e-3
    assert float(np.abs(np.sort(g, 0) - np.sort(r, 0)).mean()) <= 1e-2


def test_moments_take_every_image_of_the_batch(rng):
    """moment_stats: per-image means (B, 1, 1, C), one covariance pooled over
    the B*H*W centred samples, as JAX's; the style's raw samples (cdf/sort)
    flatten B*H*W rows."""
    x = rng.normal(0.0, 1.0, (3, 5, 7, 4)).astype(np.float32)
    x[1] += 2.0
    mu, cov = thm.moment_stats(torch.from_numpy(x))
    jmu, jcov = jhm.moment_stats(jnp.asarray(x))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=1e-4, atol=1e-5)
    xc = (x - x.mean(axis=(1, 2), keepdims=True)).reshape(-1, 4)
    np.testing.assert_allclose(cov.numpy(), xc.T @ xc / xc.shape[0], rtol=1e-4,
                               atol=1e-5)
    st = ttransport.style_stats(torch.from_numpy(x), need_samples=True)
    assert st.samples.shape == (3 * 5 * 7, 4)


def test_synthesize_batch_bf16_on_cpu():
    """core.synthesize draws a (B, H, W, 3) noise batch; the bf16 run returns
    B float32 images, every one its own texture."""
    rng = np.random.default_rng(0)
    style = rng.uniform(size=(1, 48, 48, 3)).astype(np.float32)
    cfg = tconfig.OptexConfig(size=32, passes=1, iters=8, no_multires=True,
                              depth=2, seed=4, batch=3, conv_dtype="bfloat16",
                              style=["s.png"])
    codec.reset_launches()
    out, _ = tcore.synthesize(cfg, [style], device="cpu")
    assert out.shape == (3, 32, 32, 3) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    assert all(float((out[i] - out[j]).abs().mean()) > 1e-3
               for i in range(3) for j in range(i))
    assert all(v == 0 for v in codec.LAUNCHES.values())


def test_content_runs_stay_single_image():
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
    synth = tcore.Synthesizer(tconfig.OptexConfig(size=32, passes=1, iters=4,
                                                  depth=1, style=["s.png"]),
                              device="cpu")
    with pytest.raises(ValueError, match="one image"):
        synth.run(np.concatenate([img, img]), [img], img)


def test_init_with_batch_raises_as_jax():
    cfg = tconfig.OptexConfig(init="i.png", batch=2, style=["s.png"])
    with pytest.raises(ValueError, match="identical"):
        tapi.run_files(cfg, device="cpu")


def test_cli_batch_bf16_writes_one_png_per_image(tmp_path):
    from optimaltextures_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["--style", SAMPLE, "--batch", "2", "--conv_dtype", "bfloat16"])
    assert args.batch == 2 and args.conv_dtype == "bfloat16"
    rc = cli.main(["--style", SAMPLE, "--size", "32", "--passes", "1",
                   "--iters", "4", "--no_multires", "--depth", "2", "--seed",
                   "1", "--batch", "2", "--conv_dtype", "bfloat16", "--device",
                   "cpu", "--output_dir", str(tmp_path), "--quiet"])
    assert rc == 0
    names = sorted(os.listdir(tmp_path))
    assert names == ["graffiti_cholhist_256_cholhist_no_multires_32_1.png",
                     "graffiti_cholhist_256_cholhist_no_multires_32_2.png"], names


# the settings that stayed outside the port until spatial sharding was
# ported (queue 1 item 15b): the 2-D grid and spatial sharding alone
UNPORTED = [dict(num_devices=2, spatial_devices=2), dict(spatial_devices=2)]


def test_require_ported_still_raises_for_every_remaining_row():
    """No row is left: config has no _NOT_PORTED table and no
    require_ported. Each former row's override validates (batch 1 for
    spatial sharding alone) and builds a Synthesizer that is one rank of a
    process group: outside one it names the ways to start ranks, as
    batch-parallel num_devices does."""
    assert not hasattr(tconfig, "_NOT_PORTED")
    assert not hasattr(tconfig, "require_ported")
    base = dict(size=64, batch=2, conv_dtype="bfloat16", style=["x.png"])
    for override in UNPORTED + [dict(num_devices=2)]:
        kw = {**base, **override}
        if "num_devices" not in override:
            kw["batch"] = 1
        cfg = tconfig.OptexConfig(**kw).validate()
        with pytest.raises(RuntimeError, match="spawn.*torchrun"):
            tcore.Synthesizer(cfg, device="cpu")
