"""The torch port's jax-free foundations against the JAX package: schedule,
config, weights, resize, image naming; plus the port's import isolation and
its device and slice contracts. CPU only."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimaltextures_tpu import config as jconfig
from optimaltextures_tpu.models import vgg as jvgg
from optimaltextures_tpu.ops import resize as jresize
from optimaltextures_tpu.utils import imageio as jimageio
from optimaltextures_tpu.utils import schedule as jschedule
from optimaltextures_tpu_torch import config as tconfig
from optimaltextures_tpu_torch import core as tcore
from optimaltextures_tpu_torch.models import vgg as tvgg
from optimaltextures_tpu_torch.models import weights as tweights
from optimaltextures_tpu_torch.ops import resize as tresize
from optimaltextures_tpu_torch.utils import imageio as timageio
from optimaltextures_tpu_torch.utils import schedule as tschedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("size", [64, 256, 512, 1000])
@pytest.mark.parametrize("passes", [1, 3, 5])
@pytest.mark.parametrize("multires", [True, False])
def test_schedule_matches_jax(size, passes, multires):
    for iters in (8, 500, 777):
        for quirk in (True, False):
            for layers in (1, 3, 5):
                got = tschedule.iters_and_sizes(size, iters, passes, multires,
                                                quirk=quirk, num_layers=layers)
                ref = jschedule.iters_and_sizes(size, iters, passes, multires,
                                                quirk=quirk, num_layers=layers)
                assert got == ref


def test_get_size_and_round32_match_jax():
    for size in (64, 256, 333, 512):
        for scale in (0.5, 1.0, 1.7):
            for h, w in ((256, 256), (300, 517), (1024, 77)):
                for oversize in (True, False):
                    assert tschedule.get_size(size, scale, h, w, oversize) == \
                        jschedule.get_size(size, scale, h, w, oversize)
    assert [tschedule.round32(x) for x in range(200)] == \
        [jschedule.round32(x) for x in range(200)]


def test_config_fields_match_jax():
    names = lambda cls: [(f.name, f.default if f.default is not
                          dataclasses.MISSING else f.default_factory())
                         for f in dataclasses.fields(cls)]
    assert names(tconfig.OptexConfig) == names(jconfig.OptexConfig)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_weights_match_jax_bank(depth):
    jbank = jvgg.VGGBank(depth)
    tbank = tvgg.VGGBank(depth, device="cpu")
    for jp, tp in ((jbank.enc_params[depth], tbank.enc_params[depth]),
                   (jbank.dec_params[depth], tbank.dec_params[depth])):
        assert len(jp) == len(tp)
        for (jw, jb), (tw, tb) in zip(jp, tp):
            # HWIO (JAX) -> OIHW (torch)
            np.testing.assert_array_equal(
                np.asarray(jw).transpose(3, 2, 0, 1), tw.numpy())
            np.testing.assert_array_equal(np.asarray(jb), tb.numpy())


def test_synthetic_bank_and_params_from_numpy_match_jax():
    jbank = jvgg.synthetic_bank(3, seed=4)
    tsyn = tvgg.synthetic_bank(3, seed=4)
    tconv = tweights.params_from_numpy(jbank.enc_params, jbank.dec_params)
    for d in (1, 2, 3):
        for j, a, b in zip(jbank.enc_params[d] + jbank.dec_params[d],
                           tsyn.enc_params[d] + tsyn.dec_params[d],
                           tconv.enc_params[d] + tconv.dec_params[d]):
            np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
            np.testing.assert_array_equal(
                np.asarray(j[0]).transpose(3, 2, 0, 1), a[0].numpy())


@pytest.mark.parametrize("hw", [((64, 64), (32, 48)), ((40, 40), (96, 64))])
def test_resample_matches_jax(hw):
    (hi, wi), (ho, wo) = hw
    np.testing.assert_array_equal(tresize.resample_matrix(hi, ho),
                                  jresize.resample_matrix(hi, ho))
    x = np.random.default_rng(0).uniform(size=(1, hi, wi, 3)).astype(np.float32)
    wh, ww = jresize.resample_pair((hi, wi), (ho, wo))
    ref = np.asarray(jresize.apply_resample(jnp.asarray(x), jnp.asarray(wh),
                                            jnp.asarray(ww)))
    got = tresize.apply_resample(torch.from_numpy(x), torch.from_numpy(wh),
                                 torch.from_numpy(ww)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_output_name_matches_jax():
    for kw in (dict(style=["style/graffiti.jpg"]),
               dict(style=["a/lava-small.png"], hist_mode="pca", size=256,
                    no_pca=True, style_scale=0.5),
               dict(style=["x.jpg"], no_multires=True, tileable=True),
               dict(style=["x.jpg", "y.jpg"], mixing_alpha=0.3)):
        assert timageio.output_name(tconfig.OptexConfig(**kw)) == \
            jimageio.output_name(jconfig.OptexConfig(**kw))


def test_package_imports_without_jax():
    """The port imports no jax and nothing of the JAX package, even where
    they are installed."""
    code = textwrap.dedent("""
        import importlib, importlib.abc, sys
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                for banned in ("jax", "jaxlib", "optimaltextures_tpu"):
                    if name == banned or name.startswith(banned + "."):
                        raise ImportError("blocked: " + name)
                return None
        sys.meta_path.insert(0, Block())
        for m in ("optimaltextures_tpu_torch", "optimaltextures_tpu_torch.core",
                  "optimaltextures_tpu_torch.api", "optimaltextures_tpu_torch.cli",
                  "optimaltextures_tpu_torch.models.fastcodec",
                  "optimaltextures_tpu_torch.ops.codec",
                  "optimaltextures_tpu_torch.utils.imageio"):
            importlib.import_module(m)
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "optimaltextures_tpu" or m.startswith("optimaltextures_tpu.")]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_is_the_gpu():
    """No entry point drops to the CPU unless asked: device None = cuda."""
    cfg = tconfig.OptexConfig(size=64, style=["x.png"])
    if torch.cuda.is_available():
        assert tcore.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcore.Synthesizer(cfg)
    from optimaltextures_tpu_torch import cli

    assert cli.build_parser().parse_args(["--style", "x.png"]).device == "cuda"
    assert tcore.Synthesizer(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("override", [
    dict(content="c.png"), dict(color_transfer="lum"), dict(hist_mode="cdf"),
    dict(hist_mode="sort"), dict(style=["a.png", "b.png"]),
    dict(conv_dtype="bfloat16"), dict(tileable=True), dict(batch=2),
    dict(out_width=64), dict(init="i.png"), dict(pca_bucket=8),
    dict(pca_traced_k=True), dict(batch_chunk=1), dict(cov_propagation=False),
    dict(num_devices=2), dict(spatial_devices=2)])
def test_out_of_slice_settings_raise(override):
    kw = dict(size=64, style=["x.png"])
    kw.update(override)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu")
