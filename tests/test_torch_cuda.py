"""The port's CUDA kernels on the card: each kernel against its plain PyTorch
version, and a small run through the kernels against the same run on the
CPU. Every test here needs an NVIDIA GPU and skips without one. This file
imports neither jax nor the JAX package, so it also runs where only the
port's dependencies are installed (tests/conftest.py imports jax, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from optimaltextures_tpu_torch import config, core
from optimaltextures_tpu_torch.ops import codec

# |kernel - plain| bound: both sum up to 1152 f32 products, in their own order
REL_TOL = 2e-5


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels do not run on the CPU")
    core.full_f32_precision()


@pytest.mark.cuda
# (40, 56): ragged tiles; (41, 57): odd sizes, ceil-mode pool
@pytest.mark.parametrize("hw", [(48, 80), (40, 56), (41, 57)])
@pytest.mark.parametrize("name,cin,cout,kw,plain_kw", [
    ("rgb_to_relu1", 3, 64, {}, dict(relu=True)),
    ("conv3x3_p2", 64, 64, dict(relu=True, pool=True), dict(relu=True, pool=True)),
    ("conv3x3_p2", 128, 64, dict(relu=True), dict(relu=True)),
    ("conv3x3_p2", 64, 64, dict(relu=False), {}),
    ("conv3x3_full", 64, 128, dict(relu=True), dict(relu=True)),
    ("conv3x3_full", 128, 128, dict(relu=True, pool=True),
     dict(relu=True, pool=True)),
    ("upconv_p2", 64, 64, {}, dict(relu=True, up=True)),
    ("upconv_p2", 128, 128, {}, dict(relu=True, up=True)),
    ("final_to_rgb", 64, 3, {}, {})])
def test_kernel_matches_plain(name, cin, cout, kw, plain_kw, hw):
    _need_gpu()
    h, w = hw
    if name == "upconv_p2":
        h, w = h // 2, w // 2
    g = torch.Generator(device="cuda").manual_seed(cin * cout + h)
    x = torch.rand((2, h, w, cin), generator=g, device="cuda")
    p = codec.pack(torch.randn((cout, cin, 3, 3), generator=g, device="cuda") * 0.1,
                   torch.randn((cout,), generator=g, device="cuda") * 0.1)
    before = codec.LAUNCHES[name]
    got = getattr(codec, name)(x, p, **kw)
    ref = codec.conv3x3_plain(x, p, **plain_kw)
    torch.cuda.synchronize()
    assert codec.LAUNCHES[name] == before + 1
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= REL_TOL * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
def test_kernel_refuses_other_dtypes():
    _need_gpu()
    x = torch.rand((1, 16, 16, 3), device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError):
        codec.rgb_to_relu1(x, codec.pack(
            torch.rand((64, 3, 3, 3), device="cuda", dtype=torch.float64),
            torch.rand(64, device="cuda", dtype=torch.float64)))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [64, 54])   # 54: odd at relu2_1
def test_small_run_on_gpu_matches_cpu(size):
    """2 passes, depth 3, no PCA, injected rotations: the GPU run (through
    every kernel) vs the CPU run (plain versions)."""
    _need_gpu()
    from optimaltextures_tpu_torch.ops.rotation import polar_rotations

    cfg = config.OptexConfig(size=size, passes=2, iters=48, no_pca=True,
                             no_multires=True, seed=0, style=["s.png"])
    rng = np.random.default_rng(0)
    noise = rng.uniform(size=(1, size, size, 3)).astype(np.float32)
    style = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    rots = {}

    def rotations(p, i, n_iters, c):
        if (p, i) not in rots:
            g = torch.as_tensor(rng.standard_normal((n_iters, c, c)))
            rots[(p, i)] = polar_rotations(g).float().numpy()
        return rots[(p, i)]

    codec.reset_launches()
    gpu = core.Synthesizer(cfg, device="cuda").run(noise, [style],
                                                   rotations=rotations)
    assert min(codec.LAUNCHES.values()) > 0
    cpu = core.Synthesizer(cfg, device="cpu").run(noise, [style],
                                                  rotations=rotations)
    assert gpu.shape == cpu.shape
    assert float((gpu.cpu() - cpu).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_gpu_refuses_the_conv2d_codec():
    _need_gpu()
    cfg = config.OptexConfig(size=64, fast_codec=False, style=["s.png"])
    with pytest.raises(ValueError):
        core.Synthesizer(cfg, device="cuda")
