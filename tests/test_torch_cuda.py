"""The port's CUDA kernels on the card: each kernel against its plain PyTorch
version, and small runs through the kernels (synthesis, cdf synthesis,
style transfer with the opt color tail, texture mixing) against the same
runs on the CPU.
Every test here needs an NVIDIA GPU and skips without one. This file
imports neither jax nor the JAX package, so it also runs where only the
port's dependencies are installed (tests/conftest.py imports jax, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from optimaltextures_tpu_torch import config, core
from optimaltextures_tpu_torch.ops import cdf, codec, conv64, histmatch
from optimaltextures_tpu_torch.ops.rotation import polar_rotations

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
    pack = codec.pack_up if name == "upconv_p2" else codec.pack
    p = pack(torch.randn((cout, cin, 3, 3), generator=g, device="cuda") * 0.1,
             torch.randn((cout,), generator=g, device="cuda") * 0.1)
    before = codec.LAUNCHES[name]
    got = getattr(codec, name)(x, p, **kw)
    ref = codec.conv3x3_plain(x, p, **plain_kw)
    torch.cuda.synchronize()
    assert codec.LAUNCHES[name] == before + 1
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= REL_TOL * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
# each kernel's two main-path shapes (512 px), odd and ragged sizes (pooled
# 41 x 57, 35 x 19; coarse 17 x 23, and one coarse row), batch 1, 2 and 3,
# and inputs whose magnitudes spread over 1e-3 .. 1e3 (log-uniform, random
# signs)
@pytest.mark.parametrize("name,cin,kw,n,hw,wide", [
    ("conv3x3_full", 64, dict(relu=True), 2, (256, 256), False),
    ("conv3x3_full", 128, dict(relu=True, pool=True), 2, (256, 256), False),
    ("conv3x3_full", 64, dict(relu=False), 2, (33, 47), True),
    ("conv3x3_full", 128, dict(relu=True, pool=True), 2, (35, 19), True),
    ("conv3x3_full", 128, dict(relu=False, pool=True), 2, (256, 256), True),
    ("conv3x3_p2", 64, dict(relu=True, pool=True), 1, (512, 512), False),
    ("conv3x3_p2", 128, dict(relu=True), 1, (256, 256), False),
    ("conv3x3_p2", 64, dict(relu=True, pool=True), 3, (41, 57), True),
    ("conv3x3_p2", 128, dict(relu=False, pool=True), 3, (41, 57), False),
    ("conv3x3_p2", 128, dict(relu=False), 1, (35, 19), True),
    ("upconv_p2", 128, {}, 1, (128, 128), False),
    ("upconv_p2", 64, {}, 1, (256, 256), False),
    ("upconv_p2", 128, {}, 3, (17, 23), True),
    ("upconv_p2", 64, {}, 3, (17, 23), False),
    ("upconv_p2", 64, {}, 2, (1, 3), True)])
def test_tensor_core_kernels_match_plain(name, cin, kw, n, hw, wide):
    """The three tensor-core codec kernels run 3xTF32 on mma.sync: within
    2e-5 x max|plain| of the f32 plain version."""
    _need_gpu()
    h, w = hw
    g = torch.Generator(device="cuda").manual_seed(cin + h + w + n)
    x = torch.rand((n, h, w, cin), generator=g, device="cuda")
    if wide:
        mag = 10.0 ** (6.0 * torch.rand(x.shape, generator=g, device="cuda") - 3.0)
        x = torch.where(x < 0.5, -mag, mag)
    cout = {"conv3x3_full": 128, "conv3x3_p2": 64, "upconv_p2": cin}[name]
    pack = codec.pack_up if name == "upconv_p2" else codec.pack
    p = pack(torch.randn((cout, cin, 3, 3), generator=g, device="cuda") * 0.1,
             torch.randn((cout,), generator=g, device="cuda") * 0.1)
    plain_kw = dict(relu=True, up=True) if name == "upconv_p2" else kw
    before = codec.LAUNCHES[name]
    got = getattr(codec, name)(x, p, **kw)
    ref = codec.conv3x3_plain(x, p, **plain_kw)
    torch.cuda.synchronize()
    assert codec.LAUNCHES[name] == before + 1
    assert got.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= REL_TOL * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
# both main-path sizes (512^2, 256^2), ragged sizes whose last 16 x 16 tile
# is one row or one column (17 x 33, 33 x 17, 300 x 47), H or W = 2, one
# whole tile, batch 1-3, and inputs whose magnitudes spread over 1e-3 .. 1e3
@pytest.mark.parametrize("name", ["final_to_rgb", "rgb_to_relu1"])
@pytest.mark.parametrize("n,hw,wide", [
    (1, (512, 512), False), (1, (256, 256), False), (2, (17, 33), True),
    (3, (33, 17), False), (1, (2, 2), False), (2, (2, 37), True),
    (3, (45, 2), False), (2, (16, 16), True), (1, (300, 47), True)])
def test_edge_convs_match_plain(name, n, hw, wide):
    """The two bytes-bound kernels (TMA, persistent over 16 x 16 tiles,
    final_to_rgb's reflect halo repaired after the load): within 2e-5 x
    max|plain| of the plain version."""
    _need_gpu()
    h, w = hw
    cin, cout = (64, 3) if name == "final_to_rgb" else (3, 64)
    g = torch.Generator(device="cuda").manual_seed(cin + 7 * h + w + n)
    x = torch.rand((n, h, w, cin), generator=g, device="cuda")
    if wide:
        mag = 10.0 ** (6.0 * torch.rand(x.shape, generator=g, device="cuda") - 3.0)
        x = torch.where(x < 0.5, -mag, mag)
    p = codec.pack(torch.randn((cout, cin, 3, 3), generator=g, device="cuda") * 0.1,
                   torch.randn((cout,), generator=g, device="cuda") * 0.1)
    before = codec.LAUNCHES[name]
    got = getattr(codec, name)(x, p)
    ref = codec.conv3x3_plain(x, p, relu=name == "rgb_to_relu1")
    torch.cuda.synchronize()
    assert codec.LAUNCHES[name] == before + 1
    assert got.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= REL_TOL * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["final_to_rgb", "rgb_to_relu1"])
def test_edge_convs_repeated_launches_agree(name):
    """Each output sums in a fixed order whichever block takes its tile, so
    100 launches at 512^2 equal the first bit for bit (a race in
    final_to_rgb's TMA ring or rgb_to_relu1's double-buffered staging would
    show as a launch that does not)."""
    _need_gpu()
    cin, cout = (64, 3) if name == "final_to_rgb" else (3, 64)
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.rand((1, 512, 512, cin), generator=g, device="cuda")
    p = codec.pack(torch.randn((cout, cin, 3, 3), generator=g, device="cuda") * 0.1,
                   torch.randn((cout,), generator=g, device="cuda") * 0.1)
    kern = getattr(codec, name)
    first = kern(x, p)
    differ = sum(not torch.equal(kern(x, p), first) for _ in range(100))
    assert differ == 0


@pytest.mark.cuda
def test_final_to_rgb_refuses_a_misaligned_input():
    """final_to_rgb reads its input by TMA, which needs a 16-byte-aligned
    base: a contiguous view 4 bytes into its storage raises, launching
    nothing and falling back to nothing."""
    _need_gpu()
    x = torch.rand(16 * 16 * 64 + 1, device="cuda")[1:].view(1, 16, 16, 64)
    p = codec.pack(torch.rand((3, 64, 3, 3), device="cuda"), torch.rand(3, device="cuda"))
    before = codec.LAUNCHES["final_to_rgb"]
    with pytest.raises(ValueError, match="aligned"):
        codec.final_to_rgb(x, p)
    assert codec.LAUNCHES["final_to_rgb"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("name,cin,cout", [("conv3x3_p2", 64, 64),
                                           ("conv3x3_full", 128, 128),
                                           ("upconv_p2", 64, 64)])
def test_tensor_core_kernels_refuse_weights_without_fragments(name, cin, cout):
    """A CUDA tensor whose Packed lacks the kernel's split weights raises
    (an upconv takes pack_up's folded taps, not pack's w_tc); nothing falls
    back to the plain version."""
    _need_gpu()
    x = torch.rand((1, 16, 16, cin), device="cuda")
    w, b = torch.rand((cout, cin, 3, 3), device="cuda"), torch.rand(cout, device="cuda")
    kw = {} if name == "upconv_p2" else dict(relu=True)
    before = codec.LAUNCHES[name]
    for p in (codec.Packed(w, b, w.permute(2, 3, 1, 0).contiguous()),
              (codec.pack if name == "upconv_p2" else codec.pack_up)(w, b)):
        with pytest.raises(ValueError):
            getattr(codec, name)(x, p, **kw)
    assert codec.LAUNCHES[name] == before


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
    assert min(codec.LAUNCHES[k] for k in codec.KERNELS) > 0
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


# ---------------------------------------------------------------------------
# the cdf kernels (csrc/cdf.cu)


def _rows(c, n, seed, pile=False, constant=None, offset=0):
    """(C, N) rows of N(0.5, 2) samples with their ranges; ``offset`` > 0
    makes them a contiguous view whose base is that many floats past a
    16-byte boundary (so no row is aligned as the allocator aligns)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((c * n + offset,), generator=g, device="cuda") * 2.0 + 0.5
         )[offset:].view(c, n)
    if constant is not None:
        x[constant] = 1.25
    lo, hi = x.min(dim=1).values, x.max(dim=1).values
    if pile:
        x[0, : n // 7] = hi[0]           # a pile on the top edge
    return x, lo, hi


@pytest.mark.cuda
# odd N, C = 3, C not a multiple of 8, a constant channel, a top-edge pile,
# and the 512-px relu1 shape
@pytest.mark.parametrize("c,n,constant,pile", [
    (3, 262144, None, False), (3, 1001, None, True), (5, 4099, 2, False),
    (13, 70001, None, True), (1, 300, 0, False), (32, 262144, 7, True),
    (4, 1002, None, False), (96, 4096, 5, True), (3, 262144, 1, False)])
def test_histogram_kernel_matches_plain_exactly(c, n, constant, pile):
    _need_gpu()
    x, lo, hi = _rows(c, n, c * n, pile, constant)
    before = cdf.LAUNCHES["batched_histogram"]
    got = cdf.batched_histogram(x, lo, hi)
    ref = cdf.histogram_plain(x, lo, hi)
    torch.cuda.synchronize()
    assert cdf.LAUNCHES["batched_histogram"] == before + 1
    assert torch.equal(got, ref)
    assert float(got.sum()) == c * n
    for i in range(c):
        if i != constant:
            assert torch.equal(got[i], torch.histc(x[i], 256, float(lo[i]),
                                                   float(hi[i])))
    if constant is not None:
        assert float(got[constant, 0]) == n


@pytest.mark.cuda
# the cdf step's shapes (relu1 C = 24 and pixels C = 3 at 512^2, the 256-px
# relu3 at C = 96 x 64^2), Nt != Ns, N % 4 in {1, 2, 3}, rows whose base is
# not 16-byte aligned, constant channels of 512^2 samples
@pytest.mark.parametrize("c,nt,ns,offset,constant", [
    (24, 262144, 262144, 0, None), (3, 262144, 262144, 0, 2),
    (96, 4096, 4096, 0, None), (5, 1001, 1002, 0, None),
    (7, 4099, 4097, 1, 3), (13, 70001, 65538, 1, None),
    (3, 262144, 262141, 2, 0), (2, 3, 9, 3, None)])
def test_histogram_pair_kernel_matches_plain_exactly(c, nt, ns, offset, constant):
    _need_gpu()
    t, _, _ = _rows(c, nt, c * nt + 1, pile=True, constant=constant, offset=offset)
    s, _, _ = _rows(c, ns, c * ns + 2, constant=constant, offset=(offset * 3) % 4)
    lo = torch.minimum(t.min(dim=1).values, s.min(dim=1).values)
    hi = torch.maximum(t.max(dim=1).values, s.max(dim=1).values)
    before = cdf.LAUNCHES["batched_histogram"]
    got_t, got_s = cdf.histogram_pair(t, s, lo, hi)
    torch.cuda.synchronize()
    assert cdf.LAUNCHES["batched_histogram"] == before + 1
    for got, x, n in ((got_t, t, nt), (got_s, s, ns)):
        assert torch.equal(got, cdf.histogram_plain(x, lo, hi))
        assert float(got.sum()) == c * n
        for i in range(c):
            if i != constant:
                assert torch.equal(got[i], torch.histc(x[i], 256, float(lo[i]),
                                                       float(hi[i])))
        if constant is not None:
            assert float(got[constant, 0]) == n


@pytest.mark.cuda
@pytest.mark.parametrize("c,n", [(24, 262144), (3, 262144), (96, 4096)])
def test_histogram_pair_repeated_launches_agree(c, n):
    """The cluster sums its counts in integers and stores them: 100 launches
    give the first launch's counts bit for bit."""
    _need_gpu()
    t, _, _ = _rows(c, n, 11, pile=True)
    s, _, _ = _rows(c, n, 12)
    lo = torch.minimum(t.min(dim=1).values, s.min(dim=1).values)
    hi = torch.maximum(t.max(dim=1).values, s.max(dim=1).values)
    first = cdf.histogram_pair(t, s, lo, hi)
    differ = sum(not all(torch.equal(a, b) for a, b in
                         zip(cdf.histogram_pair(t, s, lo, hi), first))
                 for _ in range(100))
    assert differ == 0


def _pwl_case(c, n, const_t, const_s, offset=0):
    t, _, _ = _rows(c, n, c + n, pile=True, offset=offset)
    s, _, _ = _rows(c, n + 57, c * 7 + n)
    if const_t is not None:
        t[const_t] = 0.75
    if const_s is not None:
        s[const_s] = -1.0
        t[const_s] = -1.0                # a degenerate shared range
    lo = torch.minimum(t.min(dim=1).values, s.min(dim=1).values)
    hi = torch.maximum(t.max(dim=1).values, s.max(dim=1).values)
    t_hist = cdf.histogram_plain(t, lo, hi)
    s_hist = cdf.histogram_plain(s, lo, hi)
    t_cdf, s_cdf = histmatch.cdf_cdfs_rows(t_hist, s_hist)
    remapped = histmatch._remap_table_rows(t_cdf, s_cdf,
                                           histmatch._edges_rows(lo, hi, 256))
    return t, remapped, lo, hi


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,const_t,const_s", [
    (3, 262144, None, None), (3, 1001, 1, None), (5, 4099, None, 4),
    (13, 70001, 3, 11), (32, 262144, None, None)])
def test_pwl_kernel_matches_plain(c, n, const_t, const_s):
    _need_gpu()
    t, remapped, lo, hi = _pwl_case(c, n, const_t, const_s)
    before = cdf.LAUNCHES["pwl_remap"]
    got = cdf.pwl_remap(t, remapped, lo, hi)
    ref = cdf.pwl_remap_plain(t, remapped, lo, hi)
    torch.cuda.synchronize()
    assert cdf.LAUNCHES["pwl_remap"] == before + 1
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(got, ref)   # the same rounded operations, in order
    if const_s is not None:
        assert bool((got[const_s] == remapped[const_s, 0]).all())


@pytest.mark.cuda
# N % 4 in {1, 2, 3}, rows whose base is 1-3 floats past a 16-byte
# boundary, the 256-px relu3 shape, and the relu1 shape unaligned
@pytest.mark.parametrize("c,n,offset,const_s", [
    (24, 262144, 1, None), (96, 4096, 0, 7), (5, 1002, 2, 1), (7, 4099, 3, None),
    (13, 70001, 1, 4), (3, 262147, 0, None), (2, 3, 1, None)])
def test_pwl_kernel_equals_plain_on_ragged_and_unaligned_rows(c, n, offset, const_s):
    _need_gpu()
    t, remapped, lo, hi = _pwl_case(c, n, None, const_s, offset)
    assert t.data_ptr() % 16 == 4 * offset
    got = cdf.pwl_remap(t, remapped, lo, hi)
    ref = cdf.pwl_remap_plain(t, remapped, lo, hi)
    torch.cuda.synchronize()
    assert got.shape == t.shape and got.is_contiguous()
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cdf_plain_versions_refuse_the_gpu():
    _need_gpu()
    x, lo, hi = _rows(3, 100, 1)
    with pytest.raises(ValueError):
        histmatch.histogram_rows(x, lo, hi, use_pallas=False)
    with pytest.raises(ValueError):
        histmatch.cdf_match_rows(x, x, use_pallas=False)
    cfg = config.OptexConfig(size=64, use_pallas=False, hist_mode="cdf",
                             style=["s.png"])
    with pytest.raises(ValueError):
        core.Synthesizer(cfg, device="cuda")
    with pytest.raises(TypeError):
        cdf.batched_histogram(x.double(), lo.double(), hi.double())


def _gpu_vs_cpu(cfg, content_shape=None):
    """One run on the GPU (kernels) and the same run on the CPU (plain
    versions): same noise, style, content and injected rotations."""
    rng = np.random.default_rng(0)
    shape = content_shape or (1, cfg.size, cfg.size, 3)
    noise = rng.uniform(size=shape).astype(np.float32)
    # a style with structure at every VGG depth: blobs of three sizes + grain
    style = sum(np.kron(rng.uniform(-a, a, (1, cells, cells, 3)),
                        np.ones((1, 64 // cells, 64 // cells, 1)))
                for cells, a in ((4, 0.5), (16, 0.3), (64, 0.2)))
    style = np.clip(0.5 + style, 0.0, 1.0).astype(np.float32)
    content = (rng.uniform(size=content_shape).astype(np.float32)
               if content_shape else None)
    color = polar_rotations(torch.as_tensor(
        rng.standard_normal((core.COLOR_STEPS, 3, 3)))).float().numpy()
    rots = {}

    def rotations(p, i, n_iters, c):
        if (p, i) not in rots:
            g = torch.as_tensor(rng.standard_normal((n_iters, c, c)))
            rots[(p, i)] = polar_rotations(g).float().numpy()
        return rots[(p, i)]

    outs = {}
    for dev in ("cuda", "cpu"):
        codec.reset_launches()
        cdf.reset_launches()
        outs[dev] = core.Synthesizer(cfg, device=dev).run(
            noise, [style], content, rotations=rotations,
            color_rotations=color).cpu().numpy()
        if dev == "cuda":
            launches = dict(cdf.LAUNCHES)
    return outs["cuda"], outs["cpu"], launches


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cdf", "sort"])
def test_small_sampled_run_on_gpu_matches_cpu(mode):
    """64 px, 1 pass, 60 cdf (or sort) iterations, no PCA: held by the
    output's distribution (per-channel mean within 3e-3, std within 1e-2,
    sorted pixels within 1e-2 on average), as tests/test_torch_transfer.py
    holds the port against JAX — cdf mode is chaotic at pass granularity,
    and how far two runs drift apart depends on the data (a noise-like
    style drove the cdf std gap to 9.6e-3 on the H100). Sort mode runs on
    torch.sort on both sides, with no kernel of its own."""
    _need_gpu()
    cfg = config.OptexConfig(size=64, passes=1, iters=60, no_pca=True,
                             no_multires=True, seed=0, hist_mode=mode,
                             style=["s.png"])
    gpu, cpu, launches = _gpu_vs_cpu(cfg)
    steps = sum(core.Synthesizer(cfg, device="cpu").iters_table[0])
    steps = steps if mode == "cdf" else 0
    assert launches == {"batched_histogram": steps, "pwl_remap": steps,
                        "cdf_remap": 0}
    assert np.isfinite(gpu).all()
    g, c = gpu.reshape(-1, 3), cpu.reshape(-1, 3)
    assert float(np.abs(g.mean(0) - c.mean(0)).max()) <= 3e-3
    assert float(np.abs(g.std(0) - c.std(0)).max()) <= 1e-2
    assert float(np.abs(np.sort(g, 0) - np.sort(c, 0)).mean()) <= 1e-2


@pytest.mark.cuda
def test_small_transfer_opt_run_on_gpu_matches_cpu():
    """64 x 96 style transfer (chol, strength 0.2) with the opt color tail:
    mean |gpu - cpu| within 3e-3, max within 5e-2 (a sample moved to the
    neighbouring bin in the tail moves its bin's remap by up to one bin
    width; tests/test_torch_transfer.py; a noise-like style and content
    gave a mean of 2.1e-3 on the H100)."""
    _need_gpu()
    cfg = config.OptexConfig(size=96, passes=2, iters=60, no_pca=True,
                             seed=0, content="c.png", content_strength=0.2,
                             color_transfer="opt", style=["s.png"])
    gpu, cpu, launches = _gpu_vs_cpu(cfg, (1, 64, 96, 3))
    assert launches == {"batched_histogram": core.COLOR_STEPS,
                        "pwl_remap": core.COLOR_STEPS, "cdf_remap": 0}
    assert gpu.shape == cpu.shape == (1, 64, 96, 3)
    assert float(np.abs(gpu - cpu).mean()) <= 3e-3
    assert float(np.abs(gpu - cpu).max()) <= 5e-2


# ---------------------------------------------------------------------------
# the legacy kernels: cdf_remap (csrc/cdf.cu) and conv64 (csrc/conv64.cu)


def _cdf_remap_case(c, n, const=None, offset=0, collapse=None):
    """Target rows (a top-edge pile in row 0; ``offset`` floats past a
    16-byte boundary), source rows, their shared ranges and their
    plain histograms (the histogram kernel takes at most 65535 rows).
    ``const``: a degenerate shared range in that row;
    ``collapse``: that row moved to 1e6 at a spread of about 1, where
    the 256 f32 edges collapse to about a hundred distinct values."""
    t, _, _ = _rows(c, n, 3 * c + n, pile=True, offset=offset)
    s, _, _ = _rows(c, n + 91, 5 * c + n)
    if const is not None:
        t[const] = -1.0
        s[const] = -1.0
    if collapse is not None:
        t[collapse] = t[collapse] * 0.5 + 1e6
        s[collapse] = s[collapse] * 0.5 + 1e6
    lo = torch.minimum(t.min(dim=1).values, s.min(dim=1).values)
    hi = torch.maximum(t.max(dim=1).values, s.max(dim=1).values)
    return t, cdf.histogram_plain(t, lo, hi), cdf.histogram_plain(s, lo, hi), lo, hi


@pytest.mark.cuda
# odd N below one block, C = 3, ragged C and N, a degenerate shared range,
# a top-edge pile, the 512-px relu1 and the 256-px relu3 shapes, a row
# whose f32 edges collapse, rows 1 float past a 16-byte boundary, and more
# rows than a grid's y dimension takes
@pytest.mark.parametrize("c,n,const,offset,collapse", [
    (3, 262144, None, 0, None), (3, 1001, 1, 0, None), (5, 4099, None, 0, None),
    (13, 70001, 4, 0, None), (1, 300, None, 0, None), (24, 262144, None, 0, None),
    (179, 4096, None, 0, None), (5, 4099, None, 0, 2), (24, 262144, None, 1, 5),
    (7, 4099, 3, 1, None), (70000, 5, 3, 0, None)])
def test_cdf_remap_kernel_matches_plain(c, n, const, offset, collapse):
    """Bit-equal: the kernel's every operation is the plain version's, in
    its rounding (the guessed segment is verified; the cdf sums are exact)."""
    _need_gpu()
    t, t_hist, s_hist, lo, hi = _cdf_remap_case(c, n, const, offset, collapse)
    assert t.data_ptr() % 16 == 4 * offset
    before = cdf.LAUNCHES["cdf_remap"]
    got = cdf.cdf_remap(t, t_hist, s_hist, lo, hi)
    ref = cdf.cdf_remap_plain(t, t_hist, s_hist, lo, hi)
    torch.cuda.synchronize()
    assert cdf.LAUNCHES["cdf_remap"] == before + 1
    assert got.shape == t.shape and got.is_contiguous()
    assert got.data_ptr() % 16 == t.data_ptr() % 16
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, ref)
    if const is not None:
        assert bool((got[const] == got[const, 0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("c,n", [(24, 262144), (3, 262144), (179, 4096)])
def test_cdf_remap_repeated_launches_agree(c, n):
    """100 launches give the first launch's output bit for bit."""
    _need_gpu()
    t, t_hist, s_hist, lo, hi = _cdf_remap_case(c, n, collapse=c - 1)
    first = cdf.cdf_remap(t, t_hist, s_hist, lo, hi)
    differ = sum(not torch.equal(cdf.cdf_remap(t, t_hist, s_hist, lo, hi), first)
                 for _ in range(100))
    assert differ == 0


@pytest.mark.cuda
# B % 8 == 0 takes the TMA path: 8 and 16 (one partial 64-wide batch tile),
# 128 and 256 (two and four full tiles); 5, 130 and 1 the masked path (130:
# three tiles, the last ragged). Ragged H and W throughout, and rows longer
# than one 64-pixel strip (70, 130).
@pytest.mark.parametrize("h,w,b", [(64, 64, 128), (37, 45, 5), (9, 7, 130),
                                   (16, 33, 1), (11, 70, 8), (7, 13, 16),
                                   (5, 130, 256), (3, 3, 128)])
def test_conv64_kernel_matches_plain(h, w, b):
    """|kernel - plain| <= 2^-7 * max|plain|: one bf16 rounding of two f32
    sums of 576 products taken in other orders."""
    _need_gpu()
    g = torch.Generator(device="cuda").manual_seed(h * w + b)
    xpad = torch.randn((h + 2, w + 2, 64, b), generator=g,
                       device="cuda").to(torch.bfloat16)
    wrow = conv64.pack_wrow((torch.randn((3, 3, 64, 64), generator=g,
                                         device="cuda") * 0.1).to(torch.bfloat16))
    before = conv64.LAUNCHES["conv64"]
    got = conv64.conv64(xpad, wrow)
    ref = conv64.conv64_plain(xpad, wrow)
    torch.cuda.synchronize()
    assert conv64.LAUNCHES["conv64"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape == (h, w, 64, b)
    scale = float(ref.float().abs().max())
    assert float((got.float() - ref.float()).abs().max()) <= 2.0 ** -7 * scale


@pytest.mark.cuda
def test_conv64_repeated_launches_agree():
    """The kernel sums each output in a fixed order, so 100 launches at the
    tool's 512 px x 128 (8192 work items over the persistent blocks) equal
    the first bit for bit. A race in its producer/consumer ring broke that
    in 7-10 of 100 launches before the consumers waited for every column
    in order and released only columns they had seen land."""
    _need_gpu()
    g = torch.Generator(device="cuda").manual_seed(5)
    xpad = torch.randn((514, 514, 64, 128), generator=g,
                       device="cuda").to(torch.bfloat16)
    wrow = conv64.pack_wrow((torch.randn((3, 3, 64, 64), generator=g,
                                         device="cuda") * 0.1).to(torch.bfloat16))
    first = conv64.conv64(xpad, wrow)
    differ = sum(not torch.equal(conv64.conv64(xpad, wrow), first)
                 for _ in range(100))
    assert differ == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["chol", "cdf"])
def test_small_mixing_run_on_gpu_matches_cpu(mode):
    """Two-style mixing at 64 px, 1 pass, no PCA, injected rotations and
    mask draws: chol within 1e-3; cdf by distribution (as above), and its
    launches are the stages' plus the mixing's own: 2 hist_match x 3
    depths, each 1 histogram launch (both clouds) and 1 remap."""
    _need_gpu()
    cfg = config.OptexConfig(size=64, passes=1, iters=60, no_pca=True,
                             no_multires=True, seed=0, hist_mode=mode,
                             style=["a.png", "b.png"])
    rng = np.random.default_rng(1)
    noise = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    styles = [np.clip(0.5 + np.kron(rng.uniform(-a, a, (1, 8, 8, 3)),
                                    np.ones((1, 8, 8, 1))) +
                      0.1 * rng.standard_normal((1, 64, 64, 3)), 0, 1
                      ).astype(np.float32) for a in (0.5, 0.3)]
    draw = rng.integers(0, 2, size=(32, 32))    # mask regions at relu2's size
    rots = {}

    def rotations(p, i, n_iters, c):
        if (p, i) not in rots:
            g = torch.as_tensor(rng.standard_normal((n_iters, c, c)))
            rots[(p, i)] = polar_rotations(g).float().numpy()
        return rots[(p, i)]

    outs = {}
    for dev in ("cuda", "cpu"):
        cdf.reset_launches()
        outs[dev] = core.Synthesizer(cfg, device=dev).run(
            noise, styles, rotations=rotations,
            mix_draws=lambda p, hw, n: draw).cpu().numpy()
        if dev == "cuda":
            launches = dict(cdf.LAUNCHES)
    gpu, cpu = outs["cuda"], outs["cpu"]
    assert np.isfinite(gpu).all()
    if mode == "chol":
        assert launches == {"batched_histogram": 0, "pwl_remap": 0, "cdf_remap": 0}
        assert float(np.abs(gpu - cpu).max()) <= 1e-3
        return
    steps = sum(core.Synthesizer(cfg, device="cpu").iters_table[0])
    mix = 2 * 3
    assert launches == {"batched_histogram": steps + mix,
                        "pwl_remap": steps + mix, "cdf_remap": 0}
    g, c = gpu.reshape(-1, 3), cpu.reshape(-1, 3)
    assert float(np.abs(g.mean(0) - c.mean(0)).max()) <= 3e-3
    assert float(np.abs(g.std(0) - c.std(0)).max()) <= 1e-2
    assert float(np.abs(np.sort(g, 0) - np.sort(c, 0)).mean()) <= 1e-2


# --- the bf16 function of the codec kernels ----------------------------------

# |kernel - plain| bound of the bf16 kernels: one bf16 rounding of the
# output (both sum in f32 in their own order, then round once)
BF16_TOL = 2.0 ** -7


def _bf16_case(name, n, h, w, cin, g, wide=False):
    """Inputs of one bf16 kernel call: x (bf16; rgb_to_relu1's f32) and
    bf16 weights packed for it."""
    cout = {"rgb_to_relu1": 64, "conv3x3_p2": 64, "conv3x3_full": 128,
            "upconv_p2": cin, "final_to_rgb": 3}[name]
    x = torch.rand((n, h, w, cin), generator=g, device="cuda")
    if wide:
        mag = 10.0 ** (6.0 * torch.rand(x.shape, generator=g, device="cuda") - 3.0)
        x = torch.where(x < 0.5, -mag, mag)
    if name != "rgb_to_relu1":
        x = x.to(torch.bfloat16)
    pack = codec.pack_up if name == "upconv_p2" else codec.pack
    p = pack((torch.randn((cout, cin, 3, 3), generator=g, device="cuda") * 0.1
              ).to(torch.bfloat16),
             (torch.randn((cout,), generator=g, device="cuda") * 0.1
              ).to(torch.bfloat16))
    return x, p


_PLAIN_KW = {"rgb_to_relu1": dict(relu=True), "upconv_p2": dict(relu=True, up=True),
             "final_to_rgb": dict(out_dtype=torch.float32)}


@pytest.mark.cuda
# each kernel's main-path shapes (512^2 roundtrip sizes), ragged and odd
# sizes, one coarse row, H or W = 2, batch 1-3 and 128, and a wide range
@pytest.mark.parametrize("name,cin,kw,n,hw,wide", [
    ("rgb_to_relu1", 3, {}, 1, (512, 512), False),
    ("rgb_to_relu1", 3, {}, 2, (17, 33), True),
    ("rgb_to_relu1", 3, {}, 128, (32, 32), False),
    ("conv3x3_p2", 64, dict(relu=True, pool=True), 1, (512, 512), False),
    ("conv3x3_p2", 128, dict(relu=True), 1, (256, 256), False),
    ("conv3x3_p2", 64, dict(relu=True, pool=True), 3, (41, 57), True),
    ("conv3x3_p2", 128, dict(relu=False, pool=True), 128, (32, 32), False),
    ("conv3x3_p2", 64, dict(relu=False), 2, (35, 19), True),
    ("conv3x3_full", 64, dict(relu=True), 1, (256, 256), False),
    ("conv3x3_full", 128, dict(relu=True, pool=True), 1, (256, 256), False),
    ("conv3x3_full", 128, dict(relu=True, pool=True), 2, (35, 19), True),
    ("conv3x3_full", 64, dict(relu=False), 128, (16, 16), False),
    # the wgmma kernel's edges: one pixel past a 32-wide strip, W = 2, one
    # row pair (H = 2) and a pair and a lone last row (H = 3) with the pool
    ("conv3x3_full", 128, dict(relu=True, pool=True), 1, (20, 33), False),
    ("conv3x3_full", 64, dict(relu=True), 2, (9, 2), False),
    ("conv3x3_full", 128, dict(relu=False, pool=True), 3, (2, 19), True),
    ("conv3x3_full", 64, dict(relu=True, pool=True), 2, (3, 35), False),
    ("conv3x3_full", 128, dict(relu=True, pool=True), 2, (3, 70), False),
    # the wgmma kernel's conv3x3_p2 mode (COUT 64): one pixel past a 64-wide
    # and a 32-wide strip, W = 2, H = 2 and 3 with the pool
    ("conv3x3_p2", 64, dict(relu=True, pool=True), 1, (20, 65), False),
    ("conv3x3_p2", 128, dict(relu=True), 2, (9, 33), True),
    ("conv3x3_p2", 64, dict(relu=True), 2, (9, 2), False),
    ("conv3x3_p2", 128, dict(relu=False, pool=True), 3, (2, 19), True),
    ("conv3x3_p2", 64, dict(relu=True, pool=True), 2, (3, 35), False),
    ("upconv_p2", 128, {}, 1, (64, 64), False),
    ("upconv_p2", 64, {}, 1, (128, 128), False),
    ("upconv_p2", 64, {}, 2, (17, 23), True),
    ("upconv_p2", 128, {}, 3, (1, 9), False),
    ("upconv_p2", 64, {}, 128, (8, 8), False),
    # its upconv mode (coarse sizes): one coarse pixel past a 64-wide strip,
    # Wc = 1, Hc = 1-3 (a lone last coarse row), odd sizes
    ("upconv_p2", 64, {}, 1, (20, 65), False),
    ("upconv_p2", 128, {}, 2, (3, 65), True),
    ("upconv_p2", 64, {}, 3, (2, 1), False),
    ("upconv_p2", 128, {}, 1, (1, 1), False),
    ("upconv_p2", 64, {}, 2, (7, 33), True),
    ("final_to_rgb", 64, {}, 1, (512, 512), False),
    ("final_to_rgb", 64, {}, 2, (17, 33), True),
    ("final_to_rgb", 64, {}, 3, (2, 37), False),
    ("final_to_rgb", 64, {}, 128, (32, 32), False),
    # the mma.sync edge kernels' edges: one pixel past a 16-wide tile, H = 2,
    # W = 2, both, at odd batches (final_to_rgb's reflect repair and its
    # clamped last m16 tile; rgb_to_relu1's clipped TMA stores)
    ("rgb_to_relu1", 3, {}, 1, (20, 33), False),
    ("rgb_to_relu1", 3, {}, 3, (2, 37), True),
    ("rgb_to_relu1", 3, {}, 3, (45, 2), False),
    ("rgb_to_relu1", 3, {}, 1, (2, 2), True),
    ("final_to_rgb", 64, {}, 1, (20, 33), True),
    ("final_to_rgb", 64, {}, 3, (45, 2), False),
    ("final_to_rgb", 64, {}, 3, (2, 2), True),
    ("final_to_rgb", 64, {}, 5, (33, 17), False)])
def test_bf16_kernels_match_plain(name, cin, kw, n, hw, wide):
    """The bf16 kernels (wgmma in kernels 1-3; mma.sync with TMA in 4-5):
    within 2^-7 x max|plain| of the bf16 plain version, in the plain
    version's dtype, counted under <name>_bf16."""
    _need_gpu()
    g = torch.Generator(device="cuda").manual_seed(cin + 3 * hw[0] + hw[1] + n)
    x, p = _bf16_case(name, n, *hw, cin, g, wide)
    before = dict(codec.LAUNCHES)
    got = getattr(codec, name)(x, p, **kw)
    ref = codec.conv3x3_plain(x, p, **{**kw, **_PLAIN_KW.get(name, {})})
    torch.cuda.synchronize()
    assert codec.LAUNCHES[name + "_bf16"] == before[name + "_bf16"] + 1
    assert codec.LAUNCHES[name] == before[name]
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert got.dtype == (torch.float32 if name == "final_to_rgb" else torch.bfloat16)
    got, ref = got.float(), ref.float()
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= BF16_TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name,cin,kw", [
    ("rgb_to_relu1", 3, {}), ("conv3x3_p2", 64, dict(relu=True, pool=True)),
    ("conv3x3_p2", 128, dict(relu=True)),
    ("conv3x3_full", 128, dict(relu=True)), ("conv3x3_full", 64, dict(relu=True)),
    ("conv3x3_full", 128, dict(relu=True, pool=True)), ("upconv_p2", 64, {}),
    ("upconv_p2", 128, {}), ("final_to_rgb", 64, {})])
def test_bf16_kernels_repeated_launches_agree(name, cin, kw):
    """Each output sums in a fixed order: 50 launches at 512^2 (the upconv's
    256^2 coarse input; 256^2 and 128^2 at 128 input channels, the path's
    shapes) equal the first bit for bit (a race in a kernel's ring of halo
    rows, in final_to_rgb's ring of halo boxes or its double-buffered Z, or
    in rgb_to_relu1's staging shows so)."""
    _need_gpu()
    g = torch.Generator(device="cuda").manual_seed(17)
    side = (512 if name != "upconv_p2" else 256) // (2 if cin == 128 and name in (
        "conv3x3_p2", "upconv_p2") else 1)
    x, p = _bf16_case(name, 1, side, side, cin, g)
    kern = getattr(codec, name)
    first = kern(x, p, **kw)
    differ = sum(not torch.equal(kern(x, p, **kw), first) for _ in range(50))
    assert differ == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rgb_to_relu1", "conv3x3_p2", "upconv_p2"])
def test_bf16_batch128_relu1_scale_past_2_31_elements(name):
    """At batch 128 and 512^2 a relu1-scale tensor holds exactly 2^31
    elements (rgb_to_relu1's and upconv_p2's output, conv3x3_p2's input):
    every offset must be 64-bit. The first and the last image are held
    against the plain version on those images alone."""
    _need_gpu()
    g = torch.Generator(device="cuda").manual_seed(23)
    n, side = 128, 256 if name == "upconv_p2" else 512
    cin = 3 if name == "rgb_to_relu1" else 64
    x, p = _bf16_case(name, n, side, side, cin, g)
    kw = dict(relu=True, pool=True) if name == "conv3x3_p2" else {}
    got = getattr(codec, name)(x, p, **kw)
    torch.cuda.synchronize()
    assert (x if name == "conv3x3_p2" else got).numel() == 2 ** 31
    for i in (0, n - 1):
        ref = codec.conv3x3_plain(x[i:i + 1], p, **{**kw, **_PLAIN_KW.get(name, {})})
        err = float((got[i:i + 1].float() - ref.float()).abs().max())
        assert err <= BF16_TOL * float(ref.float().abs().max())
    del x, got
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_bf16_conv3x3_full_batch128_first_and_last_images():
    """Batch 128 at 256^2, Cin 128, ReLU and pool (the path's shape): the
    input holds 2^30 elements (2 GiB), whose byte offsets pass 2^31. The
    first and the last image are held against the plain version on those
    images alone."""
    _need_gpu()
    g = torch.Generator(device="cuda").manual_seed(29)
    n, side, kw = 128, 256, dict(relu=True, pool=True)
    x, p = _bf16_case("conv3x3_full", n, side, side, 128, g)
    got = codec.conv3x3_full(x, p, **kw)
    torch.cuda.synchronize()
    assert x.numel() == 2 ** 30 and got.shape == (n, side // 2, side // 2, 128)
    for i in (0, n - 1):
        ref = codec.conv3x3_plain(x[i:i + 1], p, **kw)
        err = float((got[i:i + 1].float() - ref.float()).abs().max())
        assert err <= BF16_TOL * float(ref.float().abs().max())
    del x, got
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["conv3x3_p2", "conv3x3_full", "upconv_p2"])
def test_bf16_conv3x3_full_refuses_weights_without_the_wgmma_image(name):
    """The bf16 tensor-core kernels take the wgmma image (pack's or
    pack_up's w_wg): a Packed with only the f32 mma.sync fragments, none,
    or another mode's image raises; nothing falls back."""
    _need_gpu()
    g = torch.Generator(device="cuda").manual_seed(31)
    x, p = _bf16_case(name, 1, 16, 16, 64, g)
    kw = {} if name == "upconv_p2" else dict(relu=True)
    f32 = (codec.pack_up if name == "upconv_p2" else codec.pack)(p.w.float(), p.b)
    other = (codec.pack if name == "upconv_p2" else codec.pack_up)(
        p.w[:64, :64].contiguous(), p.b[:64])
    before = dict(codec.LAUNCHES)
    for q in (p._replace(w_wg=None),
              p._replace(w_wg=None, w_tc=f32.w_tc, w_up=f32.w_up),
              p._replace(w_wg=other.w_wg)):
        with pytest.raises(ValueError):
            getattr(codec, name)(x, q, **kw)
    assert codec.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("name,cin", [("rgb_to_relu1", 3), ("final_to_rgb", 64)])
def test_bf16_edge_kernels_refuse_weights_without_w_edge(name, cin):
    """The bf16 edge kernels take pack's mma.sync fragments (w_edge): a
    Packed without them, with the other kernel's or with f32 ones raises
    and counts no launch; nothing falls back."""
    _need_gpu()
    g = torch.Generator(device="cuda").manual_seed(37)
    x, p = _bf16_case(name, 1, 16, 16, cin, g)
    _, other = _bf16_case("final_to_rgb" if cin == 3 else "rgb_to_relu1", 1, 16, 16,
                          64 if cin == 3 else 3, g)
    before = dict(codec.LAUNCHES)
    for q in (p._replace(w_edge=None), p._replace(w_edge=other.w_edge),
              p._replace(w_edge=p.w_edge.float())):
        with pytest.raises(ValueError, match="w_edge"):
            getattr(codec, name)(x, q)
    assert codec.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
@pytest.mark.parametrize("name,cin", [("rgb_to_relu1", 3), ("conv3x3_p2", 64),
                                      ("final_to_rgb", 64)])
def test_kernels_refuse_f16_and_f64(name, cin, dtype):
    """Only float32 and bfloat16 have kernels: f16 or f64 weights raise, and
    so does a bf16 conv handed an input of another dtype."""
    _need_gpu()
    cout = {"rgb_to_relu1": 64, "conv3x3_p2": 64, "final_to_rgb": 3}[name]
    x = torch.rand((1, 16, 16, cin), device="cuda", dtype=dtype)
    w = torch.rand((cout, cin, 3, 3), device="cuda", dtype=dtype)
    p = codec.Packed(w, torch.rand(cout, device="cuda", dtype=dtype),
                     w.permute(2, 3, 1, 0))
    before = dict(codec.LAUNCHES)
    with pytest.raises(TypeError):
        getattr(codec, name)(x, p)
    pb = codec.pack(p.w.to(torch.bfloat16), p.b.to(torch.bfloat16))
    if name != "rgb_to_relu1":
        with pytest.raises(TypeError):
            getattr(codec, name)(x, pb)
    assert codec.LAUNCHES == before


@pytest.mark.cuda
def test_small_bf16_batch_run_on_gpu_matches_cpu():
    """64 px, batch 2, bf16, 2 passes, depth 3, no PCA, injected rotations:
    the GPU run (every bf16 kernel, once a stage roundtrip) vs the CPU run
    (their plain versions). Bound 0.1523: JAX's own bf16-vs-f32 gap on the
    CPU parity test's inputs (tests/test_torch_batch.py), since the two
    devices' bf16 convs round a few outputs the other way."""
    _need_gpu()
    cfg = config.OptexConfig(size=64, passes=2, iters=48, no_pca=True,
                             no_multires=True, seed=0, batch=2,
                             conv_dtype="bfloat16", style=["s.png"])
    rng = np.random.default_rng(0)
    noise = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
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
    assert min(codec.LAUNCHES[k + "_bf16"] for k in codec.KERNELS) > 0
    assert max(codec.LAUNCHES[k] for k in codec.KERNELS) == 0
    cpu = core.Synthesizer(cfg, device="cpu").run(noise, [style],
                                                  rotations=rotations)
    assert gpu.shape == cpu.shape == (2, 64, 64, 3) and gpu.dtype == torch.float32
    assert float((gpu.cpu() - cpu).abs().max()) <= 0.1523


# --- the non-square shapes of the out_width path ------------------------------

# every codec call of one depth-3 stage roundtrip at 512 x 768 (out_width
# 768): (kernel, Cin, wrapper kwargs, the call's input (H, W))
ROUNDTRIP_512x768 = [
    ("rgb_to_relu1", 3, {}, (512, 768)),
    ("conv3x3_p2", 64, dict(relu=True, pool=True), (512, 768)),
    ("conv3x3_full", 64, dict(relu=True), (256, 384)),
    ("conv3x3_full", 128, dict(relu=True, pool=True), (256, 384)),
    ("upconv_p2", 128, {}, (128, 192)),
    ("conv3x3_p2", 128, dict(relu=True), (256, 384)),
    ("upconv_p2", 64, {}, (256, 384)),
    ("final_to_rgb", 64, {}, (512, 768))]


@pytest.mark.cuda
@pytest.mark.parametrize("name,cin,kw,hw", ROUNDTRIP_512x768)
def test_f32_kernels_match_plain_at_512x768(name, cin, kw, hw):
    """The f32 kernels (1-5) at the 512 x 768 roundtrip's shapes: within
    2e-5 x max|plain| of the plain version."""
    _need_gpu()
    g = torch.Generator(device="cuda").manual_seed(cin + hw[0] + 3 * hw[1])
    cout = {"rgb_to_relu1": 64, "conv3x3_p2": 64, "conv3x3_full": 128,
            "upconv_p2": cin, "final_to_rgb": 3}[name]
    x = torch.rand((1, *hw, cin), generator=g, device="cuda")
    pack = codec.pack_up if name == "upconv_p2" else codec.pack
    p = pack(torch.randn((cout, cin, 3, 3), generator=g, device="cuda") * 0.1,
             torch.randn((cout,), generator=g, device="cuda") * 0.1)
    plain_kw = {**kw, **_PLAIN_KW.get(name, {})}
    plain_kw.pop("out_dtype", None)
    before = codec.LAUNCHES[name]
    got = getattr(codec, name)(x, p, **kw)
    ref = codec.conv3x3_plain(x, p, **plain_kw)
    torch.cuda.synchronize()
    assert codec.LAUNCHES[name] == before + 1
    assert got.shape == ref.shape and got.shape[1] != got.shape[2]
    assert float((got - ref).abs().max()) <= REL_TOL * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("name,cin,kw,hw", ROUNDTRIP_512x768)
def test_bf16_kernels_match_plain_at_512x768(name, cin, kw, hw):
    """The bf16 kernels (1b-5b) at the 512 x 768 roundtrip's shapes: within
    2^-7 x max|plain| of the bf16 plain version."""
    _need_gpu()
    g = torch.Generator(device="cuda").manual_seed(cin + 3 * hw[0] + hw[1])
    x, p = _bf16_case(name, 1, *hw, cin, g)
    before = dict(codec.LAUNCHES)
    got = getattr(codec, name)(x, p, **kw)
    ref = codec.conv3x3_plain(x, p, **{**kw, **_PLAIN_KW.get(name, {})})
    torch.cuda.synchronize()
    assert codec.LAUNCHES[name + "_bf16"] == before[name + "_bf16"] + 1
    assert got.shape == ref.shape and got.dtype == ref.dtype
    got, ref = got.float(), ref.float()
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= BF16_TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name,cin,kw,hw", [
    ("conv3x3_p2", 64, dict(relu=True, pool=True), (512, 768)),
    ("conv3x3_full", 128, dict(relu=True, pool=True), (256, 384)),
    ("upconv_p2", 64, {}, (256, 384))])
def test_wgmma_modes_repeated_launches_agree_at_512x768(name, cin, kw, hw):
    """Each mode of the bf16 wgmma kernel at a non-square roundtrip shape:
    20 launches equal the first bit for bit."""
    _need_gpu()
    g = torch.Generator(device="cuda").manual_seed(41)
    x, p = _bf16_case(name, 1, *hw, cin, g)
    kern = getattr(codec, name)
    first = kern(x, p, **kw)
    assert sum(not torch.equal(kern(x, p, **kw), first) for _ in range(20)) == 0


@pytest.mark.cuda
def test_chunked_bf16_run_matches_unchunked_on_gpu():
    """128 px, batch 8, bf16, in chunks of 4 vs whole on the card, same
    noise and generator stream: the chunks run every bf16 codec kernel once
    each a stage roundtrip (twice the whole run's launches); the two differ
    only in the covariance's summation order, which a bf16 rounding before
    the decode can turn into one ulp. Bound 0.1523, as the bf16 run above;
    the difference is printed."""
    _need_gpu()
    kw = dict(size=128, passes=2, iters=40, no_multires=True, seed=5, batch=8,
              conv_dtype="bfloat16", style=["s.png"])
    rng = np.random.default_rng(1)
    noise = rng.uniform(size=(8, 128, 128, 3)).astype(np.float32)
    style = rng.uniform(size=(1, 128, 128, 3)).astype(np.float32)
    outs, launches = {}, {}
    for chunk in (0, 4):
        codec.reset_launches()
        outs[chunk] = core.Synthesizer(config.OptexConfig(batch_chunk=chunk, **kw),
                                       device="cuda").run(noise, [style])
        torch.cuda.synchronize()
        launches[chunk] = dict(codec.LAUNCHES)
    for k in codec.KERNELS:
        assert launches[4][k + "_bf16"] == 2 * launches[0][k + "_bf16"] > 0
        assert launches[4][k] == 0
    err = float((outs[4] - outs[0]).abs().max())
    print(f"chunked vs unchunked bf16 at 128 px, batch 8: max abs diff {err:.3e}")
    assert bool(torch.isfinite(outs[4]).all()) and err <= 0.1523


@pytest.mark.cuda
def test_served_request_equals_direct_run_on_gpu():
    """A seeded 64-px request through the HTTP server on the card (its
    default device) returns the direct run's uint8 bytes, through the codec
    kernels."""
    _need_gpu()
    import base64
    import io
    import json
    import os
    import threading
    import urllib.request

    from optimaltextures_tpu_torch import serve

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "docs", "samples", "graffiti_cholhist_256.png")
    with open(path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    cfg_kw = dict(size=64, passes=2, iters=40, depth=2, seed=7)
    srv = serve.serve(port=0, coalesce=1)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        codec.reset_launches()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/synthesize",
            data=json.dumps({"config": cfg_kw, "style_b64": [b64],
                             "format": "npy"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            got = np.load(io.BytesIO(r.read()))
        served = dict(codec.LAUNCHES)
    finally:
        srv.shutdown()
        srv.server_close()
        t.join()
    assert all(served[k] > 0 for k in codec.KERNELS)
    synth = core.Synthesizer(config.OptexConfig(style=["x"], **cfg_kw),
                             device="cuda")
    key = synth.next_run_key()
    noise = core.draw_noise(synth.device, key, (1, 64, 64, 3))
    style = serve._decode_image(b64, 64, oversize=True)
    want = synth.run(noise, [style], key=key, quantize_uint8=True).cpu().numpy()
    assert got.dtype == np.uint8 and got.shape == (1, 64, 64, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_two_workers_serve_on_two_gpus():
    """--workers 2: one pool per GPU, each request on its worker's card
    (CUDA's current device set in the request's thread), sequential
    requests rotating over the two; a seeded chol and a seeded cdf request
    give the same bytes on both cards."""
    _need_gpu()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    import base64
    import json
    import os
    import threading
    import urllib.request

    from optimaltextures_tpu_torch import serve

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "docs", "samples", "graffiti_cholhist_256.png")
    with open(path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    srv = serve.serve(port=0, workers=2, coalesce=1)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/v1/synthesize"
        for mode in ("chol", "cdf"):
            got = {}
            for _ in range(2):
                req = urllib.request.Request(url, data=json.dumps({
                    "config": dict(size=64, passes=2, iters=40, depth=2,
                                   seed=3, hist_mode=mode),
                    "style_b64": [b64], "format": "npy"}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=600) as r:
                    got[r.headers["X-Optex-Worker"]] = r.read()
            assert set(got) == {"0", "1"} and got["0"] == got["1"], mode
        for i, pool in enumerate(srv.workers.pools):
            assert pool.device == torch.device("cuda", i)
            assert {s.device for s in pool._cache.values()} == {pool.device}
    finally:
        srv.shutdown()
        srv.server_close()
        t.join()


# --- the wrap mode: circular padding, tileable runs --------------------------

# (name, Cin, wrapper kwargs): every mode of the ten kernel functions' path
_WRAP_MODES = [
    ("rgb_to_relu1", 3, {}),
    ("conv3x3_p2", 64, dict(relu=True, pool=True)),
    ("conv3x3_p2", 128, dict(relu=True)),
    ("conv3x3_full", 64, dict(relu=True)),
    ("conv3x3_full", 128, dict(relu=True, pool=True)),
    ("upconv_p2", 64, {}),
    ("upconv_p2", 128, {}),
    ("final_to_rgb", 64, {})]


def _wrap_case(name, cin, dtype, n, h, w, g):
    """Inputs of one wrap call in ``dtype`` (the conv dtype: x and weights)."""
    if dtype == torch.bfloat16:
        return _bf16_case(name, n, h, w, cin, g)
    cout = {"rgb_to_relu1": 64, "conv3x3_p2": 64, "conv3x3_full": 128,
            "upconv_p2": cin, "final_to_rgb": 3}[name]
    x = torch.rand((n, h, w, cin), generator=g, device="cuda")
    pack = codec.pack_up if name == "upconv_p2" else codec.pack
    return x, pack(torch.randn((cout, cin, 3, 3), generator=g, device="cuda") * 0.1,
                   torch.randn((cout,), generator=g, device="cuda") * 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# ragged 16 x 16 tiles and strips (40 x 56, 17 x 33), one tile meeting all
# four edges (3 x 5), a side of 1 (the wrap's least; the reflection needs 2)
@pytest.mark.parametrize("n,hw", [(2, (40, 56)), (3, (17, 33)), (1, (3, 5)),
                                  (2, (1, 6))])
@pytest.mark.parametrize("name,cin,kw", _WRAP_MODES)
def test_wrap_kernels_match_plain(name, cin, kw, n, hw, dtype):
    """Each kernel's wrap instantiation against its plain version in wrap
    mode (F.pad circular, then the conv): within the reflect kernels' own
    bounds, 2e-5 x max|plain| in f32 and 2^-7 x max|plain| in bf16, counted
    under <name>[_bf16]_wrap and under no reflect name."""
    _need_gpu()
    h, w = hw
    if name == "upconv_p2":
        h, w = max(h // 2, 1), max(w // 2, 1)
    g = torch.Generator(device="cuda").manual_seed(cin + 7 * h + w + n)
    x, p = _wrap_case(name, cin, dtype, n, h, w, g)
    suffix = "_bf16" * (dtype == torch.bfloat16)
    before = dict(codec.LAUNCHES)
    got = getattr(codec, name)(x, p, pad="wrap", **kw)
    ref = codec.conv3x3_plain(x, p, pad="wrap", **{**kw, **_PLAIN_KW.get(name, {})})
    torch.cuda.synchronize()
    after = dict(codec.LAUNCHES)
    assert after.pop(name + suffix + "_wrap") == before.pop(name + suffix + "_wrap") + 1
    assert after == before
    assert got.shape == ref.shape and got.dtype == ref.dtype
    got, ref = got.float(), ref.float()
    assert bool(torch.isfinite(got).all())
    tol = BF16_TOL if dtype == torch.bfloat16 else REL_TOL
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= tol * (
        scale if dtype == torch.bfloat16 else max(1.0, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrap_final_to_rgb_repeated_launches_agree(dtype):
    """final_to_rgb's wrap repair writes an edge tile's far-edge halo into
    a ring slot that TMA refills later: at 2 x 40 x 56 (every tile an edge
    tile, the last row and column of tiles ragged) 100 launches equal the
    first bit for bit."""
    _need_gpu()
    g = torch.Generator(device="cuda").manual_seed(23)
    x, p = _wrap_case("final_to_rgb", 64, dtype, 2, 40, 56, g)
    first = codec.final_to_rgb(x, p, pad="wrap")
    differ = sum(not torch.equal(codec.final_to_rgb(x, p, pad="wrap"), first)
                 for _ in range(100))
    assert differ == 0


@pytest.mark.cuda
@pytest.mark.parametrize("conv_dtype,bound", [("float32", 1e-3),
                                              ("bfloat16", 0.1523)])
def test_tileable_run_on_gpu_matches_cpu(conv_dtype, bound):
    """A 64-px tileable run with multires (the pastiche's circular pass
    resizes), depth 3, no PCA, injected rotations: the GPU run, through the
    wrap kernels only, against the CPU run (plain versions in wrap mode);
    bf16 within the bf16-vs-f32 run gap (0.1523, test_torch_batch.py)."""
    _need_gpu()
    cfg = config.OptexConfig(size=64, passes=2, iters=48, no_pca=True, seed=0,
                             style=["s.png"], tileable=True,
                             conv_dtype=conv_dtype)
    rng = np.random.default_rng(0)
    noise = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
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
    suffix = "_bf16" * (conv_dtype == "bfloat16")
    assert min(codec.LAUNCHES[k + suffix + "_wrap"] for k in codec.KERNELS) > 0
    assert sum(v for k, v in codec.LAUNCHES.items() if not k.endswith("_wrap")) == 0
    cpu = core.Synthesizer(cfg, device="cpu").run(noise, [style],
                                                  rotations=rotations)
    assert gpu.shape == cpu.shape
    assert float((gpu.cpu() - cpu).abs().max()) <= bound


# ---------------------------------------------------------------------------
# data parallelism (optimaltextures_tpu_torch/parallel/): ranks started by
# parallel.mesh.spawn, the rank bodies of tools/dryrun_multichip.py


def _dp_inputs():
    from optimaltextures_tpu_torch.ops import cuda_build

    cuda_build.build("codec", "cdf", "conv_wg", "edge_mma")   # ranks only load
    rng = np.random.default_rng(4)
    return [rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
            for _ in range(4)]


def _dp_hold(got, ref, mode):
    assert got.shape == ref.shape and np.isfinite(got).all()
    if mode == "cdf":   # chaotic at pass granularity: by distribution
        g, r = got.reshape(-1, 3), ref.reshape(-1, 3)
        assert float(np.abs(g.mean(0) - r.mean(0)).max()) <= 3e-3
        assert float(np.abs(np.sort(g, 0) - np.sort(r, 0)).mean()) <= 1e-2
    else:               # JAX's DP-vs-single bound
        assert float(np.abs(got - ref).max()) <= 2e-3


def _dp_case(n, backend, device, mode):
    from optimaltextures_tpu_torch.parallel.mesh import spawn
    from optimaltextures_tpu_torch.tools import dryrun_multichip as dr

    style = _dp_inputs()[0]
    kw = dict(size=64, passes=2, iters=40, depth=2, seed=3, batch=2 * n,
              hist_mode=mode, style=["s.png"])
    ref = core.synthesize(config.OptexConfig(**kw), [style],
                          device="cuda")[0].cpu().numpy()
    got = spawn(dr.run_rank, n, backend=backend, device=device,
                args=({**kw, "num_devices": n}, [style], ("warm",)),
                deadline_s=600)
    for counts in got["counts"]:     # every rank ran its shard on the kernels
        assert min(counts[k] for k in codec.KERNELS) > 0
        assert (counts["batched_histogram"] > 0) == (mode == "cdf")
    _dp_hold(got["out"], ref, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["chol", "cdf"])
def test_gloo_dp_on_one_gpu_matches_one_process(mode):
    """Two gloo ranks sharing cuda:0, batch 4, against the batch-4 run in
    this process."""
    _need_gpu()
    _dp_case(2, "gloo", "cuda:0", mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["chol", "cdf"])
def test_nccl_dp_across_gpus_matches_one_process(mode):
    """min(count, 4) NCCL ranks, one a card, against one process."""
    _need_gpu()
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two GPUs")
    _dp_case(n, "nccl", "cuda", mode)


@pytest.mark.cuda
def test_nccl_style_parallel_across_gpus_matches_one_process():
    """One style a card (NCCL), against every style in this process."""
    _need_gpu()
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two GPUs")
    from optimaltextures_tpu_torch.parallel.mesh import spawn
    from optimaltextures_tpu_torch.parallel.style_dp import \
        synthesize_style_batch
    from optimaltextures_tpu_torch.tools import dryrun_multichip as dr

    styles = _dp_inputs()[:n]
    kw = dict(size=64, passes=2, iters=40, depth=2, seed=3, pca_bucket=16,
              style=[f"s{i}.png" for i in range(n)])
    ref = synthesize_style_batch(config.OptexConfig(**kw), styles, None,
                                 device="cuda").cpu().numpy()
    got = spawn(dr.style_rank, n, backend="nccl", device="cuda",
                args=(kw, styles, ("warm",)), deadline_s=600)
    assert all(min(c[k] for k in codec.KERNELS) > 0 for c in got["counts"])
    _dp_hold(got["out"], ref, "chol")


@pytest.mark.cuda
def test_nccl_one_rank_matches_one_process():
    """One NCCL rank on cuda:0: the DP path's collectives through NCCL."""
    _need_gpu()
    _dp_case(1, "nccl", "cuda:0", "chol")


# ---------------------------------------------------------------------------
# spatial sharding: ranks on one card exchange halo rows around the kernels


def _spatial_kernel_cases():
    """The ten codec kernel functions' settings on the stage roundtrip, in
    both pad modes, at 64 rows (32 a rank) x 48 columns."""
    rng = np.random.default_rng(12)
    cases = []
    for name, cin, kw in (("rgb_to_relu1", 3, {}),
                          ("conv3x3_p2", 64, dict(relu=True, pool=True)),
                          ("conv3x3_p2", 128, dict(relu=True)),
                          ("conv3x3_full", 64, dict(relu=True)),
                          ("conv3x3_full", 128, dict(relu=True, pool=True)),
                          ("upconv_p2", 64, {}), ("upconv_p2", 128, {}),
                          ("final_to_rgb", 64, {})):
        cout = {"rgb_to_relu1": 64, "final_to_rgb": 3, "upconv_p2": cin,
                "conv3x3_p2": 64}.get(name, 128)
        h = 32 if name == "upconv_p2" else 64
        x = np.maximum(rng.normal(0.2, 1.0, (1, h, 48, cin)), 0).astype(
            np.float32)
        w = (rng.normal(size=(cout, cin, 3, 3)) * np.sqrt(2 / (9 * cin))
             ).astype(np.float32)
        b = rng.normal(0, 0.1, cout).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            for pad in ("reflect", "wrap"):
                cases.append((name, x, w, b, kw, dtype, pad))
    return cases


@pytest.mark.cuda
def test_spatial_exchanged_kernels_match_the_whole_image():
    """Two gloo ranks sharing cuda:0 run each kernel on their 32 rows by
    exchange and crop: bit-equal to the kernel on the whole image in f32
    (a pixel's sum does not depend on where its tile lies), within one bf16
    rounding (2^-7 of the output's scale) in bf16; each launch counted."""
    _need_gpu()
    from optimaltextures_tpu_torch.parallel.mesh import spawn
    from optimaltextures_tpu_torch.tools import dryrun_multichip as dr

    _dp_inputs()
    cases = _spatial_kernel_cases()
    got, counts = spawn(dr.exchanged_rank, 2, backend="gloo",
                        device="cuda:0", args=(cases,), deadline_s=600)
    assert sum(counts.values()) == len(cases)
    for (name, x, w, b, kw, dtype, pad), g in zip(cases, got):
        ref = dr.kernel_call(name, x, w, b, kw, dtype, pad,
                             device="cuda").cpu().numpy()
        assert g.shape == ref.shape, (name, g.shape, ref.shape)
        if dtype == torch.float32:
            np.testing.assert_array_equal(g, ref, err_msg=f"{name} {kw} {pad}")
        else:
            err = float(np.abs(g - ref).max())
            assert err <= 2.0 ** -7 * float(np.abs(ref).max()), (name, pad,
                                                                  err)


def _spatial_case(n, backend, device, layout, size=128, mode="chol"):
    from optimaltextures_tpu_torch.parallel.mesh import spawn
    from optimaltextures_tpu_torch.tools import dryrun_multichip as dr

    style = _dp_inputs()[0]
    kw = dict(size=size, passes=2, iters=40, depth=3, seed=3, hist_mode=mode,
              style=["s.png"], batch=layout.get("num_devices", 1))
    ref = core.synthesize(config.OptexConfig(**kw), [style],
                          device="cuda")[0].cpu().numpy()
    got = spawn(dr.run_rank, n, backend=backend, device=device,
                args=({**kw, **layout}, [style], ("warm",)), deadline_s=600)
    for counts in got["counts"]:     # every rank ran its rows on the kernels
        assert min(counts[k] for k in codec.KERNELS) > 0
        assert (counts["batched_histogram"] > 0) == (mode == "cdf")
    _dp_hold(got["out"], ref, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["chol", "cdf"])
def test_spatial_run_on_one_gpu_matches_one_process(mode):
    """Two gloo ranks sharing cuda:0 split one 128-px image's rows (depth
    3: the 256-channel convs on the halo stack too), against one process."""
    _need_gpu()
    _spatial_case(2, "gloo", "cuda:0", dict(spatial_devices=2), mode=mode)


@pytest.mark.cuda
def test_spatial_grid_on_one_gpu_matches_one_process():
    """The 2 x 2 grid on four gloo ranks sharing cuda:0, batch 2."""
    _need_gpu()
    _spatial_case(4, "gloo", "cuda:0", dict(num_devices=2, spatial_devices=2))


@pytest.mark.cuda
def test_nccl_spatial_across_gpus_matches_one_process():
    """min(count, 4) NCCL ranks, one a card, split one 128-px image."""
    _need_gpu()
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two GPUs")
    _spatial_case(n, "nccl", "cuda", dict(spatial_devices=n))


# ---------------------------------------------------------------------------
# multi-device requests as the server runs them: a persistent rank group
# (parallel.mesh.RankGroup) through serve._run_on_group, against one-shot
# ranks (mesh.spawn of core.synthesize, what api.run_files runs)


def _served_request(**cfg):
    import base64
    import os

    from optimaltextures_tpu_torch import serve

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "docs", "samples", "graffiti_cholhist_256.png")
    with open(path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    return {"config": dict(size=128, passes=2, iters=40, depth=3, seed=3,
                           **cfg), "style_b64": [b64], "format": "npy"}


def _one_shot_u8(req, n, backend, device):
    import dataclasses

    from optimaltextures_tpu_torch.parallel.mesh import spawn
    from optimaltextures_tpu_torch.tools import dryrun_multichip as dr

    got = spawn(dr.run_rank, n, backend=backend, device=device, args=(
        dataclasses.asdict(req.cfg), req.styles, ("once",)), deadline_s=600)
    return core._quant_u8(torch.from_numpy(got["out"])).numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("n,layout", [
    (2, dict(spatial_devices=2)),
    (4, dict(num_devices=2, spatial_devices=2, batch=2))])
def test_served_ranks_on_one_gpu_equal_one_shot_ranks(n, layout):
    """n gloo ranks of one RankGroup sharing cuda:0 serve a 128-px request
    twice (depth 3: the 256-channel convs on the halo stack too): both
    bit-equal to one-shot ranks on the same decoded arrays and seed, every
    rank on the kernels, the second with no style prep."""
    _need_gpu()
    _dp_inputs()
    from optimaltextures_tpu_torch import serve
    from optimaltextures_tpu_torch.parallel.mesh import RankGroup

    req = serve._parse_request(_served_request(**layout))
    want = _one_shot_u8(req, n, "gloo", "cuda:0")
    group = RankGroup(["cuda:0"] * n, backend="gloo")
    try:
        runs = [serve._run_on_group(group, req) for _ in range(2)]
    finally:
        group.close()
    for i, (batch, reports) in enumerate(runs):
        np.testing.assert_array_equal(batch, want)
        assert len(reports) == n
        for r in reports:
            assert min(r["launches"][k] for k in codec.KERNELS) > 0
            assert (r["style_preps"] > 0) == (i == 0)


@pytest.mark.cuda
def test_served_over_nccl_on_two_gpus_equals_one_shot_ranks():
    """An HTTP server with workers=2 serves a spatial and a batch-parallel
    request on its NCCL rank group (X-Optex-Worker 0,1), each equal to
    one-shot NCCL ranks on the same cards; server_close ends the ranks."""
    _need_gpu()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    import io
    import json
    import os
    import threading
    import urllib.request

    from optimaltextures_tpu_torch import serve

    _dp_inputs()
    srv = serve.serve(port=0, workers=2, coalesce=1)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    got = {}
    try:
        for name, layout in (("spatial", dict(spatial_devices=2)),
                             ("dp", dict(num_devices=2, batch=2))):
            payload = _served_request(**layout)
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.server_address[1]}/v1/synthesize",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                assert r.headers["X-Optex-Worker"] == "0,1"
                got[name] = (np.load(io.BytesIO(r.read())),
                             serve._parse_request(payload))
        pids = [p for g in srv.workers._groups.values() for p in g.pids]
    finally:
        srv.shutdown()
        srv.server_close()
        t.join()
    assert len(pids) == 2
    assert not any(os.path.exists(f"/proc/{p}") for p in pids)
    for name, (out, req) in got.items():
        np.testing.assert_array_equal(out, _one_shot_u8(req, 2, "nccl",
                                                        "cuda"), err_msg=name)
