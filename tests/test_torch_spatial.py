"""The port's spatial sharding and 2-D grid (``parallel/spatial.py``,
``parallel/grid.py``, the halo exchange of ``parallel/mesh.py`` and the
exchange and crop of ``models/fastcodec.py``) on the CPU: gloo ranks started
by ``parallel.mesh.spawn`` (rank bodies in tests/torch_parallel_ranks.py),
held against the JAX package's spatial and grid functions on the 8 virtual
CPU devices tests/conftest.py provides, and against the port's own
one-process runs.

* The halo exchange at N = 2 and 4, reflect and wrap: bit-equal to JAX's
  ``_halo_pad_h`` under jax.shard_map.
* Exchange and crop around the five codec kernels' plain versions (f32 and
  bf16, pooled and not, reflect and wrap, N = 2 and 4): within 1e-6 (f32;
  2^-7 in bf16) of the output's scale of the same plain version on the
  whole image.
* encode_head / decode_tail with the exchanger, and the F.conv2d halo
  stack, vs JAX's encode_spatial / decode_spatial (1e-4, JAX's own bound).
* spatial_transport_loop in every mode (with the content pull) and the
  grid's _sort_step_grid and loops at 2 x 2 vs JAX's on the same inputs and
  rotations: moments and sort 1e-5, cdf with global counts bit-equal to
  the whole cloud's in one process.
* Whole runs (64 px, depth 2, 2 ranks) vs JAX's spatial_devices=2 run with
  the same noise and rotations (chol, no PCA, 5e-4) and vs the port's
  one-process run (2e-4): PCA, tileable, multires, out_width, style
  transfer, cov_propagation=False; bf16, cdf, sort and the opt color tail
  by distribution. The 2 x 2 grid (4 ranks, batch 2) vs JAX's grid run and
  vs one process.
* The divisibility message equal to JAX's; the CLI's --spatial_devices 2.

Every spawn has a deadline; one spawn of 2 ranks and one of 4 serve every
case but the CLI's."""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from optimaltextures_tpu import config as jconfig
from optimaltextures_tpu import core as jcore
from optimaltextures_tpu.models.vgg import VGGBank as JBank
from optimaltextures_tpu.ops import histmatch as jhistmatch
from optimaltextures_tpu.parallel import grid as jgrid
from optimaltextures_tpu.parallel import shard_ot as jshard
from optimaltextures_tpu.parallel import spatial as jspatial
from optimaltextures_tpu.parallel.mesh import make_mesh as jmake_mesh
from optimaltextures_tpu_torch import cli
from optimaltextures_tpu_torch import config as tconfig
from optimaltextures_tpu_torch import core as tcore
from optimaltextures_tpu_torch.parallel import spatial as tspatial
from optimaltextures_tpu_torch.utils import imageio
import torch_parallel_ranks as ranks
from test_torch_parallel import (_fake_stage_rotations, _hold_distribution,
                                 _noise, _pass0_stacks, _png_dir)
from test_torch_settings import one_torch_thread  # noqa: F401
from test_torch_slice import SAMPLE, RotationStream

DEADLINE = 400.0
# the runs: 64 px, 2 passes of 40 iterations at one size, depth 2
RUN = dict(size=64, passes=2, iters=40, no_multires=True, depth=2, seed=3,
           style=["graffiti.png"])
CONTENT = os.path.join(os.path.dirname(SAMPLE), "graffiti_sort_512.png")
# the port-vs-port cases: 2 ranks against the same run in one process
# (with content: a style transfer)
PORT_CASES = {
    "pca": dict(),
    "tileable": dict(tileable=True),
    "multires": dict(no_multires=False),
    "out_width": dict(out_width=96),
    "transfer": dict(content_strength=0.2),
    "no_cov_prop": dict(cov_propagation=False),
    "sym": dict(hist_mode="sym", pca_bucket=16),
    "bf16": dict(conv_dtype="bfloat16"),
    "cdf": dict(hist_mode="cdf"),
    "sort": dict(hist_mode="sort"),
    "transfer_opt": dict(content_strength=0.2, color_transfer="opt"),
}
BY_DISTRIBUTION = ("bf16", "cdf", "sort", "transfer_opt")
WITH_CONTENT = ("transfer", "transfer_opt")
GRID = dict(RUN, batch=2, num_devices=2, spatial_devices=2)
# the grid's port-vs-port cases (index 0: the run held against JAX's)
GRID_CASES = [None, GRID, dict(GRID, hist_mode="sort")]
SPACE = P(None, "space", None, None)


def _spawn(target, n, *args, deadline_s=DEADLINE):
    from optimaltextures_tpu_torch.parallel import mesh as tmesh

    return tmesh.spawn(target, n, backend="gloo", device="cpu", args=args,
                       deadline_s=deadline_s)


@pytest.fixture(scope="module")
def style():
    return imageio.load_image(SAMPLE, 64)


@pytest.fixture(scope="module")
def content():
    return imageio.load_image(CONTENT, 64)


# ---------------------------------------------------------------------------
# inputs (numpy, from seeds)


def _halo_input():
    return np.random.default_rng(1).normal(size=(2, 16, 5, 3)).astype(
        np.float32)


# the five kernels' settings on the stage roundtrip: (kernel, Cin, kwargs,
# input H); 16 rows split over 4 ranks keep a pooled shard even
KERNELS = [("rgb_to_relu1", 3, {}, 16),
           ("conv3x3_p2", 64, dict(relu=True, pool=True), 16),
           ("conv3x3_p2", 128, dict(relu=True), 16),
           ("conv3x3_full", 64, dict(relu=True), 16),
           ("conv3x3_full", 128, dict(relu=True, pool=True), 16),
           ("upconv_p2", 64, {}, 8),
           ("upconv_p2", 128, {}, 8),
           ("final_to_rgb", 64, {}, 16)]


def _kernel_cases():
    rng = np.random.default_rng(4)
    cases = []
    for name, cin, kw, h in KERNELS:
        cout = {"rgb_to_relu1": 64, "final_to_rgb": 3, "upconv_p2": cin,
                "conv3x3_p2": 64}.get(name, 128)
        x = np.maximum(rng.normal(0.2, 1.0, (1, h, 12, cin)), 0).astype(
            np.float32)
        w = (rng.normal(size=(cout, cin, 3, 3)) * np.sqrt(2 / (9 * cin))
             ).astype(np.float32)
        b = rng.normal(0, 0.1, cout).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            for pad in ("reflect", "wrap"):
                cases.append((name, x, w, b, kw, dtype, pad))
    return cases


def _codec_inputs(depth=3):
    rng = np.random.default_rng(6)
    img = rng.uniform(size=(1, 32, 24, 3)).astype(np.float32)
    feat = np.maximum(rng.normal(0.3, 1.0, (1, 8, 6, 256)), 0).astype(
        np.float32)
    return img, feat, depth


STEP_ITERS = 3


def _loop_inputs():
    rng = np.random.default_rng(0)
    c = 16
    feature = np.maximum(rng.normal(0.3, 1.0, (1, 16, 8, c)), 0).astype(
        np.float32)
    content = np.maximum(rng.normal(0.5, 1.0, (1, 16, 8, c)), 0).astype(
        np.float32)
    samples = np.maximum(rng.normal(0.5, 1.0, (200, c)), 0).astype(np.float32)
    mu = samples.mean(0).reshape(1, 1, 1, c).astype(np.float32)
    xc = samples - samples.mean(0)
    cov = (xc.T @ xc / len(samples)).astype(np.float32)
    rots = RotationStream(11)(0, 0, STEP_ITERS, c)
    return feature, mu, cov, samples, content, rots


def _grid_inputs():
    feature, mu, cov, samples, _, rots = _loop_inputs()
    rng = np.random.default_rng(9)
    feature = np.maximum(rng.normal(0.3, 1.0, (2, 8, 8, 16)), 0).astype(
        np.float32)
    return feature, mu, cov, samples, rots


def _jax_cases():
    stream = RotationStream(41)
    kw = dict(RUN, seed=0, no_pca=True, fast_codec=False)
    return dict(stream=stream, kw=kw, noise=_noise((1, 64, 64, 3)),
                grid_noise=_noise((2, 64, 64, 3), seed=6),
                stacks=_pass0_stacks(stream, kw, (128, 64)))


def _port_case(name, noise, content):
    kw = {**RUN, **PORT_CASES[name]}
    width = kw.get("out_width") or 64
    return (kw, noise if width == 64 else _noise((1, 64, width, 3)),
            content if name in WITH_CONTENT else None)


# ---------------------------------------------------------------------------
# one spawn of 2 ranks, one of 4


@pytest.fixture(scope="module")
def two_ranks(style, content):
    j = _jax_cases()
    noise = _noise((1, 64, 64, 3), seed=7)
    runs = [({**j["kw"], "spatial_devices": 2}, j["noise"], j["stacks"], None),
            ({**j["kw"], "spatial_devices": 2, "fast_codec": True},
             j["noise"], j["stacks"], None)]
    for name in PORT_CASES:
        kw, nz, cont = _port_case(name, noise, content)
        runs.append(({**kw, "spatial_devices": 2}, nz, None, cont))
    t0 = time.time()
    got = _spawn(ranks.jobs, 2, [
        ("halos", (_halo_input(),)),
        ("exchanged_kernels", (_kernel_cases(),)),
        ("codec_rows", (*_codec_inputs(), "reflect")),
        ("codec_rows", (*_codec_inputs(), "wrap")),
        ("spatial_loops", (*_loop_inputs(), STEP_ITERS)),
        ("layout_runs", (runs, [style])),
        ("divisibility", ([style],))])
    return dict(zip(("halos", "kernels", "codec_reflect", "codec_wrap",
                     "loops", "runs", "divisibility"), got), jax=j,
                noise=noise,
                seconds=time.time() - t0)


@pytest.fixture(scope="module")
def four_ranks(style):
    j = _jax_cases()
    runs = [({**j["kw"], **GRID}, j["grid_noise"], j["stacks"], None)]
    runs += [(kw, j["grid_noise"], None, None) for kw in GRID_CASES[1:]]
    got = _spawn(ranks.jobs, 4, [
        ("halos", (_halo_input(),)),
        ("exchanged_kernels", (_kernel_cases(),)),
        ("spatial_loops", (*_loop_inputs(), STEP_ITERS)),
        ("grid_steps", (2, 2, *_grid_inputs(), STEP_ITERS)),
        ("layout_runs", (runs, [style]))])
    return dict(zip(("halos", "kernels", "loops", "grid", "runs"), got), jax=j)


def _ranks(request, n):
    return request.getfixturevalue({2: "two_ranks", 4: "four_ranks"}[n])


def _shard_map(fn, n, *args, in_specs=None, out_specs=SPACE, axis="space"):
    mesh = jmake_mesh(n, axis=axis)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=in_specs or (SPACE,) * len(args),
        out_specs=out_specs))(*map(jnp.asarray, args))


# ---------------------------------------------------------------------------
# the halo exchange and the exchange and crop


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["reflect", "wrap"])
def test_halo_pad_matches_jax(request, n, mode):
    got = _ranks(request, n)["halos"]
    x = _halo_input()
    ref = np.asarray(_shard_map(
        lambda v: jspatial._halo_pad_h(v, "space", mode), n, x))
    np.testing.assert_array_equal(got[mode], ref)
    # rank 0's 2-row halo: none above under reflect, the ring's last rows
    # under wrap; below, rank 1's first rows
    top, bottom = got[mode + "_rows"]
    h = 16 // n
    np.testing.assert_array_equal(bottom, x[:, h:h + 2])
    if mode == "reflect":
        assert top is None
    else:
        np.testing.assert_array_equal(top, x[:, -2:])


@pytest.mark.parametrize("n", [2, 4])
def test_exchanged_kernels_match_the_whole_image(request, n):
    """Each kernel's plain version by exchange and crop on n shards equals
    the same plain version on the whole image."""
    got = _ranks(request, n)["kernels"]
    cases = _kernel_cases()
    assert len(got) == len(cases) == 32
    for (name, x, w, b, kw, dtype, pad), g in zip(cases, got):
        ref = ranks.kernel_call(name, x, w, b, kw, dtype, pad).numpy()
        assert g.shape == ref.shape, (name, g.shape, ref.shape)
        err = float(np.abs(g - ref).max())
        # f32: the CPU's conv may pick another algorithm at another height
        # (its sums then round otherwise, everywhere, ~1e-7 relative); bf16:
        # one rounding to bf16 at the output, which such a sum may cross
        scale = float(np.abs(ref).max())
        bound = (1e-6 if dtype == torch.float32 else 2.0 ** -7) * scale
        assert err <= bound, (name, kw, dtype, pad, err)


@pytest.mark.parametrize("pad", ["reflect", "wrap"])
def test_codec_rows_match_jax(two_ranks, pad):
    got = two_ranks["codec_" + pad]
    img, feat, depth = _codec_inputs()
    bank = JBank(depth)
    enc, dec = bank.enc_params[depth], bank.dec_params[depth]
    ref_enc = np.asarray(_shard_map(
        lambda v: jspatial.encode_spatial(enc, depth, v, "space", pad), 2,
        img))
    ref_dec = np.asarray(_shard_map(
        lambda v: jspatial.decode_spatial(dec, depth, v, "space", pad), 2,
        feat))
    for k, ref in (("head", ref_enc), ("encode", ref_enc), ("tail", ref_dec),
                   ("decode", ref_dec)):
        assert got[k].shape == ref.shape, (k, got[k].shape)
        np.testing.assert_allclose(got[k], ref, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the loops vs JAX's under shard_map


def _jax_loops(n, monkeypatch):
    feature, mu, cov, samples, content, rots = _loop_inputs()
    mu, cov, s = map(jnp.asarray, (mu, cov, samples))
    monkeypatch.setattr(jshard, "stage_rotations",
                        lambda key, n_iters, c: jnp.asarray(rots[:n_iters]))
    key = jax.random.key(0)

    def run(fn):
        return np.asarray(_shard_map(fn, n, feature, content))

    out = {}
    for mode in ("chol", "pca", "sym"):
        out[mode] = run(lambda x, c, m=mode: jspatial.spatial_transport_loop(
            key, x, mu, cov, STEP_ITERS, m, "space"))
        out[mode + "_content"] = run(
            lambda x, c, m=mode: jspatial.spatial_transport_loop(
                key, x, mu, cov, STEP_ITERS, m, "space", content_feature=c,
                content_strength=0.3))
        out[mode + "_iter"] = run(
            lambda x, c, m=mode: jspatial.spatial_transport_loop(
                key, x, mu, cov, STEP_ITERS, m, "space", cov_prop=False))
    for mode in ("cdf", "sort"):
        out[mode] = run(lambda x, c, m=mode: jspatial.spatial_transport_loop(
            key, x, mu, cov, STEP_ITERS, m, "space", style_samples=s))
    out["cdf_step"] = run(lambda x, c: jspatial.spatial_transport_loop(
        key, x, mu, cov, 1, "cdf", "space", style_samples=s))
    out["sort_content"] = run(lambda x, c: jspatial.spatial_transport_loop(
        key, x, mu, cov, STEP_ITERS, "sort", "space", style_samples=s,
        content_feature=c, content_strength=0.3))
    t = (jnp.asarray(feature).reshape(-1, 16) @ jnp.asarray(rots[0])).T
    sr = (s @ jnp.asarray(rots[0])).T
    lo = jnp.minimum(t.min(axis=1), sr.min(axis=1))
    hi = jnp.maximum(t.max(axis=1), sr.max(axis=1))
    out["counts"] = np.asarray(jhistmatch.histogram_rows(t, lo, hi))
    return out


def _one_process_counts():
    """The first cdf step's target counts of the whole cloud, in this
    process (the port's ops on the unsharded feature)."""
    from optimaltextures_tpu_torch.ops import cdf

    feature, _, _, samples, _, rots = _loop_inputs()
    rot = torch.as_tensor(rots[0])
    t = rot.T @ torch.as_tensor(feature).reshape(-1, 16).T
    s = rot.T @ torch.as_tensor(samples).T
    lo = torch.minimum(t.amin(1), s.amin(1))
    hi = torch.maximum(t.amax(1), s.amax(1))
    return cdf.histogram_plain(t, lo, hi, 256).numpy()


MOMENT_KEYS = [m + k for m in ("chol", "pca", "sym")
               for k in ("", "_content", "_iter")] + ["sort", "sort_content"]


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_loops_match_jax(request, monkeypatch, n):
    got = _ranks(request, n)["loops"]
    ref = _jax_loops(n, monkeypatch)
    for k in MOMENT_KEYS:
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(ref[k]).max())), (k, err)
    # cdf: the global counts of the first step bit-equal to the whole
    # cloud's in one process; JAX's rotation rounds otherwise, so against
    # its counts a sample on a bin edge may sit in the next bin; the step
    # within the PWL's rounding, the loop by distribution
    np.testing.assert_array_equal(got["cdf_t_hist"], _one_process_counts())
    assert got["cdf_t_hist"].sum() == ref["counts"].sum() == 16 * 8 * 16
    assert float(np.abs(got["cdf_t_hist"] - ref["counts"]).sum()) <= 4
    assert float(np.abs(got["cdf_step"] - ref["cdf_step"]).max()) <= 1e-4
    a, b = (np.sort(x.reshape(-1, 16), 0) for x in (got["cdf"], ref["cdf"]))
    assert float(np.abs(a - b).mean()) <= 1e-4


def test_grid_steps_match_jax(four_ranks, monkeypatch):
    """_sort_step_grid and grid_transport_loop on the 2 x 2 grid vs JAX's
    under shard_map on a 2 x 2 mesh: the two-step gather recovers the
    single-device flatten order, so sort equals JAX's (and the whole
    batch's sort step) within 1e-5."""
    from optimaltextures_tpu_torch import transport

    got = four_ranks["grid"]
    feature, mu, cov, samples, rots = _grid_inputs()
    monkeypatch.setattr(jshard, "stage_rotations",
                        lambda key, n_iters, c: jnp.asarray(rots[:n_iters]))
    mesh = jgrid.make_grid_mesh(2, 2)
    spec = P("data", "space", None, None)
    mu, cov, s, rot = map(jnp.asarray, (mu, cov, samples, rots[0]))
    key = jax.random.key(0)

    def run(fn):
        return np.asarray(jax.jit(jax.shard_map(
            fn, mesh=mesh, in_specs=(spec,), out_specs=spec))(
                jnp.asarray(feature)))

    ref = {"sort_step": run(lambda x: jshard._sort_step_grid(
        rot, x, s, "data", "space"))}
    for mode, kw in (("chol", {}), ("chol_iter", dict(cov_prop=False)),
                     ("sort", dict(style_samples=s))):
        ref[mode] = run(lambda x, m=mode, kw=kw: jgrid.grid_transport_loop(
            key, x, mu, cov, STEP_ITERS, m.split("_")[0], "data", "space",
            **kw))
    for k, r in ref.items():
        err = float(np.abs(got[k] - r).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(r).max())), (k, err)
    whole = transport._sampled_step_with_rot(
        torch.as_tensor(rots[0]), torch.as_tensor(feature),
        torch.as_tensor(samples), "sort")
    np.testing.assert_array_equal(got["sort_step"], whole.numpy())
    one = transport.transport_loop(
        None, torch.as_tensor(feature),
        transport.StyleStats(torch.as_tensor(mu), torch.as_tensor(cov),
                             torch.as_tensor(samples)), STEP_ITERS, "cdf",
        rotations=torch.as_tensor(rots))
    a, b = (np.sort(x.reshape(-1, 16), 0) for x in (got["cdf"], one.numpy()))
    assert float(np.abs(a - b).mean()) <= 1e-4


# ---------------------------------------------------------------------------
# whole runs


def _jax_run(kw, noise, style, stream, monkeypatch, n_stages):
    calls = []
    monkeypatch.setattr(jshard, "stage_rotations",
                        _fake_stage_rotations(stream, calls))
    ref = np.asarray(jcore.Synthesizer(jconfig.OptexConfig(**kw)).run(
        jnp.asarray(noise), [style]))
    assert calls == list(range(n_stages))   # one pass program, traced once
    return ref


@pytest.mark.parametrize("fast_codec", [False, True],
                         ids=["conv2d_halo", "exchanged_kernels"])
def test_spatial_run_matches_jax(two_ranks, style, monkeypatch, fast_codec):
    """The port's 2-rank run, on the F.conv2d halo stack and on the codec
    kernels' plain versions by exchange and crop, vs JAX's spatial_devices=2
    run with the same noise and rotations."""
    j = two_ranks["jax"]
    got = two_ranks["runs"][int(fast_codec)]
    ref = _jax_run({**j["kw"], "spatial_devices": 2}, j["noise"], style,
                   j["stream"], monkeypatch, 2)
    assert got.shape == (2, 1, 64, 64, 3)
    np.testing.assert_array_equal(got[0], got[1])   # every rank's result
    err = float(np.abs(got[0] - ref).max())
    assert err < 5e-4, err


@pytest.mark.parametrize("case", list(PORT_CASES))
def test_spatial_run_matches_one_process(two_ranks, style, content, case):
    got = two_ranks["runs"][2 + list(PORT_CASES).index(case)]
    np.testing.assert_array_equal(got[0], got[1])
    kw, noise, cont = _port_case(case, two_ranks["noise"], content)
    ref = tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu").run(
        noise, [style], content=cont).numpy()
    assert got[0].shape == ref.shape == (1, 64, kw.get("out_width") or 64, 3)
    if case in BY_DISTRIBUTION:
        _hold_distribution(got[0], ref)
    else:
        err = float(np.abs(got[0] - ref).max())
        assert err <= 2e-4, err


def test_grid_run_matches_jax(four_ranks, style, monkeypatch):
    j = four_ranks["jax"]
    got = four_ranks["runs"][0]
    ref = _jax_run({**j["kw"], **GRID}, j["grid_noise"], style, j["stream"],
                   monkeypatch, 2)
    assert got.shape == (4, 2, 64, 64, 3)
    for r in range(1, 4):
        np.testing.assert_array_equal(got[0], got[r])
    err = float(np.abs(got[0] - ref).max())
    assert err < 5e-4, err
    assert float(np.abs(got[0][0] - got[0][1]).mean()) > 0.05


@pytest.mark.parametrize("case", [1, 2], ids=["pca", "sort"])
def test_grid_run_matches_one_process(four_ranks, style, case):
    kw = {k: v for k, v in GRID_CASES[case].items()
          if k not in ("num_devices", "spatial_devices")}
    got = four_ranks["runs"][case]
    ref = tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu").run(
        four_ranks["jax"]["grid_noise"], [style]).numpy()
    assert got[0].shape == ref.shape == (2, 64, 64, 3)
    if kw.get("hist_mode") == "sort":
        _hold_distribution(got[0], ref)
    else:
        err = float(np.abs(got[0] - ref).max())
        assert err <= 2e-4, err


# ---------------------------------------------------------------------------
# the divisibility check, the CLI


@pytest.mark.parametrize("h,n,depth", [(100, 8, 3), (64, 4, 6), (96, 4, 5)])
def test_divisibility_message_equals_jax(h, n, depth):
    with pytest.raises(ValueError) as got:
        tspatial.check_spatial_divisibility(h, n, depth)
    with pytest.raises(ValueError) as want:
        jspatial.check_spatial_divisibility(h, n, depth)
    assert str(got.value) == str(want.value)
    tspatial.check_spatial_divisibility(256, 8, 3)


def test_synthesizer_checks_every_pass_height(two_ranks):
    """On 2 ranks: a Synthesizer whose pass size does not split refuses to
    start, and a run whose content gives a pass height that does not split
    refuses to run, each with the check's message."""
    at_init, at_run = two_ranks["divisibility"]
    assert at_init == ("H=66 must be divisible by n_devices*2^(depth-1)=4 "
                       "for spatial sharding at depth 2")
    assert at_run.startswith("H=") and "=4 for spatial sharding" in at_run


def test_cli_spatial_devices_on_cpu(tmp_path):
    common = ["--style", SAMPLE, "--size", "64", "--passes", "1", "--iters",
              "8", "--no_multires", "--depth", "2", "--seed", "1",
              "--device", "cpu", "--quiet"]
    assert cli.main(common + ["--spatial_devices", "2", "--output_dir",
                              str(tmp_path / "sp")]) == 0
    assert cli.main(common + ["--output_dir", str(tmp_path / "one")]) == 0
    sp, one = _png_dir(tmp_path / "sp"), _png_dir(tmp_path / "one")
    assert sorted(sp) == sorted(one) and len(sp) == 1
    for name in sp:   # within one 8-bit level of the one-process run
        assert np.abs(sp[name] - one[name]).max() <= 1, name
