"""The port's data-parallel half of ``parallel/`` on the CPU: gloo ranks
started by ``parallel.mesh.spawn`` (rank bodies in tests/torch_parallel_ranks.py),
held against the JAX package's sharded functions on the 8 virtual CPU
devices tests/conftest.py provides, and against the port's own
single-process runs.

* The mesh's collectives and refusals; a failing rank, and one that hangs,
  end the spawn before its deadline.
* The sharded steps and loops at N = 2 and 4 vs JAX's under jax.shard_map on
  the same numpy inputs and rotations: moments and sort within 1e-5, cdf
  with bit-equal global counts.
* Whole batch-DP runs (64 px, depth 2, batch 4, 2 ranks): vs JAX's
  num_devices=2 run with the same noise and rotations (chol, no PCA, 5e-4),
  and vs the port's single-process run (2e-4) with PCA, batch_chunk,
  cov_propagation=False, pca_bucket, pca_traced_k, tileable and multires;
  cdf and sort by distribution (their matchers are bit-equal step by step,
  but a rank of a near-tie moves with the codec's rounding at another batch
  size, so whole runs diverge pixel by pixel).
* Style-parallel on 2 ranks vs ``mesh=None`` and vs JAX's
  ``synthesize_style_batch`` on a 2-device mesh.
* validate(), the layouts' Synthesizer outside a process group, and the
  CLI's --num_devices (alone and in the grid) and --style_parallel.

Styles come from docs/samples/; every spawn gets a deadline, so a fault
costs seconds, not the suite's time limit."""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp
from jax.sharding import PartitionSpec as P

from optimaltextures_tpu import config as jconfig
from optimaltextures_tpu import core as jcore
from optimaltextures_tpu.ops import histmatch as jhistmatch
from optimaltextures_tpu.parallel import shard_ot as jshard
from optimaltextures_tpu.parallel import style_dp as jstyle_dp
from optimaltextures_tpu.parallel.mesh import make_mesh as jmake_mesh
from optimaltextures_tpu_torch import cli
from optimaltextures_tpu_torch import config as tconfig
from optimaltextures_tpu_torch import core as tcore
from optimaltextures_tpu_torch.parallel import mesh as tmesh
from optimaltextures_tpu_torch.parallel import style_dp as tstyle_dp
from optimaltextures_tpu_torch.utils import imageio, schedule
import torch_parallel_ranks as ranks
from test_torch_settings import one_torch_thread  # noqa: F401
from test_torch_slice import SAMPLE, RotationStream

SAMPLE_B = os.path.join(os.path.dirname(SAMPLE), "zebra_pattern_lava_mix3_256.png")
DEADLINE = 400.0
# the runs: 64 px, 2 passes of 40 iterations at one size, depth 2, batch 4
RUN = dict(size=64, passes=2, iters=40, no_multires=True, depth=2, seed=3,
           batch=4, style=["graffiti.png"])
# the port-vs-port cases, each against the same run in one process
PORT_CASES = {
    "pca": dict(),
    "no_pca": dict(no_pca=True),
    "batch_chunk": dict(batch_chunk=1),
    "no_cov_prop": dict(cov_propagation=False),
    "pca_bucket": dict(pca_bucket=16),
    "traced_k": dict(pca_traced_k=True),
    "tileable": dict(tileable=True),
    "multires": dict(no_multires=False),
    "sym": dict(hist_mode="sym"),
    "cdf": dict(hist_mode="cdf"),
    "sort": dict(hist_mode="sort"),
}
BY_DISTRIBUTION = ("cdf", "sort")


def _spawn(target, n, *args, deadline_s=DEADLINE):
    return tmesh.spawn(target, n, backend="gloo", device="cpu", args=args,
                       deadline_s=deadline_s)


@pytest.fixture(scope="module")
def style():
    return imageio.load_image(SAMPLE, 64)


@pytest.fixture(scope="module")
def style_b():
    return imageio.load_image(SAMPLE_B, 64)


def _noise(shape, seed=5):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _pass0_stacks(stream, kw, channels):
    """{(p, i): stream(0, i, ...)} for every pass: the JAX package traces a
    pass program once and reuses it for a pass of the same iterations, so
    every pass of its run draws pass 0's stacks."""
    table, _ = schedule.iters_and_sizes(kw["size"], kw["iters"], kw["passes"],
                                        not kw.get("no_multires", False),
                                        num_layers=kw["depth"])
    return {(p, i): stream(0, i, n, c) for p, row in enumerate(table)
            for i, (n, c) in enumerate(zip(row, channels))}


def _fake_stage_rotations(stream, calls):
    def fake(key, n_iters, n):
        i = len(calls)
        calls.append(i)
        return jnp.asarray(stream(0, i, n_iters, n))
    return fake


# ---------------------------------------------------------------------------
# step inputs (shared by N = 2 and 4)

STEP_ITERS = 3


def _step_inputs():
    rng = np.random.default_rng(0)
    c = 16
    feature = np.maximum(rng.normal(0.3, 1.0, (4, 8, 8, c)), 0).astype(np.float32)
    samples = np.maximum(rng.normal(0.5, 1.0, (200, c)), 0).astype(np.float32)
    mu = samples.mean(0).reshape(1, 1, 1, c).astype(np.float32)
    xc = samples - samples.mean(0)
    cov = (xc.T @ xc / len(samples)).astype(np.float32)
    rots = RotationStream(11)(0, 0, STEP_ITERS, c)
    return feature, mu, cov, samples, rots


def _jax_steps(n, monkeypatch):
    """JAX's sharded steps and loops under jax.shard_map on n devices."""
    feature, mu, cov, samples, rots = _step_inputs()
    mesh = jmake_mesh(n)
    mu, cov, s, rot = map(jnp.asarray, (mu, cov, samples, rots[0]))
    monkeypatch.setattr(jshard, "stage_rotations",
                        lambda key, n_iters, c: jnp.asarray(rots[:n_iters]))

    def run(fn):
        return np.asarray(jax.jit(jax.shard_map(
            fn, mesh=mesh, in_specs=(P("data"),), out_specs=P("data")))(
                jnp.asarray(feature)))

    key = jax.random.key(0)
    out = {}
    for mode in ("chol", "pca", "sym"):
        out[mode] = run(lambda x, m=mode: jshard._moment_step_sharded(
            rot, x, mu, cov, m, "data"))
        out[mode + "_loop"] = run(lambda x, m=mode: jshard.sharded_transport_loop(
            key, x, mu, cov, STEP_ITERS, m, "data"))
        out[mode + "_iter"] = run(lambda x, m=mode: jshard.sharded_transport_loop(
            key, x, mu, cov, STEP_ITERS, m, "data", cov_prop=False))
    out["cdf"] = run(lambda x: jshard._cdf_step_sharded(rot, x, s, "data"))
    out["sort"] = run(lambda x: jshard._sort_step_sharded(rot, x, s, "data"))
    for mode in ("cdf", "sort"):
        out[mode + "_loop"] = run(lambda x, m=mode: jshard.sharded_transport_loop(
            key, x, mu, cov, STEP_ITERS, m, "data", style_samples=s))
    # the single-device counts of the whole rotated cloud: the psum'd
    # per-shard counts equal them exactly
    t = (jnp.asarray(feature).reshape(-1, feature.shape[-1]) @ rot).T
    sr = (s @ rot).T
    lo = jnp.minimum(t.min(axis=1), sr.min(axis=1))
    hi = jnp.maximum(t.max(axis=1), sr.max(axis=1))
    out["counts"] = np.asarray(jhistmatch.histogram_rows(t, lo, hi))
    return out


def _chunk_inputs():
    """_chunked_stage_local's inputs: batch 4 at 32 px, depth 2, 2 chunks a
    rank, relu2_1-wide style statistics, 3 rotations."""
    rng = np.random.default_rng(2)
    feats = np.maximum(rng.normal(0.5, 1.0, (300, 128)), 0).astype(np.float32)
    xc = feats - feats.mean(0)
    return (rng.uniform(size=(4, 32, 32, 3)).astype(np.float32),
            feats.mean(0).reshape(1, 1, 1, 128).astype(np.float32),
            (xc.T @ xc / len(feats)).astype(np.float32),
            RotationStream(13)(0, 0, 3, 128), 2, 2)


# ---------------------------------------------------------------------------
# one spawn of 2 ranks for the mesh, the steps, the DP runs and the
# style-parallel runs; one of 4 ranks for the mesh and the steps


def _jax_cases(style, style_b):
    stream = RotationStream(37)
    dp_kw = dict(RUN, seed=0, no_pca=True, fast_codec=False)
    sp_kw = dict(RUN, seed=0, no_pca=True, fast_codec=False, batch=1,
                 style=["a.png", "b.png"])
    return dict(stream=stream, dp_kw=dp_kw, sp_kw=sp_kw,
                dp_noise=_noise((4, 64, 64, 3)),
                sp_noise=_noise((2, 64, 64, 3), seed=8),
                stacks=_pass0_stacks(stream, dp_kw, (128, 64)))


@pytest.fixture(scope="module")
def two_ranks(style, style_b):
    j = _jax_cases(style, style_b)
    noise = _noise((4, 64, 64, 3))
    dp_cases = [({**j["dp_kw"], "num_devices": 2}, j["dp_noise"], j["stacks"])]
    dp_cases += [({**RUN, **kw, "num_devices": 2}, noise, None)
                 for kw in PORT_CASES.values()]
    sp_cases = [({**j["sp_kw"], "num_devices": 2}, j["sp_noise"], j["stacks"],
                 None),
                (dict(RUN, batch=1, pca_bucket=16, style=["a", "b"]),
                 j["sp_noise"], None, None),
                (dict(RUN, batch=1, pca_bucket=16, hist_mode="cdf",
                      style=["a", "b"]), j["sp_noise"], None, None)]
    t0 = time.time()
    got = _spawn(ranks.jobs, 2, [
        ("collectives", ()), ("steps", (*_step_inputs(), STEP_ITERS)),
        ("chunked_stage", _chunk_inputs()),
        ("dp_runs", (dp_cases, [style])),
        ("style_runs", (sp_cases, [style, style_b]))])
    return dict(zip(("mesh", "steps", "chunked", "dp", "sp"), got), jax=j,
                noise=noise,
                sp_cases=sp_cases, seconds=time.time() - t0)


@pytest.fixture(scope="module")
def four_ranks():
    return dict(zip(("mesh", "steps"), _spawn(ranks.jobs, 4, [
        ("collectives", ()), ("steps", (*_step_inputs(), STEP_ITERS))])))


def _ranks(request, n):
    return request.getfixturevalue({2: "two_ranks", 4: "four_ranks"}[n])


# ---------------------------------------------------------------------------
# the mesh


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_collectives(request, n):
    m = _ranks(request, n)["mesh"]
    total = n * (n + 1) / 2
    assert m["rank"] == 0 and m["size"] == n and m["device"] == "cpu"
    assert m["psum"].tolist() == [total, -total]
    assert m["pmin"].tolist() == [1.0, -n] and m["pmax"].tolist() == [n, -1.0]
    want = [[r + 1.0, -(r + 1.0)] for r in range(n)]
    assert m["gather0"].tolist() == want
    assert m["gather1"].tolist() == np.asarray(want).T.tolist()
    assert m["bcast"].tolist() == [float(n), -float(n)]
    assert m["bcast_int"] == 100 and m["ints"].tolist() == [n * (n - 1) // 2]
    assert f"requested {n + 1} devices" in m["refusal"]


def test_mesh_refusals():
    with pytest.raises(RuntimeError, match="spawn.*torchrun"):
        tmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="n >= 1"):
        tmesh.spawn(ranks.collectives, 0, backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="nccl|gloo"):
        tmesh.spawn(ranks.collectives, 2, backend="mpi", device="cpu")
    assert tmesh._rank_device(None, 3) == torch.device("cuda", 3)
    assert tmesh._rank_device("cuda:0", 3) == torch.device("cuda", 0)
    assert tmesh._rank_device("cpu", 3) == torch.device("cpu")


def test_failing_rank_ends_the_spawn_with_its_error():
    t0 = time.time()
    with pytest.raises(tmp.ProcessRaisedException, match="rank one fails"):
        _spawn(ranks.fails, 2, "rank one fails", deadline_s=60.0)
    assert time.time() - t0 < 60.0


def test_hung_rank_ends_at_the_deadline():
    t0 = time.time()
    with pytest.raises(TimeoutError, match="within 4.0 s"):
        _spawn(ranks.hangs, 2, deadline_s=4.0)
    assert time.time() - t0 < 30.0


# ---------------------------------------------------------------------------
# the sharded steps vs JAX's under shard_map

STEP_KEYS = ["chol", "pca", "sym", "chol_loop", "pca_loop", "sym_loop",
             "chol_iter", "pca_iter", "sym_iter", "sort", "sort_loop"]


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_steps_match_jax(request, monkeypatch, n):
    got = _ranks(request, n)["steps"]
    ref = _jax_steps(n, monkeypatch)
    for k in STEP_KEYS:
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(ref[k]).max())), (k, err)
    # cdf: the global counts bit-equal, the matched step within the PWL's
    # rounding; over several steps a sample a rounding from a bin edge
    # lands in the next bin and the loops part pixel by pixel, so the loop
    # is held by each channel's distribution
    np.testing.assert_array_equal(got["cdf_t_hist"], ref["counts"])
    assert got["cdf_t_hist"].sum() == 4 * 8 * 8 * 16
    assert float(np.abs(got["cdf"] - ref["cdf"]).max()) <= 1e-4
    a, b = (np.sort(x.reshape(-1, 16), 0) for x in (got["cdf_loop"],
                                                    ref["cdf_loop"]))
    assert float(np.abs(a - b).mean()) <= 1e-4


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_steps_match_one_process(request, n):
    """The same steps on the whole batch in this process: the ranks' cdf
    and sort steps are bit-equal to it."""
    from optimaltextures_tpu_torch import transport

    got = _ranks(request, n)["steps"]
    feature, mu, cov, samples, rots = map(torch.as_tensor, _step_inputs())
    for mode in ("cdf", "sort"):
        ref = transport._sampled_step_with_rot(rots[0], feature, samples, mode)
        np.testing.assert_array_equal(got[mode], ref.numpy())
    for mode in ("chol", "pca", "sym"):
        ref = transport.transport_loop(
            None, feature, transport.StyleStats(mu, cov), STEP_ITERS, mode,
            rotations=rots)
        assert float(np.abs(got[mode + "_loop"] - ref.numpy()).max()) <= 1e-5
    # every rank draws the one rotation a same-seeded generator gives
    ref = transport.ot_step_moment(torch.Generator().manual_seed(5), feature,
                                   transport.StyleStats(mu, cov), "chol")
    assert float(np.abs(got["chol_gen"] - ref.numpy()).max()) <= 1e-5


def test_chunked_stage_local_matches_jax(two_ranks, monkeypatch):
    """batch_chunk x DP, one stage: JAX's _chunked_stage_local under
    shard_map on 2 devices, the same weights, statistics and rotations."""
    from optimaltextures_tpu.models.vgg import VGGBank as JBank

    pastiche, mu, cov, rots, depth, n_chunks = _chunk_inputs()
    bank = JBank(depth)
    monkeypatch.setattr("optimaltextures_tpu.transport.stage_rotations",
                        lambda key, n_iters, c: jnp.asarray(rots[:n_iters]))
    fn = jax.jit(jax.shard_map(
        lambda x: jshard._chunked_stage_local(
            bank.enc_params[depth], bank.dec_params[depth], x,
            jnp.asarray(mu), jnp.asarray(cov), None, jax.random.key(0), None,
            depth=depth, n_iters=len(rots), mode="chol", pca_flag=False,
            n_chunks=n_chunks, axis="data", pad_mode="reflect",
            conv_dtype=jnp.float32),
        mesh=jmake_mesh(2), in_specs=(P("data"),), out_specs=P("data")))
    ref = np.asarray(fn(jnp.asarray(pastiche)))
    got = two_ranks["chunked"]
    assert got.shape == ref.shape == (4, 32, 32, 3)
    err = float(np.abs(got - ref).max())
    assert err < 5e-4, err


# ---------------------------------------------------------------------------
# whole batch-DP runs


def test_dp_run_matches_jax_dp(two_ranks, style, monkeypatch):
    j = two_ranks["jax"]
    got = two_ranks["dp"][0]
    calls = []
    monkeypatch.setattr(jshard, "stage_rotations",
                        _fake_stage_rotations(j["stream"], calls))
    synth = jcore.Synthesizer(jconfig.OptexConfig(**j["dp_kw"], num_devices=2))
    ref = np.asarray(synth.run(jnp.asarray(j["dp_noise"]), [style]))
    assert calls == [0, 1]          # one pass program, traced once
    assert got.shape == (2, 4, 64, 64, 3)
    np.testing.assert_array_equal(got[0], got[1])   # every rank's result
    err = float(np.abs(got[0] - ref).max())
    assert err < 5e-4, err
    assert float(np.abs(got[0][0] - got[0][3]).mean()) > 0.05


def _hold_distribution(a, b):
    a, b = a.reshape(-1, 3), b.reshape(-1, 3)
    assert np.isfinite(a).all()
    assert float(np.abs(a.mean(0) - b.mean(0)).max()) <= 3e-3
    assert float(np.abs(a.std(0) - b.std(0)).max()) <= 1e-2
    assert float(np.abs(np.sort(a, 0) - np.sort(b, 0)).mean()) <= 1e-2


@pytest.mark.parametrize("case", list(PORT_CASES))
def test_dp_run_matches_one_process(two_ranks, style, case):
    got = two_ranks["dp"][1 + list(PORT_CASES).index(case)]
    np.testing.assert_array_equal(got[0], got[1])
    kw = {**RUN, **PORT_CASES[case]}
    ref = tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu").run(
        two_ranks["noise"], [style]).numpy()
    assert got[0].shape == ref.shape == (4, 64, 64, 3)
    if case in BY_DISTRIBUTION:
        _hold_distribution(got[0], ref)
    else:
        err = float(np.abs(got[0] - ref).max())
        assert err <= 2e-4, err


# ---------------------------------------------------------------------------
# style-parallel


def test_style_parallel_matches_jax(two_ranks, style, style_b, monkeypatch):
    j = two_ranks["jax"]
    got = two_ranks["sp"][0]
    calls = []
    monkeypatch.setattr("optimaltextures_tpu.transport.stage_rotations",
                        _fake_stage_rotations(j["stream"], calls))
    jstyle_dp._EP_PASS_CACHE.clear()
    try:
        ref = np.asarray(jstyle_dp.synthesize_style_batch(
            jconfig.OptexConfig(**j["sp_kw"]), [style, style_b],
            jmake_mesh(2), pastiche=j["sp_noise"], _force_widths=[0, 0]))
    finally:
        jstyle_dp._EP_PASS_CACHE.clear()
    assert calls == [0, 1]
    assert got.shape == ref.shape == (2, 64, 64, 3)
    err = float(np.abs(got - ref).max())
    assert err < 5e-4, err


@pytest.mark.parametrize("case", [0, 1, 2], ids=["no_pca", "pca", "cdf"])
def test_style_parallel_matches_mesh_none(two_ranks, style, style_b, case):
    """Rank r's texture is style r's of the one-process run: the same
    per-style prep, the same agreed widths, the same noise row and rotations
    (the same calls; another process's BLAS may round differently, so
    within the port's run-parity bound, and cdf by distribution)."""
    kw, pastiche, stacks, _ = two_ranks["sp_cases"][case]
    ref = tstyle_dp.synthesize_style_batch(
        tconfig.OptexConfig(**kw), [style, style_b], None, pastiche=pastiche,
        device="cpu",
        rotations=ranks.Stacks(stacks) if stacks else None).numpy()
    got = two_ranks["sp"][case]
    assert got.shape == ref.shape == (2, 64, 64, 3)
    if kw.get("hist_mode") == "cdf":
        for g, r in zip(got, ref):
            _hold_distribution(g, r)
    else:
        err = float(np.abs(got - ref).max())
        assert err <= 2e-4, err
    assert float(np.abs(ref[0] - ref[1]).mean()) > 0.02


def test_style_widths_are_the_elementwise_max(style, style_b):
    kw = dict(RUN, batch=1, pca_bucket=8, no_multires=False,
              style=["a", "b"])
    cfg = tconfig.OptexConfig(**kw)
    both = tstyle_dp.style_widths(cfg, [style, style_b], device="cpu")
    one = [tstyle_dp.style_widths(cfg, [s], device="cpu")
           for s in (style, style_b)]
    assert set(both) == {256, 64}     # one prep per multires pass size
    for ck, w in both.items():
        assert w == tuple(max(a, b) for a, b in zip(one[0][ck], one[1][ck]))
        assert all(x % 8 == 0 or x in (64, 128) for x in w)


def test_style_parallel_refusals(style, style_b):
    cfg = tconfig.OptexConfig(**dict(RUN, batch=1, style=["a", "b"]))
    with pytest.raises(ValueError, match="equal style shapes"):
        tstyle_dp.synthesize_style_batch(
            cfg, [style, style_b[:, :32]], None, device="cpu")
    with pytest.raises(ValueError, match="batch_chunk does not compose"):
        tstyle_dp.synthesize_style_batch(
            dataclasses.replace(cfg, batch_chunk=1), [style, style_b], None,
            device="cpu")


# ---------------------------------------------------------------------------
# config, the CLI


@pytest.mark.parametrize("kw,message", [
    (dict(spatial_devices=2, batch=2), "batch must be 1"),
    (dict(spatial_devices=2, num_devices=2, batch=3), "2-D grid"),
    (dict(spatial_devices=2, num_devices=2, batch=2, content="c.png"),
     "synthesis-only"),
    (dict(num_devices=2, batch=4, batch_chunk=3), "not divisible by batch_chunk")])
def test_validate_mirrors_jax(kw, message):
    full = dict(size=64, style=["x.png"], **kw)
    with pytest.raises(ValueError, match=message):
        tconfig.OptexConfig(**full).validate()
    with pytest.raises(ValueError, match=message):
        jconfig.OptexConfig(**full).validate()


def test_not_ported_is_spatial_only():
    """Nothing is refused as unported any more: the batch-parallel, spatial
    and grid layouts all validate, and each Synthesizer is one rank of a
    process group (outside one it names the ways to start ranks)."""
    base = dict(size=64, style=["x.png"])
    assert not hasattr(tconfig, "_NOT_PORTED")
    assert not hasattr(tconfig, "require_ported")
    for ok in (dict(num_devices=2, batch=2), dict(num_devices=4, batch=8),
               dict(spatial_devices=2), dict(spatial_devices=4),
               dict(num_devices=2, spatial_devices=2, batch=2)):
        cfg = tconfig.OptexConfig(**base, **ok).validate()
        with pytest.raises(RuntimeError, match="spawn.*torchrun"):
            tcore.Synthesizer(cfg, device="cpu")


def test_synthesizer_needs_a_group_or_a_mesh():
    cfg = tconfig.OptexConfig(size=64, batch=2, num_devices=2, style=["x"])
    with pytest.raises(RuntimeError, match="spawn.*torchrun"):
        tcore.Synthesizer(cfg, device="cpu")


def _png_dir(path):
    from PIL import Image

    return {f: np.asarray(Image.open(os.path.join(path, f))).astype(int)
            for f in sorted(os.listdir(path))}


def test_cli_num_devices_on_cpu(tmp_path):
    common = ["--style", SAMPLE, "--size", "64", "--passes", "1", "--iters",
              "8", "--no_multires", "--depth", "2", "--seed", "1", "--batch",
              "2", "--device", "cpu", "--quiet"]
    assert cli.main(common + ["--num_devices", "2", "--output_dir",
                              str(tmp_path / "dp")]) == 0
    assert cli.main(common + ["--output_dir", str(tmp_path / "one")]) == 0
    dp, one = _png_dir(tmp_path / "dp"), _png_dir(tmp_path / "one")
    assert sorted(dp) == sorted(one) and len(dp) == 2
    for name in dp:   # within one 8-bit level of the one-process run
        assert np.abs(dp[name] - one[name]).max() <= 1, name
    # the 2 x 2 grid (item 15b): the same images as the one-process run
    assert cli.main(common + ["--num_devices", "2", "--spatial_devices", "2",
                              "--output_dir", str(tmp_path / "grid")]) == 0
    grid = _png_dir(tmp_path / "grid")
    assert sorted(grid) == sorted(one)
    for name in grid:
        assert np.abs(grid[name] - one[name]).max() <= 1, name


def test_cli_style_parallel(tmp_path):
    common = ["--style", SAMPLE, SAMPLE_B, "--size", "64", "--passes", "1",
              "--iters", "8", "--no_multires", "--depth", "2", "--seed", "1",
              "--pca_bucket", "16", "--style_parallel", "--device", "cpu",
              "--quiet"]
    assert cli.main(common + ["--num_devices", "2", "--output_dir",
                              str(tmp_path / "two")]) == 0
    assert cli.main(common + ["--output_dir", str(tmp_path / "one")]) == 0
    two, one = _png_dir(tmp_path / "two"), _png_dir(tmp_path / "one")
    assert len(two) == 2 and sorted(two) == sorted(one)
    assert any("graffiti" in f for f in two) and any("zebra" in f for f in two)
    for name in two:   # within one 8-bit level of the one-process run
        assert np.abs(two[name] - one[name]).max() <= 1, name
    with pytest.raises(ValueError, match="1 styles for num_devices=2"):
        cli.main(common[:1] + [SAMPLE] + common[3:] + ["--num_devices", "2"])
