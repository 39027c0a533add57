"""The multi-device paths of the port on N ranks: a dry run of each part,
and the walls of whole runs (the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``).

    python -m optimaltextures_tpu_torch.tools.dryrun_multichip [--n 2]
    python -m optimaltextures_tpu_torch.tools.dryrun_multichip --device cuda --n 4
    python -m optimaltextures_tpu_torch.tools.dryrun_multichip --device cuda --n 4 --walls [--parts dp|spatial|serve]

The dry run starts ``--n`` ranks (gloo on the CPU by default, NCCL on
``cuda:0 .. cuda:N-1`` with ``--device cuda``) and runs, each through
``parallel.shard_ot.make_sharded_pass`` or ``parallel.style_dp``, on the
weights of ``weights/`` and synthetic style statistics: DP; DP with
batch_chunk; DP in bf16 at a local batch of 128 (the JAX package's
fast-codec DP case); style-parallel (EP); DP in cdf mode; DP in sort mode;
a two-stage DP pass with a pca_bucket-padded basis; then spatial sharding
(``parallel.spatial.make_spatial_pass``, one 64-px image's rows over the N
ranks): reflect, cdf, sort and the wrap ring of a tileable run, each
against the same pass on the whole image in the rank; and with N even and
>= 4 the (N/2 x 2) grid (``parallel.grid.make_grid_pass``, batch N/2). Each
part prints its output's shape and rank 0's kernel launches, and raises on
a wrong shape or a non-finite value.

``--walls`` (GPU) times whole 512-px runs at the main path's settings, cold
and warm, on N ranks: DP at batch N in f32 (one image a card), DP at batch
128 N in bf16 (128 a card) and N styles style-parallel, each beside the
same per-card work on one card in this process (batch 1, batch 128, one
style), and prints them, with images/s, peak memory and the card's name and
power limit, then one JSON line. Its spatial part (``--parts spatial``
runs it alone) times one 2048-px image at the main path's settings on N
cards (spatial_devices N) against the same image on one card, and, with N
= 4, a 2 x 2 grid (batch 2 at 1024 px) against batch 2 on one card: walls
cold and warm, each rank's launches and peak memory, and the output's
max |diff| from the one-card run. Its serve part (``--parts serve``)
starts an HTTP server in this process (``serve.serve``, ``workers`` N on
the N cards) and sends it seeded multi-device requests, which run on the
server's persistent rank group: DP batch N at 512 px, one 2048-px image on
N cards (spatial_devices N) and, with N = 4, the 2 x 2 grid at 1024 px,
batch 2; each once cold (with the first, the group's start), then 5 warm
in npy and 5 in png, beside ``api.run_files`` of the same config (which
starts its ranks every call), and the served output's max |diff| in uint8
levels from it.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
SAMPLES = os.path.join(REPO, "docs", "samples")
# four 512-px style images of one shape, for up to four style-parallel ranks
STYLES_512 = ("graffiti_4096px_preview512.png", "graffiti_sort_512.png",
              "lava-small_rocket_strength0.2_cholhist_512.png",
              "style_parallel_2x2.png")


def card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them ("cpu" on
    the CPU)."""
    if torch.device(device).type == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def launch_counts() -> dict:
    from ..ops import cdf, codec

    return {**codec.LAUNCHES, **cdf.LAUNCHES}


def reset_counts() -> None:
    from ..ops import cdf, codec

    codec.reset_launches()
    cdf.reset_launches()


def gather_counts(mesh, counts: dict) -> list:
    """Every rank's launch counts (the same keys on every rank), rank order."""
    keys = sorted(counts)
    dev = mesh.device if mesh.backend == "nccl" else "cpu"
    got = mesh.all_gather(torch.tensor([[counts[k] for k in keys]],
                                       dtype=torch.int64, device=dev))
    return [dict(zip(keys, row)) for row in got.tolist()]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


# ---------------------------------------------------------------------------
# rank bodies (module-level: spawn pickles them by name)


def run_rank(mesh, cfg_kw: dict, styles, labels=("cold", "warm"),
             noise=None, rotations=None):
    """``core.synthesize`` (or ``Synthesizer.run`` of ``noise``) of
    ``cfg_kw`` on this rank, once per label, each run's launch counts set
    to 0 just before it and read just after. Returns (on rank 0) the walls,
    every rank's counts and peak device memory of the last run, and the
    gathered output of the last run (numpy)."""
    from .. import config, core

    cfg = config.OptexConfig(**cfg_kw)
    walls, out = [], None
    for _ in labels:
        del out
        _reset_peak(mesh.device)
        mesh.barrier()
        reset_counts()
        t0 = time.time()
        if noise is None:
            out, _ = core.synthesize(cfg, styles, mesh=mesh)
        else:
            out = core.Synthesizer(cfg, mesh=mesh).run(noise, styles,
                                                       rotations=rotations)
        _sync(mesh.device)
        walls.append(time.time() - t0)
        counts = launch_counts()
    dev = mesh.device if mesh.backend == "nccl" else "cpu"
    peaks = mesh.all_gather(torch.tensor([_peak(mesh.device)],
                                         dtype=torch.int64, device=dev))
    return dict(walls=walls, counts=gather_counts(mesh, counts),
                peaks=peaks.tolist(), out=out.cpu().numpy())


def style_rank(mesh, cfg_kw: dict, styles, labels=("cold", "warm")):
    """``style_dp.synthesize_style_batch`` of ``styles`` on the mesh, once
    per label; as :func:`run_rank`."""
    from .. import config
    from ..parallel.style_dp import synthesize_style_batch

    cfg = config.OptexConfig(**cfg_kw)
    walls, out = [], None
    for _ in labels:
        del out
        _reset_peak(mesh.device)
        mesh.barrier()
        reset_counts()
        t0 = time.time()
        out = synthesize_style_batch(cfg, styles, mesh)
        _sync(mesh.device)
        walls.append(time.time() - t0)
        counts = launch_counts()
    dev = mesh.device if mesh.backend == "nccl" else "cpu"
    peaks = mesh.all_gather(torch.tensor([_peak(mesh.device)],
                                         dtype=torch.int64, device=dev))
    return dict(walls=walls, counts=gather_counts(mesh, counts),
                peaks=peaks.tolist(), out=out.cpu().numpy())


def kernel_call(name, x, w, b, kw, dtype, pad, halo=None, device="cpu"):
    """Codec kernel ``name`` on ``x`` (on ``device``; its plain version on
    the CPU), the weights (w OIHW, b) packed in ``dtype`` as its wrapper
    takes them, through ``models.fastcodec.exchanged`` with ``halo`` (the
    space mesh when ``x`` is this rank's rows); float32 out."""
    from ..models import fastcodec
    from ..ops import codec

    w = torch.as_tensor(w).to(device=device, dtype=dtype)
    b = torch.as_tensor(b).to(device=device, dtype=dtype)
    packer = {"upconv_p2": codec.pack_up,
              "final_to_rgb": codec.pack_final}.get(name, codec.pack)
    x = torch.as_tensor(x).to(device)
    if name != "rgb_to_relu1":
        x = x.to(dtype)
    y = fastcodec.exchanged(getattr(codec, name), x, packer(w, b), halo, pad,
                            **kw)
    return y.float()


def exchanged_rank(mesh, cases):
    """:func:`kernel_call` on this rank's rows for each case (name, x, w, b,
    kwargs, dtype, pad), the rows exchanged over the mesh; each output
    gathered along H (numpy), with rank 0's launch counts of the calls."""
    from ..parallel.spatial import own_rows

    space = mesh.with_axis("space")
    reset_counts()
    out = [space.all_gather(kernel_call(
        name, own_rows(torch.as_tensor(x), space), w, b, kw, dtype, pad,
        space, mesh.device), dim=1).cpu().numpy()
        for name, x, w, b, kw, dtype, pad in cases]
    return out, launch_counts()


def jobs(mesh, todo):
    """Several rank bodies of this module in one spawn: [(name, args)]."""
    here = sys.modules[__name__]
    return [getattr(here, name)(mesh, *args) for name, args in todo]


def dryrun_rank(mesh):
    """The dry run's parts on this rank (module docstring); rank 0 prints."""
    from .. import transport
    from ..models.vgg import VGGBank
    from ..parallel.shard_ot import make_sharded_pass
    from ..parallel.style_dp import synthesize_style_batch

    dev, n = mesh.device, mesh.size
    gen = torch.Generator(device="cpu").manual_seed(0)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)

    def rand(*shape):
        return torch.rand(shape, generator=gen).to(dev)

    def relu_feat(c, hw=16):
        return torch.randn((1, hw, hw, c), generator=gen).to(dev) ** 2

    def check(part, out, shape, counts):
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{part}: output {tuple(out.shape)} is not "
                                 f"a finite {shape}")
        say(f"dryrun_multichip({n}, {mesh.backend}, {dev}) {part} OK: "
            f"{tuple(out.shape)}, rank 0's launches "
            f"{ {k: v for k, v in counts.items() if v} }", flush=True)

    def run_pass(part, stage, bank, depths, pastiche, stats, eigvecs=None,
                 k_masks=None):
        reset_counts()
        k = len(depths)
        out = stage([bank.enc_params[d] for d in depths],
                    [bank.dec_params[d] for d in depths], pastiche,
                    tuple(s.mu for s in stats), tuple(s.cov_raw for s in stats),
                    tuple(s.samples for s in stats),
                    eigvecs or (None,) * k, (None,) * k, 7,
                    k_masks or (None,) * k)
        counts = launch_counts()
        out = mesh.all_gather(out)
        check(part, out, (n * pastiche.shape[0], *pastiche.shape[1:]),
              counts)

    depth = 2
    bank = VGGBank(depth, device=dev)
    stats = transport.style_stats(relu_feat(128), need_samples=True)

    def dp_stage(mode="chol", **kw):
        return make_sharded_pass(mesh, depths=kw.pop("depths", (depth,)),
                                 iters=kw.pop("iters", (2,)), mode=mode,
                                 strengths=kw.pop("strengths", (0.0,)),
                                 pca_flags=kw.pop("pca_flags", (False,)),
                                 fast_codec=True, **kw)

    run_pass("DP", dp_stage(), bank, (depth,), rand(1, 64, 64, 3), [stats])
    run_pass("DP+batch_chunk", dp_stage(n_chunks=2), bank, (depth,),
             rand(2, 64, 64, 3), [stats])
    # the JAX package's fast-codec DP case: depth 1, bf16, 128 a rank
    bank1 = VGGBank(1, device=dev, dtype=torch.bfloat16)
    stats1 = transport.style_stats(relu_feat(64), need_samples=False)
    run_pass("DP+bf16 (local batch 128)", dp_stage(depths=(1,)), bank1, (1,),
             rand(128, 32, 32, 3), [stats1])
    run_pass("DP+cdf", dp_stage("cdf"), bank, (depth,), rand(1, 64, 64, 3),
             [stats])
    run_pass("DP+sort", dp_stage("sort"), bank, (depth,), rand(1, 64, 64, 3),
             [stats])
    # a two-stage pass with the stage-0 basis zero-padded past its rank
    sf = relu_feat(128)
    _, v = transport.pca_spectrum(sf)
    kb, true_k = 64, 48
    eig = torch.where(torch.arange(kb, device=dev) < true_k, v[:, :kb], 0.0)
    stats_p = transport.style_stats(sf @ eig, need_samples=False)
    stats_2 = transport.style_stats(relu_feat(64, 32), need_samples=False)
    run_pass("DP fused-pass+pca_bucket",
             dp_stage(depths=(depth, 1), iters=(2, 2), strengths=(0.0, 0.0),
                      pca_flags=(True, False)), bank, (depth, 1),
             rand(1, 64, 64, 3), [stats_p, stats_2], eigvecs=(eig, None),
             k_masks=(torch.tensor(true_k, dtype=torch.int32, device=dev),
                      None))
    # style-parallel: one synthetic style a rank, 64 px, one pass
    from .. import config

    styles = [np.random.default_rng(i).uniform(size=(1, 64, 64, 3))
              .astype(np.float32) for i in range(n)]
    reset_counts()
    out = synthesize_style_batch(config.OptexConfig(
        size=64, passes=1, iters=4, no_multires=True, depth=depth, seed=0,
        pca_bucket=16,
        style=[f"s{i}" for i in range(n)]), styles, mesh)
    check("EP (style-parallel)", out, (n, 64, 64, 3), launch_counts())
    _dryrun_rows(mesh, bank, stats, say, check, rand)
    return "ok"


def _dryrun_rows(mesh, bank, stats, say, check, rand):
    """The spatial and grid parts of the dry run (module docstring)."""
    from ..models import fastcodec
    from ..parallel import mesh as mesh_mod
    from ..parallel.grid import make_grid_pass
    from ..parallel.spatial import make_spatial_pass, own_rows

    n, depth = mesh.size, 2
    space = mesh.with_axis("space")
    enc, dec = [bank.enc_params[depth]], [bank.dec_params[depth]]
    codecs = fastcodec.pack_stages(enc, dec, (depth,))
    args = ((stats.mu,), (stats.cov_raw,), (stats.samples,), (None,),
            (None,), 7, (None,))
    img = mesh.broadcast(rand(1, 64, 64, 3))   # one image, every rank's

    def whole(mode, pad):
        from .. import core

        return core._pass_stages_impl(
            enc, dec, img, [core.LayerTargets(stats, None)], depths=(depth,),
            iters=(2,), mode=mode, strengths=(0.0,), pca_flags=(False,),
            stage_codecs=codecs, run_key=7, pad_mode=pad)

    for part, mode, pad in (("SP", "chol", "reflect"), ("SP+cdf", "cdf",
                                                        "reflect"),
                            ("SP+sort", "sort", "reflect"),
                            ("SP tileable (wrap ring)", "chol", "wrap")):
        stage = make_spatial_pass(space, depths=(depth,), iters=(2,),
                                  mode=mode, strengths=(0.0,),
                                  pca_flags=(False,), pad_mode=pad,
                                  fast_codec=True)
        reset_counts()
        out = stage(enc, dec, own_rows(img, space), *args,
                    stage_codecs=codecs)
        counts = launch_counts()
        out = space.all_gather(out, dim=1)
        check(part, out, (1, 64, 64, 3), counts)
        ref = whole(mode, pad)
        err = float((out - ref).abs().max())
        bound = 1e-2 if mode == "cdf" else 1e-3
        say(f"  {part}: max |{n} ranks - the whole image| {err:.3e} "
            f"(bound {bound:g})", flush=True)
        if not err <= bound:
            raise AssertionError(f"{part}: {n} ranks differ from the whole "
                                 f"image by {err}")
    if n < 4 or n % 2:
        say(f"dryrun_multichip({n}) grid: skipped (needs an even N >= 4)",
            flush=True)
        return
    grid = mesh_mod.make_grid_mesh(n // 2, 2, device=mesh.device)
    imgs = mesh.broadcast(rand(n // 2, 64, 64, 3))
    stage = make_grid_pass(grid, depths=(depth,), iters=(2,), mode="chol",
                           strengths=(0.0,), pca_flags=(False,),
                           fast_codec=True)
    reset_counts()
    d = grid.data.rank
    out = stage(enc, dec, own_rows(imgs[d:d + 1], grid.space), *args,
                stage_codecs=codecs)
    counts = launch_counts()
    out = grid.data.all_gather(grid.space.all_gather(out, dim=1))
    check(f"grid ({n // 2} x 2)", out, (n // 2, 64, 64, 3), counts)


# ---------------------------------------------------------------------------


def _line(name, walls, images, peaks, dev_card):
    return (f"{name}: walls cold {walls[0]:.4f} s, warm {walls[-1]:.4f} s; "
            f"{images / walls[0]:.2f} and {images / walls[-1]:.2f} images/s; "
            f"peak device memory {[round(p / 2 ** 30, 2) for p in peaks]} "
            f"GiB ({dev_card})")


def walls(n: int, card_name: str, parts: str = "all") -> dict:
    """The --walls measurement (module docstring); ``parts``: all, dp (the
    DP and style-parallel runs), spatial or serve."""
    from .. import config, core
    from ..ops import cuda_build
    from ..parallel.mesh import spawn
    from ..parallel.style_dp import synthesize_style_batch
    from ..utils import imageio

    core.full_f32_precision()
    cuda_build.build("codec", "cdf", "conv_wg", "edge_mma")
    styles = [imageio.load_image(os.path.join(SAMPLES, s), 512)
              for s in STYLES_512[:n]]
    f32 = dict(size=512, seed=0, style=["s"])
    bf16 = dict(f32, conv_dtype="bfloat16")
    rec = {"card": card_name, "n": n}

    def one_card(name, fn, images):
        ws = []
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            out = fn()
            torch.cuda.synchronize()
            ws.append(time.time() - t0)
            del out
        peak = torch.cuda.max_memory_allocated()
        print(_line(f"one card, {name}", ws, images, [peak], card_name),
              flush=True)
        rec[f"one_card {name}"] = dict(walls=ws, images=images, peak=peak)
        torch.cuda.empty_cache()

    if parts == "spatial":
        return walls_spatial(n, card_name, rec)
    if parts == "serve":
        return walls_serve(n, card_name, rec)
    one_card("batch 1 f32", lambda: core.synthesize(
        config.OptexConfig(**f32), styles[:1], device="cuda")[0], 1)
    one_card("batch 128 bf16", lambda: core.synthesize(
        config.OptexConfig(**bf16, batch=128), styles[:1], device="cuda")[0],
        128)
    one_card("1 style, style-parallel", lambda: synthesize_style_batch(
        config.OptexConfig(**f32, pca_bucket=32), styles[:1], None), 1)

    got = spawn(jobs, n, backend="nccl", device="cuda", args=([
        ("run_rank", ({**f32, "batch": n, "num_devices": n}, styles[:1])),
        ("run_rank", ({**bf16, "batch": 128 * n, "num_devices": n},
                      styles[:1])),
        ("style_rank", ({**f32, "pca_bucket": 32,
                         "style": [f"s{i}" for i in range(n)]}, styles))],),
        deadline_s=1800)
    for (name, images), r in zip(
            ((f"DP batch {n} f32", n), (f"DP batch {128 * n} bf16", 128 * n),
             (f"{n} styles, style-parallel", n)), got):
        out = r.pop("out")
        if not np.isfinite(out).all():
            raise AssertionError(f"{name}: non-finite output")
        print(_line(f"{n} cards (NCCL), {name}", r["walls"], images,
                    r["peaks"], card_name), flush=True)
        print(f"  per-rank launches: {r['counts']}", flush=True)
        rec[f"{n} cards {name}"] = dict(walls=r["walls"], images=images,
                                        peaks=r["peaks"])
    if parts == "all":
        walls_spatial(n, card_name, rec)
        walls_serve(n, card_name, rec)
    return rec


def walls_spatial(n: int, card_name: str, rec: dict) -> dict:
    """The spatial part of --walls (module docstring): one 2048-px image on
    n cards against one card, and with n = 4 the 2 x 2 grid at 1024 px,
    batch 2, against one card; every run cold and warm."""
    from .. import config, core
    from ..parallel.mesh import spawn
    from ..utils import imageio

    style = os.path.join(SAMPLES, STYLES_512[0])
    cases = [("spatial 2048 px", dict(size=2048, seed=0, style=["s"]),
              dict(spatial_devices=n), imageio.load_image(style, 2048), 1)]
    if n == 4:
        cases.append(("grid 2 x 2, batch 2, 1024 px",
                      dict(size=1024, seed=0, batch=2, style=["s"]),
                      dict(num_devices=2, spatial_devices=2),
                      imageio.load_image(style, 1024), 2))
    for name, kw, layout, sty, images in cases:
        ws, out = [], None
        for _ in range(2):
            del out
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.time()
            out = core.synthesize(config.OptexConfig(**kw), [sty],
                                  device="cuda")[0]
            torch.cuda.synchronize()
            ws.append(time.time() - t0)
        one = out.cpu().numpy()
        del out
        peak = torch.cuda.max_memory_allocated()
        counts = {k: v for k, v in launch_counts().items() if v}
        torch.cuda.empty_cache()
        print(_line(f"one card, {name}", ws, images, [peak], card_name),
              flush=True)
        print(f"  launches: {counts}", flush=True)
        rec[f"one_card {name}"] = dict(walls=ws, images=images, peak=peak,
                                       launches=counts)
        r = spawn(jobs, n, backend="nccl", device="cuda", args=([
            ("run_rank", ({**kw, **layout}, [sty]))],), deadline_s=1800)[0]
        out = r.pop("out")
        err = float(np.abs(out - one).max())
        if out.shape != one.shape or not np.isfinite(out).all():
            raise AssertionError(f"{name}: output {out.shape} is not a "
                                 f"finite {one.shape}")
        print(_line(f"{n} cards (NCCL), {name}", r["walls"], images,
                    r["peaks"], card_name), flush=True)
        print(f"  per-rank launches: "
              f"{[{k: v for k, v in c.items() if v} for c in r['counts']]}; "
              f"max |{n} cards - one card| {err:.3e}", flush=True)
        rec[f"{n} cards {name}"] = dict(walls=r["walls"], images=images,
                                        peaks=r["peaks"], max_abs_diff=err,
                                        launches=r["counts"])
    return rec


def walls_serve(n: int, card_name: str, rec: dict) -> dict:
    """The serve part of --walls (module docstring)."""
    import base64
    import shutil
    import tempfile
    import threading
    import urllib.request

    from .. import api, config, core, serve

    style = os.path.join(SAMPLES, STYLES_512[0])
    with open(style, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    cases = [(f"DP batch {n} f32, 512 px",
              dict(size=512, seed=0, num_devices=n, batch=n), n),
             (f"spatial {n}, one 2048-px image",
              dict(size=2048, seed=0, spatial_devices=n), 1)]
    if n == 4:
        cases.append(("grid 2 x 2, batch 2, 1024 px",
                      dict(size=1024, seed=0, num_devices=2,
                           spatial_devices=2, batch=2), 2))
    srv = serve.serve(port=0, workers=n, coalesce=1)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/v1/synthesize"
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="dryrun_serve_",
                               dir=os.path.join(REPO, "build"))

    def post(cfg, fmt):
        req = urllib.request.Request(url, data=json.dumps({
            "config": cfg, "style_b64": [b64], "format": fmt}).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.time()
        with urllib.request.urlopen(req, timeout=1800) as r:
            body = r.read()
            if r.headers["X-Optex-Worker"] != ",".join(map(str, range(n))):
                raise AssertionError(f"served on workers "
                                     f"{r.headers['X-Optex-Worker']}")
        return body, time.time() - t0

    try:
        for name, cfg, images in cases:
            body, cold = post(cfg, "npy")
            served = np.load(io.BytesIO(body))
            warm = {fmt: [post(cfg, fmt)[1] for _ in range(5)]
                    for fmt in ("npy", "png")}
            t0 = time.time()
            out, _, _ = api.run_files(config.OptexConfig(
                style=[style], output_dir=out_dir, **cfg), device="cuda")
            one_shot = time.time() - t0
            want = core._quant_u8(torch.from_numpy(out)).numpy()
            if served.shape != want.shape:
                raise AssertionError(f"served {name}: {served.shape}, "
                                     f"api.run_files {want.shape}")
            err = int(np.abs(served.astype(np.int16)
                             - want.astype(np.int16)).max())
            print(f"served {name} on {n} cards ({card_name}): cold "
                  f"{cold:.4f} s; warm npy {min(warm['npy']):.4f}-"
                  f"{max(warm['npy']):.4f} s (median "
                  f"{float(np.median(warm['npy'])):.4f}), png "
                  f"{min(warm['png']):.4f}-{max(warm['png']):.4f} s (median "
                  f"{float(np.median(warm['png'])):.4f}); api.run_files "
                  f"(its own ranks) {one_shot:.4f} s; max |served - "
                  f"run_files| {err} uint8 levels", flush=True)
            rec[f"served {name}"] = dict(cold=cold, warm_npy=warm["npy"],
                                         warm_png=warm["png"],
                                         run_files=one_shot, images=images,
                                         max_level_diff=err)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
        shutil.rmtree(out_dir, ignore_errors=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=None,
                    help="ranks (default: 2 on the CPU, every GPU, at most "
                         "4, on cuda)")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    ap.add_argument("--walls", action="store_true",
                    help="time whole runs on the GPUs (see above)")
    ap.add_argument("--parts", default="all",
                    choices=["all", "dp", "spatial", "serve"],
                    help="--walls: the DP and style-parallel runs, the "
                         "spatial and grid runs, the served requests, or "
                         "all")
    args = ap.parse_args(argv)
    from ..parallel.mesh import spawn

    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun_multichip: no CUDA device is available", file=sys.stderr)
        return 2
    n = args.n or (2 if args.device == "cpu"
                   else min(torch.cuda.device_count(), 4))
    name = card(args.device)
    print(f"device: {name} (x{n})", flush=True)
    if args.walls:
        if args.device != "cuda":
            raise SystemExit("--walls times the GPUs: pass --device cuda")
        print(json.dumps(walls(n, name, args.parts)))
        return 0
    if args.device == "cuda":
        from ..ops import cuda_build

        cuda_build.build("codec", "cdf", "conv_wg", "edge_mma")
    t0 = time.time()
    spawn(dryrun_rank, n, backend="gloo" if args.device == "cpu" else "nccl",
          device=args.device, deadline_s=1200)
    print(f"dryrun_multichip({n}) passed in {time.time() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
