#!/usr/bin/env python3
"""Start-up proof of the PyTorch/CUDA port (optimaltextures_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--reps N] [--profile]

Phases (each raises on failure; none catches its own):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ with nvcc (sm_90a), one nvcc per
     source, all started together;
  3. every codec kernel at its 512-px main-path shapes, on inputs made by a
     512-px decode->encode roundtrip of the real depth-3 weights: held
     against its plain PyTorch version (|kernel - plain| <= 2e-5 *
     max|plain|: f32 sums of up to 1152 products in another order), and
     timed beside its plain version and one F.conv2d call (TF32 off);
  4. both cdf kernels at their main-path shapes: the rotated relu1 clouds
     of the 512-px pass at the C the PCA rule picks, and the rotated
     512x512 pixel cloud of the color tail (C = 3). The histogram must
     equal its plain version exactly, the remap be within 1e-5 *
     max|plain|; timed beside the plain versions and, for the histogram,
     torch.histc called once per channel;
  5. the paths, each once cold and once warm (lum once), every launch
     count set to 0 just before a run and checked just after it:
       main path: core.synthesize at 512 px, defaults otherwise (chol), the
         real depth-3 weights, a style exemplar made from --seed;
       path A: the same with hist_mode="cdf";
       path B: style transfer at 512 px, a content exemplar made from
         --seed, content_strength 0.2, chol, color_transfer "opt" (and
         "lum" once, with no cdf launch);
  6. 64-px runs on the GPU against the same runs on the CPU (the kernels'
     plain versions), with the same inputs and injected rotations: the
     main path (max |gpu - cpu| <= 1e-3), cdf synthesis (by distribution:
     cdf mode is chaotic at pass granularity) and transfer + opt (mean
     <= 3e-3, max <= 5e-2);
  7. the CLI on a style file from docs/samples/ (needs Pillow).

The last two lines of standard output are the {"kernels": [...]} line and
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when no
GPU is present or the package is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SAMPLE_STYLE = os.path.join(REPO, "docs", "samples", "graffiti_cholhist_256.png")

# per kernel: its TPU original (file:line of the pallas_call wrapper)
REPLACES = {
    "rgb_to_relu1": "optimaltextures_tpu/ops/pallas/codec.py:578",
    "conv3x3_p2": "optimaltextures_tpu/ops/pallas/codec.py:282",
    "conv3x3_full": "optimaltextures_tpu/ops/pallas/codec.py:376",
    "upconv_p2": "optimaltextures_tpu/ops/pallas/codec.py:449",
    "final_to_rgb": "optimaltextures_tpu/ops/pallas/codec.py:515",
    "batched_histogram": "optimaltextures_tpu/ops/pallas/histogram.py:98",
    "pwl_remap": "optimaltextures_tpu/ops/pallas/pwl_remap.py:74",
}
SOURCES = {"batched_histogram": "cdf", "pwl_remap": "cdf"}   # else codec

# f32 (non-tensor-core) peak and HBM rate by card variant (NVIDIA data sheets)
_PEAKS = [("H100 PCIe", 51.2e12, 2.0e12), ("H100 NVL", 60.0e12, 3.9e12),
          ("H100", 66.9e12, 3.35e12), ("H200", 66.9e12, 4.8e12)]


def _peaks(name: str):
    for key, flops, bw in _PEAKS:
        if key in name:
            return flops, bw
    raise RuntimeError(f"no f32/HBM peak on record for {name!r}")


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _style_exemplar(seed: int, size: int = 512) -> np.ndarray:
    """A (1, size, size, 3) texture in [0, 1] from ``seed``: smooth blobs
    plus fine grain, so every VGG depth sees structure."""
    rng = np.random.default_rng(seed)
    img = np.zeros((size, size, 3), np.float32)
    for cells, amp in ((8, 0.5), (32, 0.3), (128, 0.2)):
        if cells > size:
            continue
        coarse = rng.uniform(-1, 1, (cells, cells, 3)).astype(np.float32)
        img += amp * np.kron(coarse, np.ones((size // cells, size // cells, 1),
                                             np.float32))
    img += 0.1 * rng.standard_normal((size, size, 3)).astype(np.float32)
    return np.clip(0.5 + 0.5 * img, 0.0, 1.0)[None]


def _expected_launches(layer_depths, passes: int) -> dict:
    """Launches of each codec kernel in one run (models/fastcodec.py)."""
    per_pass = {"rgb_to_relu1": 0, "conv3x3_p2": 0, "conv3x3_full": 0,
                "upconv_p2": 0, "final_to_rgb": 0}
    for d in layer_depths:
        per_pass["rgb_to_relu1"] += 1
        per_pass["final_to_rgb"] += 1
        if d >= 2:
            per_pass["conv3x3_p2"] += 2                  # encoder + decoder
            per_pass["conv3x3_full"] += 1 if d == 2 else 2
            per_pass["upconv_p2"] += 1 if d == 2 else 2
    return {k: v * passes for k, v in per_pass.items()}


def check_kernels(seed: int, reps: int, card: str):
    """Phase 3: every kernel at its 512-px main-path shapes vs its plain
    version, with times. Returns the per-kernel summary rows."""
    import torch
    import torch.nn.functional as F

    from optimaltextures_tpu_torch.models import fastcodec
    from optimaltextures_tpu_torch.models.vgg import VGGBank, _run_stack
    from optimaltextures_tpu_torch.models import arch
    from optimaltextures_tpu_torch.ops import codec

    dev = torch.device("cuda")
    peak_flops, peak_bw = _peaks(card)
    bank = VGGBank(3, device=dev)
    enc, dec, enc2 = bank.enc_params[3], bank.dec_params[3], bank.enc_params[2]
    px = torch.as_tensor(_style_exemplar(seed), device=dev)

    # main-path inputs from one plain 512-px roundtrip (relu1/relu2 scales)
    sc = fastcodec.pack_stage(enc, dec, 3, enc2[0])
    enc_k, dec_k = sc.head, sc.tail
    plain = codec.conv3x3_plain
    rgb = fastcodec.pixels_to_rgb(enc[0], px)
    r11 = plain(rgb, enc_k[0], relu=True)
    r11p = plain(r11, enc_k[1], relu=True, pool=True)
    r2a = plain(r11p, enc_k[2], relu=True)
    feat3 = _run_stack(sc.enc_rest, [(128, 256, 3, "", "relu")],
                       plain(r2a, enc_k[3], relu=True, pool=True))
    d128 = _run_stack(sc.dec_rest, arch.decoder_specs(3)[:-4], feat3)
    up128 = plain(d128, dec_k[0], relu=True, up=True)
    d64 = plain(up128, dec_k[1], relu=True)
    up64 = plain(d64, dec_k[2], relu=True, up=True)

    def conv_call(x, p, up=False):
        t = x.permute(0, 3, 1, 2)
        if up:
            t = F.interpolate(t, scale_factor=2, mode="nearest")
        t = F.pad(t, (1, 1, 1, 1), mode="reflect").contiguous(
            memory_format=torch.channels_last)
        return lambda: F.conv2d(t, p.w, p.b)

    # (kernel, label, wrapper, x, packed weights, wrapper kwargs, plain kwargs)
    relu, pool, up = dict(relu=True), dict(relu=True, pool=True), dict(relu=True, up=True)
    cases = [
        ("rgb_to_relu1", "3->64 relu, 512^2", codec.rgb_to_relu1, rgb,
         enc_k[0], {}, relu),
        ("conv3x3_p2", "enc 64->64 relu+pool, 512^2", codec.conv3x3_p2, r11,
         enc_k[1], pool, pool),
        ("conv3x3_p2", "dec 128->64 relu, 256^2", codec.conv3x3_p2, up128,
         dec_k[1], relu, relu),
        ("conv3x3_full", "enc 64->128 relu, 256^2", codec.conv3x3_full, r11p,
         enc_k[2], relu, relu),
        ("conv3x3_full", "enc 128->128 relu+pool, 256^2", codec.conv3x3_full,
         r2a, enc_k[3], pool, pool),
        ("upconv_p2", "dec up 128->128 relu, 128^2->256^2", codec.upconv_p2,
         d128, dec_k[0], {}, up),
        ("upconv_p2", "dec up 64->64 relu, 256^2->512^2", codec.upconv_p2,
         d64, dec_k[2], {}, up),
        ("final_to_rgb", "dec 64->3 + renorm, 512^2", codec.final_to_rgb,
         up64, sc.final, {}, {}),
    ]
    rows = {}
    for name, label, kern, x, p, kw, plain_kw in cases:
        got = kern(x, p, **kw)
        ref = plain(x, p, **plain_kw)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if not (torch.isfinite(got).all() and err <= 2e-5 * max(scale, 1.0)):
            raise AssertionError(f"{name} [{label}]: max|kernel - plain| = "
                                 f"{err:.3e} over max|plain| = {scale:.3e}")
        cout, cin = p.w.shape[:2]
        if name == "upconv_p2":
            # nearest-x2 then a 3x3 conv folds into 2x2 taps per output phase
            # (as the TPU kernel computes it): 4 taps per fine pixel, not 9
            taps, hc, wc = 4, 2 * x.shape[1], 2 * x.shape[2]
        else:
            taps, hc, wc = 9, x.shape[1], x.shape[2]
        flops = 2.0 * x.shape[0] * hc * wc * cout * cin * taps
        nbytes = 4.0 * (x.numel() + p.w.numel() + p.b.numel() + got.numel())
        t_flops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        ms = _time_ms(lambda: kern(x, p, **kw), reps)
        plain_ms = _time_ms(lambda: plain(x, p, **plain_kw), reps)
        lib_ms = _time_ms(conv_call(x, p, name == "upconv_p2"), reps)
        print(f"kernel {name:13s} {label:36s} err {err:.2e} (max|plain| "
              f"{scale:.3e})  {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"F.conv2d {lib_ms:.4f} ms  bound {max(t_flops, t_bytes):.4f} ms "
              f"({'operations' if t_flops >= t_bytes else 'bytes'})", flush=True)
        _add_row(rows, name, err, ms, plain_ms, lib_ms, t_flops, t_bytes)
    return rows


def _add_row(rows, name, err, ms, plain_ms, lib_ms, t_flops, t_bytes):
    """Sum a kernel's per-shape numbers into its summary row (``lib_ms``
    None: no single library call computes the function)."""
    r = rows.setdefault(name, dict(err=0.0, ms=0.0, plain_ms=0.0,
                                   lib_ms=None if lib_ms is None else 0.0,
                                   bound=0.0, t_flops=0.0, t_bytes=0.0))
    r["err"] = max(r["err"], err)
    for k, v in (("ms", ms), ("plain_ms", plain_ms), ("lib_ms", lib_ms),
                 ("bound", max(t_flops, t_bytes)), ("t_flops", t_flops),
                 ("t_bytes", t_bytes)):
        if v is not None:
            r[k] += v


def cdf_clouds(seed: int):
    """The cdf kernels' main-path inputs: the 512-px pass's relu1 clouds
    (pastiche features of a noise image and the style's samples, both
    projected on the style's first k PCs and rotated, as the cdf stage
    hands them over) and the color tail's rotated pixel clouds (a noise
    pastiche and the lum target built from a content exemplar). Returns
    [(label, target rows, source rows)] and k."""
    import torch

    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.config import OptexConfig
    from optimaltextures_tpu_torch.models.vgg import encode
    from optimaltextures_tpu_torch.ops import colors
    from optimaltextures_tpu_torch.ops.rotation import (generator,
                                                        random_rotation,
                                                        stage_rotations)

    dev = torch.device("cuda")
    synth = core.Synthesizer(OptexConfig(size=512, seed=seed, hist_mode="cdf",
                                         style=["smoke_style"]), device=dev)
    style = torch.as_tensor(_style_exemplar(seed + 1), device=dev)
    spectra = synth._dispatch_style_prep([style], 512, True)
    ks = synth._choose_widths(spectra, [sv.cpu().numpy() for (_, sv, _) in spectra])
    eigvecs, stats, _ = synth._finish_style_prep(spectra, ks)[-1]   # relu1
    k = int(ks[-1])
    gen = generator(dev, seed, 77)
    noise = torch.rand((1, 512, 512, 3), generator=gen, device=dev)
    feat = encode(synth.bank.enc_params[1], 1, noise) @ eigvecs
    rot = stage_rotations(gen, 1, k, dev)[0]
    clouds = [(f"relu1 C={k}, N=512^2", rot.T @ feat.reshape(-1, k).T,
               rot.T @ stats.samples.T)]
    content = torch.as_tensor(_style_exemplar(seed + 3), device=dev)
    target = colors.swap_lightness(content, noise)
    rot3 = random_rotation(gen, 3, dev)
    clouds.append(("pixels C=3, N=512^2", rot3.T @ noise.reshape(-1, 3).T,
                   rot3.T @ target.reshape(-1, 3).T))
    return clouds, k


def check_cdf_kernels(seed: int, reps: int, card: str):
    """Phase 4: both cdf kernels at their main-path shapes vs their plain
    versions, with times and bounds. Returns (rows, relu1 k)."""
    import torch

    from optimaltextures_tpu_torch.ops import cdf, histmatch

    peak_flops, peak_bw = _peaks(card)
    clouds, k = cdf_clouds(seed)
    rows = {}
    for label, t, s in clouds:
        c, n = t.shape
        lo = torch.minimum(t.min(dim=1).values, s.min(dim=1).values)
        hi = torch.maximum(t.max(dim=1).values, s.max(dim=1).values)
        lo_f, hi_f = lo.tolist(), hi.tolist()

        # batched_histogram: one launch per cloud side, as the cdf step does
        for side, x in (("pastiche", t), ("style", s)):
            got = cdf.batched_histogram(x, lo, hi)
            ref = cdf.histogram_plain(x, lo, hi)
            histc = torch.stack([torch.histc(x[i], 256, lo_f[i], hi_f[i])
                                 for i in range(c)])
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"batched_histogram [{label}, {side}] "
                                     "differs from its plain version")
            degenerate = [i for i in range(c) if hi_f[i] <= lo_f[i]]
            keep = [i for i in range(c) if i not in degenerate]
            if not torch.equal(got[keep], histc[keep]):
                raise AssertionError(f"batched_histogram [{label}, {side}] "
                                     "differs from torch.histc")
            ms = _time_ms(lambda: cdf.batched_histogram(x, lo, hi), reps)
            plain_ms = _time_ms(lambda: cdf.histogram_plain(x, lo, hi), reps)
            lib_ms = _time_ms(lambda: [torch.histc(x[i], 256, lo_f[i], hi_f[i])
                                       for i in range(c)], reps)
            # bytes: the samples, lo/hi once, the (C, 256) counts once;
            # operations: subtract, multiply, divide per sample (f32)
            t_bytes = 4.0 * (c * n + 2 * c + c * 256) / peak_bw * 1e3
            t_flops = 3.0 * c * n / peak_flops * 1e3
            print(f"kernel batched_histogram {label:22s} {side:8s} exact  "
                  f"{ms:.4f} ms  plain {plain_ms:.4f} ms  torch.histc x{c} "
                  f"{lib_ms:.4f} ms  bound {max(t_flops, t_bytes):.4f} ms "
                  f"({'operations' if t_flops >= t_bytes else 'bytes'})",
                  flush=True)
            _add_row(rows, "batched_histogram", 0.0, ms, plain_ms, lib_ms,
                     t_flops, t_bytes)

        # pwl_remap on the remap tables of this cloud's histograms
        t_cdf, s_cdf = histmatch.cdf_cdfs_rows(cdf.histogram_plain(t, lo, hi),
                                               cdf.histogram_plain(s, lo, hi))
        remapped = histmatch._remap_table_rows(
            t_cdf, s_cdf, histmatch._edges_rows(lo, hi, 256))
        got = cdf.pwl_remap(t, remapped, lo, hi)
        ref = cdf.pwl_remap_plain(t, remapped, lo, hi)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if not (torch.isfinite(got).all() and err <= 1e-5 * scale):
            raise AssertionError(f"pwl_remap [{label}]: max|kernel - plain| = "
                                 f"{err:.3e} over max|plain| = {scale:.3e}")
        ms = _time_ms(lambda: cdf.pwl_remap(t, remapped, lo, hi), reps)
        plain_ms = _time_ms(lambda: cdf.pwl_remap_plain(t, remapped, lo, hi),
                            reps)
        # bytes: samples in and out, the tables and the ranges once;
        # operations: ~12 f32 operations per sample (index, segment, lerp)
        t_bytes = 4.0 * (2 * c * n + c * 256 + 2 * c) / peak_bw * 1e3
        t_flops = 12.0 * c * n / peak_flops * 1e3
        print(f"kernel pwl_remap {label:22s} err {err:.2e} (max|plain| "
              f"{scale:.3e})  {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
              f"call: none  bound {max(t_flops, t_bytes):.4f} ms "
              f"({'operations' if t_flops >= t_bytes else 'bytes'})", flush=True)
        _add_row(rows, "pwl_remap", err, ms, plain_ms, None, t_flops, t_bytes)
    print(f"relu1 C at the 512-px pass (PCA 90% rule): {k}", flush=True)
    return rows, k


def _counts():
    from optimaltextures_tpu_torch.ops import cdf, codec

    return {**codec.LAUNCHES, **cdf.LAUNCHES}


def _reset_counts():
    from optimaltextures_tpu_torch.ops import cdf, codec

    codec.reset_launches()
    cdf.reset_launches()


def expected_counts(cfg) -> dict:
    """Every kernel's launches in one run of ``cfg``: the codec's per stage
    roundtrip, two histograms and one remap per cdf step (each sliced-OT
    iteration of hist_mode "cdf", and each step of the opt color tail)."""
    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.utils import schedule

    depths = [3 - l for l in range(3)]
    table, _ = schedule.iters_and_sizes(cfg.size, cfg.iters, cfg.passes,
                                        not cfg.no_multires, num_layers=3)
    steps = sum(map(sum, table)) if cfg.hist_mode == "cdf" else 0
    if cfg.color_transfer == "opt":
        steps += core.COLOR_STEPS
    return {**_expected_launches(depths, cfg.passes),
            "batched_histogram": 2 * steps, "pwl_remap": steps}


def drive_path(name: str, cfg, style, content=None, labels=("cold", "warm")):
    """Run ``cfg`` through core.synthesize once per label, each run's launch
    counts set to 0 just before it and checked just after. Returns the
    last run's counts and the walls."""
    import torch

    from optimaltextures_tpu_torch import core

    expected = expected_counts(cfg)
    launches, walls = None, []
    shape = (1, 512, 512, 3)
    for label in labels:
        _reset_counts()
        out, seconds = core.synthesize(cfg, [style], content, device="cuda")
        launches = _counts()
        o = out.cpu().numpy()
        walls.append(seconds)
        print(f"{name} ({label}): {seconds:.4f} s, output {o.shape}, range "
              f"[{o.min():.4f}, {o.max():.4f}], launches {launches}",
              flush=True)
        if o.shape != shape or not np.isfinite(o).all():
            raise AssertionError(f"{name}: output {o.shape} is not finite {shape}")
        if o.min() < -1.5 or o.max() > 2.5 or o.std() < 1e-3:
            raise AssertionError(f"{name}: output out of a sane range")
        if launches != expected:
            raise AssertionError(f"{name}: launch counts {launches} != "
                                 f"expected {expected}")
        torch.cuda.synchronize()
    return launches, walls


def paths(seed: int, profile: bool):
    """Phase 5: the main path, path A (cdf) and path B (transfer + opt,
    then lum). Returns the launch counts of the main path and of path A."""
    from optimaltextures_tpu_torch.config import OptexConfig

    style = _style_exemplar(seed + 1)
    content = _style_exemplar(seed + 3)
    main_cfg = OptexConfig(size=512, seed=seed, style=["smoke_style"])
    cdf_cfg = OptexConfig(size=512, seed=seed, hist_mode="cdf",
                          style=["smoke_style"])
    opt_cfg = OptexConfig(size=512, seed=seed, content="smoke_content",
                          content_strength=0.2, color_transfer="opt",
                          style=["smoke_style"])
    lum_cfg = OptexConfig(size=512, seed=seed, content="smoke_content",
                          content_strength=0.2, color_transfer="lum",
                          style=["smoke_style"])
    main_counts, _ = drive_path("main path", main_cfg, style)
    cdf_counts, _ = drive_path("path A, cdf synthesis", cdf_cfg, style)
    drive_path("path B, transfer + opt", opt_cfg, style, content)
    drive_path("path B, transfer + lum", lum_cfg, style, content, ("warm",))
    if profile:
        for name, cfg, cont in (("main", main_cfg, None), ("cdf", cdf_cfg, None),
                                ("transfer_opt", opt_cfg, content)):
            profile_run(name, cfg, style, cont)
    return main_counts, cdf_counts


def profile_run(name, cfg, style, content=None):
    """One more warm run under torch.profiler: device busy time against the
    wall, the ported kernels' share, and the top device kernels (the whole
    table goes to chiprun_out/profile_<name>.txt)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from optimaltextures_tpu_torch import core

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        _, wall = core.synthesize(cfg, [style], content, device="cuda")
    rows = p.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    # device-side rows only: an aten op's own row repeats its kernels' time
    kernels = [e for e in rows if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    part = lambda key: sum(dev_us(e) for e in kernels if key in e.key) / 1e3
    print(f"profile {name} (warm run, profiler on): wall {wall * 1e3:.1f} ms, "
          f"device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% of the "
          f"wall), codec kernels {part('conv3x3_reflect'):.1f} ms, histogram "
          f"kernel {part('histogram_kernel'):.1f} ms, pwl kernel "
          f"{part('pwl_kernel'):.1f} ms", flush=True)
    for e in sorted(kernels, key=dev_us, reverse=True)[:15]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"profile_{name}.txt"), "w") as f:
        f.write(rows.table(sort_by="cuda_time_total", row_limit=80))
    torch.cuda.synchronize()


def _gpu_vs_cpu(cfg, seed: int, content_shape=None):
    """``cfg`` at 64 px on the GPU (kernels) and on the CPU (plain
    versions): same noise, style, content and injected rotations."""
    import torch

    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.ops.rotation import polar_rotations

    rng = np.random.default_rng(seed)
    shape = content_shape or (1, cfg.size, cfg.size, 3)
    noise = rng.uniform(size=shape).astype(np.float32)
    style = _style_exemplar(seed + 2, 64)
    content = (np.ascontiguousarray(_style_exemplar(seed + 4, 96)[:, :shape[1],
                                                                  :shape[2]])
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
    for dev in ("cpu", "cuda"):
        _reset_counts()
        outs[dev] = core.Synthesizer(cfg, device=dev).run(
            noise, [style], content, rotations=rotations,
            color_rotations=color).cpu().numpy()
        launches = _counts()
        if dev == "cpu" and any(launches.values()):
            raise AssertionError(f"the CPU run counted launches: {launches}")
    expected = {k: v for k, v in expected_counts(cfg).items() if v}
    if any(launches[k] == 0 for k in expected):
        raise AssertionError(f"the 64-px GPU run skipped a kernel: {launches}")
    return outs["cuda"], outs["cpu"]


def small_agreement(seed: int):
    """Phase 6: the port at 64 px on the GPU (kernels) vs the CPU (plain
    versions), same inputs and injected rotations, no PCA."""
    from optimaltextures_tpu_torch.config import OptexConfig

    gpu, cpu = _gpu_vs_cpu(OptexConfig(
        size=64, passes=2, iters=48, no_pca=True, no_multires=True, seed=seed,
        style=["smoke_style"]), seed)
    err = float(np.abs(gpu - cpu).max())
    print(f"64-px main path, GPU (kernels) vs CPU (plain): max abs diff "
          f"{err:.3e}", flush=True)
    if not err <= 1e-3:
        raise AssertionError(f"64-px GPU vs CPU diff {err} > 1e-3")

    # cdf: a sample a rounding apart lands in the next bin and the runs
    # then diverge pixel by pixel, so hold the output's distribution
    gpu, cpu = _gpu_vs_cpu(OptexConfig(
        size=64, passes=1, iters=60, no_pca=True, no_multires=True, seed=seed,
        hist_mode="cdf", style=["smoke_style"]), seed)
    g, c = gpu.reshape(-1, 3), cpu.reshape(-1, 3)
    stats = (float(np.abs(g.mean(0) - c.mean(0)).max()),
             float(np.abs(g.std(0) - c.std(0)).max()),
             float(np.abs(np.sort(g, 0) - np.sort(c, 0)).mean()))
    print(f"64-px cdf synthesis, GPU vs CPU: max abs diff "
          f"{float(np.abs(gpu - cpu).max()):.3e}, per-channel mean diff "
          f"{stats[0]:.3e}, std diff {stats[1]:.3e}, sorted-pixel mean diff "
          f"{stats[2]:.3e}", flush=True)
    if not (np.isfinite(gpu).all() and stats[0] <= 3e-3 and stats[1] <= 1e-2
            and stats[2] <= 1e-2):
        raise AssertionError(f"64-px cdf GPU vs CPU distribution {stats}")

    gpu, cpu = _gpu_vs_cpu(OptexConfig(
        size=96, passes=2, iters=60, no_pca=True, seed=seed,
        content="smoke_content", content_strength=0.2, color_transfer="opt",
        style=["smoke_style"]), seed, (1, 64, 96, 3))
    diff = np.abs(gpu - cpu)
    print(f"64x96 transfer + opt, GPU vs CPU: max abs diff "
          f"{float(diff.max()):.3e}, mean {float(diff.mean()):.3e}", flush=True)
    if not (float(diff.mean()) <= 3e-3 and float(diff.max()) <= 5e-2):
        raise AssertionError("64x96 transfer + opt GPU vs CPU: max "
                             f"{float(diff.max())}, mean {float(diff.mean())}")


def cli_phase(seed: int):
    """Phase 6: the CLI end to end on a style file; a PNG must appear."""
    from optimaltextures_tpu_torch import cli

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_cli_",
                               dir=os.path.join(REPO, "build"))
    rc = cli.main(["--style", SAMPLE_STYLE, "--size", "512", "--seed", str(seed),
                   "--output_dir", out_dir, "--quiet"])
    pngs = [f for f in os.listdir(out_dir) if f.endswith(".png")]
    if rc != 0 or not pngs:
        raise AssertionError(f"cli returned {rc}, wrote {pngs}")
    print(f"cli: wrote {os.path.join(out_dir, pngs[0])}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler table of one warm run "
                         "of each path")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 2
    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.ops import cuda_build

    core.full_f32_precision()   # TF32 off: plain versions and F.conv2d in f32
    card = _smi()
    print(f"device: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.time()
    libs = cuda_build.build("codec", "cdf")
    print(f"built csrc/codec.cu and csrc/cdf.cu in {time.time() - t0:.1f} s "
          "(sm_90a, in parallel)", flush=True)
    for lib in libs:
        with open(lib + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line or "Compiling" in line:
                    print("  ptxas:", line.strip())

    rows = check_kernels(args.seed, args.reps, card)
    cdf_rows, _ = check_cdf_kernels(args.seed, args.reps, card)
    rows.update(cdf_rows)
    main_counts, cdf_counts = paths(args.seed, args.profile)
    small_agreement(args.seed)
    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    if have_pil:
        cli_phase(args.seed)
    else:
        print("cli phase not run: Pillow is not installed", flush=True)

    kernels = []
    for name, r in rows.items():
        launches = (cdf_counts if name in SOURCES else main_counts)[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"optimaltextures_tpu_torch/csrc/"
                      f"{SOURCES.get(name, 'codec')}.cu",
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"],
            "bound_by": "operations" if r["t_flops"] >= r["t_bytes"] else "bytes",
            "library_ms": r["lib_ms"]})
    print(f"device: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
