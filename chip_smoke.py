#!/usr/bin/env python3
"""Start-up proof of the PyTorch/CUDA port (optimaltextures_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--reps N] [--profile]

Phases (each raises on failure; none catches its own):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ with nvcc (sm_90a);
  3. every codec kernel at its 512-px main-path shapes, on inputs made by a
     512-px decode->encode roundtrip of the real depth-3 weights: held
     against its plain PyTorch version (|kernel - plain| <= 2e-5 *
     max|plain|: f32 sums of up to 1152 products in another order), and
     timed beside its plain version and one F.conv2d call (TF32 off);
  4. the main path — core.synthesize at 512 px, defaults otherwise, the real
     depth-3 weights, a style exemplar made from --seed with numpy — once
     cold and once warm, each with every kernel's launch count checked;
  5. a 64-px run on the GPU against the same run on the CPU (the kernels'
     plain versions), with the same noise and injected rotations
     (max |gpu - cpu| <= 1e-3);
  6. the CLI on a style file from docs/samples/ (needs Pillow).

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
}

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
        r = rows.setdefault(name, dict(err=0.0, ms=0.0, plain_ms=0.0, lib_ms=0.0,
                                       bound=0.0, t_flops=0.0, t_bytes=0.0))
        r["err"] = max(r["err"], err)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("lib_ms", lib_ms),
                     ("bound", max(t_flops, t_bytes)), ("t_flops", t_flops),
                     ("t_bytes", t_bytes)):
            r[k] += v
    return rows


def main_path(seed: int, profile: bool):
    """Phase 4: core.synthesize at 512 px, cold then warm, launch counts
    checked on each run."""
    import torch

    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.config import OptexConfig
    from optimaltextures_tpu_torch.ops import codec

    cfg = OptexConfig(size=512, seed=seed, style=["smoke_style"])
    style = _style_exemplar(seed + 1)
    synth = core.Synthesizer(cfg, device="cuda")
    expected = _expected_launches(synth.layer_depths, cfg.passes)
    launches = None
    for label in ("cold", "warm"):
        codec.reset_launches()
        out, seconds = core.synthesize(cfg, [style], device="cuda")
        launches = dict(codec.LAUNCHES)
        o = out.cpu().numpy()
        print(f"main path ({label}): {seconds:.4f} s, output {o.shape}, "
              f"range [{o.min():.4f}, {o.max():.4f}], launches {launches}",
              flush=True)
        if o.shape != (1, 512, 512, 3) or not np.isfinite(o).all():
            raise AssertionError(f"main path output {o.shape} is not finite "
                                 "(1, 512, 512, 3)")
        if o.min() < -1.5 or o.max() > 2.5 or o.std() < 1e-3:
            raise AssertionError("main path output out of a sane range")
        if launches != expected:
            raise AssertionError(f"launch counts {launches} != expected {expected}")
    if profile:
        profile_run(cfg, style)
    return launches


def profile_run(cfg, style):
    """One more warm main-path run under torch.profiler: device busy time
    against the wall, the codec kernels' share, and the top device kernels
    (the whole table goes to chiprun_out/profile.txt)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from optimaltextures_tpu_torch import core

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        _, wall = core.synthesize(cfg, [style], device="cuda")
    rows = p.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    # device-side rows only: an aten op's own row repeats its kernels' time
    kernels = [e for e in rows if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    codec_ms = sum(dev_us(e) for e in kernels if "conv3x3_reflect" in e.key) / 1e3
    print(f"profile (warm run, profiler on): wall {wall * 1e3:.1f} ms, device "
          f"busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% of the wall), "
          f"codec kernels {codec_ms:.1f} ms", flush=True)
    for e in sorted(kernels, key=dev_us, reverse=True)[:15]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "profile.txt"), "w") as f:
        f.write(rows.table(sort_by="cuda_time_total", row_limit=80))
    torch.cuda.synchronize()


def small_agreement(seed: int):
    """Phase 5: the port at 64 px on the GPU (kernels) vs the CPU (plain
    versions), same noise and injected rotations, no PCA."""
    import torch

    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.config import OptexConfig
    from optimaltextures_tpu_torch.ops import codec
    from optimaltextures_tpu_torch.ops.rotation import polar_rotations

    cfg = OptexConfig(size=64, passes=2, iters=48, no_pca=True,
                      no_multires=True, seed=seed, style=["smoke_style"])
    rng = np.random.default_rng(seed)
    noise = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    style = _style_exemplar(seed + 2, 64)
    rots = {}

    def rotations(p, i, n_iters, c):
        if (p, i) not in rots:
            g = torch.as_tensor(rng.standard_normal((n_iters, c, c)))
            rots[(p, i)] = polar_rotations(g).float().numpy()
        return rots[(p, i)]

    outs = {}
    for dev in ("cpu", "cuda"):
        codec.reset_launches()
        outs[dev] = core.Synthesizer(cfg, device=dev).run(
            noise, [style], rotations=rotations).cpu().numpy()
        if dev == "cuda" and min(codec.LAUNCHES.values()) == 0:
            raise AssertionError(f"64-px GPU run skipped a kernel: {codec.LAUNCHES}")
    err = float(np.abs(outs["cuda"] - outs["cpu"]).max())
    print(f"64-px GPU (kernels) vs CPU (plain): max abs diff {err:.3e}", flush=True)
    if not err <= 1e-3:
        raise AssertionError(f"64-px GPU vs CPU diff {err} > 1e-3")


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
                    help="also print a torch.profiler table of one warm run")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 2
    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.ops import codec, cuda_build

    core.full_f32_precision()   # TF32 off: plain versions and F.conv2d in f32
    card = _smi()
    print(f"device: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.time()
    codec.build()
    log = cuda_build.library_path("codec") + ".log"
    print(f"built csrc/codec.cu in {time.time() - t0:.1f} s (sm_90a)", flush=True)
    with open(log) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    rows = check_kernels(args.seed, args.reps, card)
    launches = main_path(args.seed, args.profile)
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
        kernels.append({
            "name": name, "route": "cuda",
            "source": "optimaltextures_tpu_torch/csrc/codec.cu",
            "replaces": REPLACES[name], "launches": launches[name],
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
