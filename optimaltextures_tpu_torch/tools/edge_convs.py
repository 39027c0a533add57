"""The codec's two bytes-bound kernels, ``final_to_rgb`` (64 -> 3) and
``rgb_to_relu1`` (3 -> 64), on the GPU: each against its plain version at
both ends of the main path's pass sizes (512^2 and 256^2), with three
times side by side.

    python3 optimaltextures_tpu_torch/tools/edge_convs.py [--root TREE]
        [--seed N] [--reps R] [--pad reflect|wrap]

The inputs are made as ``chip_smoke.py`` phase 3 makes them: a plain
decode -> encode roundtrip of the real depth-3 weights on a style exemplar
made from ``--seed``, at each size. ``--root`` imports the port's package
from another checkout of the repo (an older tree unpacked with ``git
archive``), so two versions are timed by the same script, in one call.
``--pad wrap`` times the kernels' wrap mode (circular padding, tileable
runs) against the plain versions in wrap mode, with the reflect mode's
device time on the same inputs beside it.

For each kernel and size it prints:

* ``device``: the kernel's own time, from the device's record: the device
  time of every kernel ``torch.profiler`` saw over R back-to-back wrapper
  calls, over R;
* ``events``: CUDA events around the same loop of R wrapper calls, over R
  (what ``chip_smoke.py`` reports for every kernel; for a kernel of tens of
  microseconds the host can set it);
* ``host``: the wrapper's host time per call (checks, ``torch.empty``, the
  ctypes call), the loop's host clock over R before the closing
  synchronize;
* both bounds: the bytes (each input read once, each output written once)
  over the card's memory rate, and the FMAs over its FP32 rate.

The 256^2 final input (16.8 MB) fits in the 50 MB L2, and the repeated
calls keep it there, as on the path, where ``upconv_p2`` has just written
it: its time is L2-warm. At 512^2 (67 MB) it is not.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

# f32 (non-tensor-core) peak, dense bf16 tensor-core peak and HBM rate by
# card variant (NVIDIA data sheets); dense TF32 on the tensor cores is half
# the bf16 rate
_PEAKS = [("H100 PCIe", 51.2e12, 756e12, 2.0e12),
          ("H100 NVL", 60.0e12, 835e12, 3.9e12),
          ("H100", 66.9e12, 989e12, 3.35e12),
          ("H200", 66.9e12, 989e12, 4.8e12)]


def peaks(card: str, kind: str = "f32"):
    """(peak FLOP/s, HBM bytes/s) of the card named ``card``: "f32" on the
    FP32 cores, "bf16" or "tf32" dense on the tensor cores."""
    for key, f32, tc_bf16, bw in _PEAKS:
        if key in card:
            return {"f32": f32, "bf16": tc_bf16, "tf32": tc_bf16 / 2}[kind], bw
    raise RuntimeError(f"no peak on record for {card!r}")


def style_exemplar(seed: int, size: int = 512) -> np.ndarray:
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


def roundtrip(bank, px):
    """One plain depth-3 decode -> encode roundtrip of pixels ``px`` (1, S,
    S, 3) on the bank's weights: every codec kernel's main-path input at
    this size, and the packed stage, each contiguous. Returns a dict:
    ``rgb`` (S^2 x 3),
    ``r11`` (S^2 x 64), ``r11p`` and ``r2a`` (S/2), ``d128`` (S/4 x 128),
    ``up128`` (S/2 x 128), ``d64`` (S/2 x 64), ``up64`` (S^2 x 64), and
    ``stage``."""
    from optimaltextures_tpu_torch.models import arch, fastcodec
    from optimaltextures_tpu_torch.models.vgg import _run_stack
    from optimaltextures_tpu_torch.ops import codec

    enc, dec, enc2 = bank.enc_params[3], bank.dec_params[3], bank.enc_params[2]
    sc = fastcodec.pack_stage(enc, dec, 3, enc2[0])
    plain = codec.conv3x3_plain
    t = {"stage": sc, "rgb": fastcodec.pixels_to_rgb(enc[0], px)}
    t["r11"] = plain(t["rgb"], sc.head[0], relu=True)
    t["r11p"] = plain(t["r11"], sc.head[1], relu=True, pool=True)
    t["r2a"] = plain(t["r11p"], sc.head[2], relu=True)
    feat3 = _run_stack(sc.enc_rest, [(128, 256, 3, "", "relu")],
                       plain(t["r2a"], sc.head[3], relu=True, pool=True))
    t["d128"] = _run_stack(sc.dec_rest, arch.decoder_specs(3)[:-4], feat3)
    t["up128"] = plain(t["d128"], sc.tail[0], relu=True, up=True)
    t["d64"] = plain(t["up128"], sc.tail[1], relu=True)
    t["up64"] = plain(t["d64"], sc.tail[2], relu=True, up=True)
    # the plain convs return NHWC views of NCHW results; the kernels' inputs
    # on the path are contiguous (a kernel's output), and a view would make
    # every timed wrapper call copy it first
    return {k: v.contiguous() if k != "stage" else v for k, v in t.items()}


def event_ms(fn, reps: int) -> float:
    """CUDA events around ``reps`` calls of ``fn`` after 3 warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_kernels(fn, reps: int, tries: int = 3):
    """[(kernel name, device us, launches)] of every kernel torch.profiler
    records over ``reps`` calls of ``fn`` (after one warm-up call), or None
    if no attempt of ``tries`` recorded any device time: now and then a
    profiler session on the H100 delivers no device events at all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0)),
                 e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum(us for _, us, _ in rows) > 0.0:
            return rows
    print(f"torch.profiler recorded no device time in {tries} sessions: "
          "timed with CUDA events instead", file=sys.stderr, flush=True)
    return None


def device_ms(fn, reps: int) -> float:
    """The device time of a kernel launch: the time of every kernel
    torch.profiler records over ``reps`` calls of ``fn`` (which launches one
    kernel and no other), over the launches it recorded (a session now and
    then records only some of them); the CUDA events' time if the profiler
    records none."""
    rows = profiled_kernels(fn, reps)
    if rows is None:
        return event_ms(fn, reps)
    return sum(us for _, us, _ in rows) / 1e3 / sum(n for _, _, n in rows)


def host_us(fn, reps: int) -> float:
    """The host's time per call of ``fn`` (launch and wrapper), the loop's
    host clock over ``reps`` before the closing synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / reps * 1e6


def bounds(x, p, y, card: str):
    """(FMA bound ms, bytes bound ms) of one conv3x3 call: 2 x 9 x Cin x
    Cout FLOPs per pixel over the FP32 rate; x, the weights, the bias and y
    each moved once over the memory rate."""
    peak_flops, peak_bw = peaks(card)
    cout, cin = p.w.shape[:2]
    flops = 2.0 * x.shape[0] * x.shape[1] * x.shape[2] * 9 * cin * cout
    nbytes = 4.0 * (x.numel() + p.w.numel() + p.b.numel() + y.numel())
    return flops / peak_flops * 1e3, nbytes / peak_bw * 1e3


def cases(seed: int, sizes=(512, 256)):
    """[(kernel, size, x, packed weights, plain kwargs)] for both kernels at
    each size, inputs from the roundtrip at that size."""
    import torch

    from optimaltextures_tpu_torch.models.vgg import VGGBank

    dev = torch.device("cuda")
    bank = VGGBank(3, device=dev)
    out = []
    for size in sizes:
        t = roundtrip(bank, torch.as_tensor(style_exemplar(seed, size), device=dev))
        out.append(("final_to_rgb", size, t["up64"], t["stage"].final, {}))
        out.append(("rgb_to_relu1", size, t["rgb"], t["stage"].head[0],
                    dict(relu=True)))
    return out


def time_edge_convs(seed: int, reps: int, card: str, sizes=(512, 256),
                    pad: str = "reflect"):
    """Check both kernels in pad mode ``pad`` against their plain versions
    in that mode at each size, within 2e-5 x max|plain|, and time them three
    ways. Returns {(kernel, size): dict(err, device_ms, ms, host_us,
    plain_ms, t_flops, t_bytes)}, a wrap row with ``reflect_device_ms``
    (the reflect mode on the same inputs) too."""
    import torch

    from optimaltextures_tpu_torch.ops import codec

    rows = {}
    for name, size, x, p, plain_kw in cases(seed, sizes):
        kern = getattr(codec, name)
        # the reflect mode's calls name no pad: an older tree (--root) has none
        wrap = {"pad": pad} if pad != "reflect" else {}
        call = lambda: kern(x, p, **wrap)
        plain_kw = {**plain_kw, **wrap}
        got = call()
        ref = codec.conv3x3_plain(x, p, **plain_kw)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if not (torch.isfinite(got).all() and err <= 2e-5 * max(scale, 1.0)):
            raise AssertionError(f"{name} at {size}^2: max|kernel - plain| = "
                                 f"{err:.3e} over max|plain| = {scale:.3e}")
        t_flops, t_bytes = bounds(x, p, got, card)
        r = dict(err=err, device_ms=device_ms(call, reps),
                 ms=event_ms(call, reps), host_us=host_us(call, reps),
                 plain_ms=event_ms(lambda: codec.conv3x3_plain(x, p, **plain_kw),
                                   reps),
                 t_flops=t_flops, t_bytes=t_bytes)
        beside = ""
        if pad == "wrap":
            r["reflect_device_ms"] = device_ms(lambda: kern(x, p), reps)
            beside = f" (reflect {r['reflect_device_ms']:.4f} ms)"
        rows[(name, size)] = r
        print(f"edge {name + ('_wrap' if pad == 'wrap' else ''):17s} {size}^2:{beside} "
              f"err {err:.2e} (max|plain| "
              f"{scale:.3e})  device {r['device_ms']:.4f} ms  events "
              f"{r['ms']:.4f} ms  host {r['host_us']:.1f} us/call  plain "
              f"{r['plain_ms']:.4f} ms  bound bytes {t_bytes:.4f} ms, FMAs "
              f"{t_flops:.4f} ms  ({100 * max(t_bytes, t_flops) / r['device_ms']:.0f}"
              f"% of the bound)", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="the checkout whose optimaltextures_tpu_torch is timed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--pad", choices=("reflect", "wrap"), default="reflect",
                    help="the kernels' pad mode (wrap: tileable runs)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("edge_convs: no CUDA device is available", file=sys.stderr)
        return 2
    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.ops import codec

    core.full_f32_precision()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"edge_convs: {os.path.abspath(codec.__file__)} on {card}", flush=True)
    codec.build()
    time_edge_convs(args.seed, args.reps, card, pad=args.pad)
    return 0


if __name__ == "__main__":
    sys.exit(main())
