"""The bf16 function of the five codec kernels on the GPU: each against its
bf16 plain version at the eight 512-px roundtrip shapes, at batch 1 and at
batch 128, with its times beside its bound and cuDNN's bf16 conv.

    python3 optimaltextures_tpu_torch/tools/bf16_codec.py [--root TREE]
        [--seed N] [--reps R] [--batches 1 128] [--kernels NAME ...]
        [--pad reflect|wrap]

The batch-1 inputs are made as ``chip_smoke.py`` phase 3 makes the f32
ones: a plain decode -> encode roundtrip of the real depth-3 weights (here
a bf16 bank) on a style exemplar made from ``--seed``. A batch-B input
stacks B copies of it, copy i rolled by (7 i, 13 i) pixels and scaled by
0.75 + i / 2B, so no two images are equal and an image that reads another
image's pixels shows. ``--root`` imports the port's package from another
checkout of the repo, so two versions are timed by one script, in one call.
``--kernels`` keeps the shapes of the kernels named (default: all five).
``--pad wrap`` checks and times the kernels' wrap mode (circular padding,
tileable runs) against the plain versions in wrap mode, with the reflect
mode's device time on the same inputs beside each.

For each kernel, shape and batch it prints:

* the error against the plain version (the bound: 2^-7 x max|plain|, one
  bf16 rounding) and the signed mean error over max|plain| (the tensor
  cores' accumulate rounds toward zero: a lean shows here);
* whether repeated launches equal the first bit for bit;
* ``device``: the profiler's device time a call; ``events``: CUDA events
  around R calls, over R (for a call of tens of microseconds the host can
  set it); the plain version's time; one cuDNN bf16 ``F.conv2d`` on a
  channels-last input padded before the clock, for the same conv (as
  phase 3 times the f32 convs: the conv alone);
* the bound: the larger of the operations over the dense bf16 tensor-core
  rate and the bytes (each input read once, each output written once) over
  the memory rate.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

# (kernel, label, input key, stage field, index, wrapper kwargs)
SHAPES = [
    ("rgb_to_relu1", "3->64 relu, 512^2", "rgb", "head", 0, {}),
    ("conv3x3_p2", "enc 64->64 relu+pool, 512^2", "r11", "head", 1,
     dict(relu=True, pool=True)),
    ("conv3x3_p2", "dec 128->64 relu, 256^2", "up128", "tail", 1, dict(relu=True)),
    ("conv3x3_full", "enc 64->128 relu, 256^2", "r11p", "head", 2, dict(relu=True)),
    ("conv3x3_full", "enc 128->128 relu+pool, 256^2", "r2a", "head", 3,
     dict(relu=True, pool=True)),
    ("upconv_p2", "dec up 128->128 relu, 128^2->256^2", "d128", "tail", 0, {}),
    ("upconv_p2", "dec up 64->64 relu, 256^2->512^2", "d64", "tail", 2, {}),
    ("final_to_rgb", "dec 64->3 + renorm, 512^2", "up64", "final", None, {}),
]
TOL = 2.0 ** -7


def plain_kwargs(name: str, kw: dict) -> dict:
    """The plain version's kwargs for a wrapper call ``name(x, p, **kw)``."""
    import torch

    if name == "rgb_to_relu1":
        return dict(relu=True)
    if name == "upconv_p2":
        return dict(relu=True, up=True)
    if name == "final_to_rgb":
        return dict(out_dtype=torch.float32)
    return dict(kw)


def stack(x, batch: int):
    """B distinct images from one: copy i rolled by (7 i, 13 i), scaled by
    0.75 + i / 2B (in x's dtype)."""
    import torch

    if batch == 1:
        return x
    out = torch.empty((batch, *x.shape[1:]), device=x.device, dtype=x.dtype)
    for i in range(batch):
        out[i] = torch.roll(x[0], (7 * i, 13 * i), (0, 1)) * (0.75 + i / (2 * batch))
    return out


def roundtrip_bf16(seed: int):
    """The batch-1 bf16 inputs of every kernel (tools/edge_convs.roundtrip on
    a bf16 bank) and the packed bf16 stage."""
    import torch

    from optimaltextures_tpu_torch.models.vgg import VGGBank
    from optimaltextures_tpu_torch.tools import edge_convs

    dev = torch.device("cuda")
    bank = VGGBank(3, device=dev, dtype=torch.bfloat16)
    px = torch.as_tensor(edge_convs.style_exemplar(seed, 512), device=dev)
    return edge_convs.roundtrip(bank, px.to(torch.bfloat16))


def work(name, x, p, y):
    """(operations, bytes) of one call: 2 Cin Cout FLOPs a tap and output
    pixel (9 taps; the upconv's 4 folded taps a fine pixel); x, the weights
    (bf16), the f32 bias and y each moved once."""
    cout, cin = p.w.shape[:2]
    if name == "upconv_p2":
        taps, px = 4, x.shape[0] * 4 * x.shape[1] * x.shape[2]
    else:
        taps, px = 9, x.shape[0] * x.shape[1] * x.shape[2]
    flops = 2.0 * px * cout * cin * taps
    nbytes = (x.numel() * x.element_size() + 2 * p.w.numel() + 4 * p.b.numel()
              + y.numel() * y.element_size())
    return flops, nbytes


def _compare(got, ref):
    """(max |got - ref|, max |ref|, signed mean error) in f32, 16 images at
    a time (a batch-128 pair in f32 would take another 17 GB)."""
    err = scale = lean = 0.0
    finite = True
    for i in range(0, got.shape[0], 16):
        g, r = got[i:i + 16].float(), ref[i:i + 16].float()
        finite = finite and bool(g.isfinite().all())
        err = max(err, float((g - r).abs().max()))
        scale = max(scale, float(r.abs().max()))
        lean += float(((g - r) * r.sign()).sum())
    return err, scale, lean / got.numel(), finite


def library_call(name, x, p, pad="reflect"):
    """One cuDNN bf16 ``F.conv2d`` with the conv's weights and bias on the
    same input (nearest-upsampled for the upconv) padded (reflect, or
    circularly for ``pad="wrap"``) into channels-last before the clock, as
    phase 3 times the f32 convs: the conv, without the ReLU and pool the
    kernels fuse. The padding runs in pieces of 16 images (PyTorch's reflect
    pad takes 32-bit index math only)."""
    import torch
    import torch.nn.functional as F

    parts = []
    for i in range(0, x.shape[0], 16):
        t = x[i:i + 16].to(torch.bfloat16).permute(0, 3, 1, 2)
        if name == "upconv_p2":
            t = F.interpolate(t, scale_factor=2, mode="nearest")
        parts.append(F.pad(t, (1, 1, 1, 1), mode="reflect" if pad == "reflect"
                           else "circular"))
    t = torch.cat(parts).contiguous(memory_format=torch.channels_last)
    del parts
    w = p.w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b = p.b.to(torch.bfloat16)
    return lambda: F.conv2d(t, w, b)


def check_and_time(seed: int, reps: int, card: str, batches=(1, 128), kernels=None,
                   pad: str = "reflect"):
    """Every bf16 kernel (of ``kernels``, default all) at every shape and
    batch in pad mode ``pad``: held against its plain version in that mode
    (raises past 2^-7 x max|plain| or on a repeated launch that differs),
    timed. Returns {(kernel, label, batch): row}; a wrap row also carries
    ``reflect_device_ms``, the reflect mode's device time on the same
    inputs."""
    import torch

    from optimaltextures_tpu_torch.ops import codec
    from optimaltextures_tpu_torch.tools import edge_convs

    peak_flops, peak_bw = edge_convs.peaks(card, "bf16")
    t = roundtrip_bf16(seed)
    sc = t["stage"]
    rows = {}
    for batch in batches:
        for name, label, key, field, idx, kw in SHAPES:
            if kernels is not None and name not in kernels:
                continue
            p = getattr(sc, field) if idx is None else getattr(sc, field)[idx]
            x = stack(t[key], batch)
            kern = getattr(codec, name)
            # the reflect mode's calls name no pad: an older tree (--root)
            # has none
            wrap = {"pad": pad} if pad != "reflect" else {}
            pkw = {**plain_kwargs(name, kw), **wrap}
            kw = {**kw, **wrap}
            got = kern(x, p, **kw)
            ref = codec.conv3x3_plain(x, p, **pkw)
            torch.cuda.synchronize()
            err, scale, lean, finite = _compare(got, ref)
            del ref
            if not (finite and err <= TOL * scale):
                raise AssertionError(f"{name}_bf16 [{label}] B={batch}: max|kernel "
                                     f"- plain| = {err:.3e} over max|plain| = "
                                     f"{scale:.3e}")
            n_rep = 10 if batch == 1 else 3
            differ = sum(not torch.equal(kern(x, p, **kw), got) for _ in range(n_rep))
            if differ:
                raise AssertionError(f"{name}_bf16 [{label}] B={batch}: {differ} of "
                                     f"{n_rep} repeated launches differ")
            flops, nbytes = work(name, x, p, got)
            del got
            r_reps = reps if batch == 1 else max(3, reps // 4)
            r = dict(err=err, scale=scale, lean=lean / scale,
                     device_ms=edge_convs.device_ms(lambda: kern(x, p, **kw), r_reps),
                     ms=edge_convs.event_ms(lambda: kern(x, p, **kw), r_reps),
                     plain_ms=edge_convs.event_ms(
                         lambda: codec.conv3x3_plain(x, p, **pkw), max(2, r_reps // 4)),
                     t_flops=flops / peak_flops * 1e3, t_bytes=nbytes / peak_bw * 1e3,
                     repeats=n_rep)
            if pad == "wrap":
                reflect_kw = {k: v for k, v in kw.items() if k != "pad"}
                r["reflect_device_ms"] = edge_convs.device_ms(
                    lambda: kern(x, p, **reflect_kw), r_reps)
            torch.cuda.empty_cache()
            r["lib_ms"] = edge_convs.event_ms(library_call(name, x, p, pad), r_reps)
            r["bound"] = max(r["t_flops"], r["t_bytes"])
            rows[(name, label, batch)] = r
            beside = (f" (reflect {r['reflect_device_ms']:.4f} ms)" if pad == "wrap"
                      else "")
            print(f"bf16 {name + ('_wrap' if pad == 'wrap' else ''):18s} {label:36s} "
                  f"B={batch:<3d}{beside} err {err:.2e} (max|plain| "
                  f"{scale:.3e}, lean {r['lean']:+.2e})  repeats equal {n_rep}/{n_rep}  "
                  f"device {r['device_ms']:.4f} ms  events {r['ms']:.4f} ms  plain "
                  f"{r['plain_ms']:.4f} ms  cuDNN bf16 {r['lib_ms']:.4f} ms  bound "
                  f"{r['bound']:.4f} ms ({'operations' if r['t_flops'] >= r['t_bytes'] else 'bytes'}"
                  f", {100 * r['bound'] / r['device_ms']:.0f}% of it)", flush=True)
            del x
            torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="the checkout whose optimaltextures_tpu_torch is timed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 128])
    ap.add_argument("--kernels", nargs="+", choices=sorted({s[0] for s in SHAPES}),
                    help="time only these kernels' shapes")
    ap.add_argument("--pad", choices=("reflect", "wrap"), default="reflect",
                    help="the kernels' pad mode (wrap: tileable runs)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("bf16_codec: no CUDA device is available", file=sys.stderr)
        return 2
    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.ops import codec

    core.full_f32_precision()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"bf16_codec: {os.path.abspath(codec.__file__)} on {card}", flush=True)
    codec.build()
    check_and_time(args.seed, args.reps, card, tuple(args.batches), args.kernels,
                   args.pad)
    return 0


if __name__ == "__main__":
    sys.exit(main())
