"""What holds the bf16 wgmma kernel (csrc/conv_wg.cu) back: the kernel
timed beside builds of it with parts switched off, at the slice path's
batch-128 shapes of its three modes.

    python3 optimaltextures_tpu_torch/tools/wg_diag.py [--reps R]
        [--shapes p2_64 p2_128 full_64 full_128 up_64 up_128]

Variants (each a copy of the source with one loop's bound patched to 0,
built with the package's nvcc flags, one nvcc per variant, all started
together):

* ``full``: the kernel as it is;
* ``no_loads``: the producer issues no cp.async (the ring holds whatever
  shared memory held; the mbarrier protocol runs unchanged);
* ``no_stores``: the epilogue stages its rows but writes nothing to y;
* ``mma_only``: both: the weight copy, the ring protocol, the wgmma K
  loops and the staging alone.

Each call is timed with CUDA events over R launches after a warm-up, all
variants of a shape in one process on one card. The outputs of the
patched builds are garbage; only ``full`` is a result.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (loop header in csrc/conv_wg.cu, the same loop with no iterations)
_LOADS = ("for (int e = lane; e < C::kPx * C::kGroups; e += 32) {",
          "for (int e = lane; e < 0; e += 32) {")
_STORES = ("for (int q = ctid; q < npx * 8; q += 128) {",
           "for (int q = ctid; q < 0; q += 128) {")
VARIANTS = {"full": (), "no_loads": (_LOADS,), "no_stores": (_STORES,),
            "mma_only": (_LOADS, _STORES)}

# name: (entry point, N, H, W, Cin, extra args): the slice path's shapes
SHAPES = {
    "p2_64": ("optex_conv3x3_p2_bf16", 128, 512, 512, 64, (64, 1, 1)),
    "p2_128": ("optex_conv3x3_p2_bf16", 128, 256, 256, 128, (128, 1, 0)),
    "full_64": ("optex_conv3x3_full_bf16", 128, 256, 256, 64, (64, 1, 0)),
    "full_128": ("optex_conv3x3_full_bf16", 128, 256, 256, 128, (128, 1, 1)),
    "up_64": ("optex_upconv_p2_bf16", 128, 256, 256, 64, (64,)),
    "up_128": ("optex_upconv_p2_bf16", 128, 128, 128, 128, (128,)),
}


def build_variants(out_dir: str, source: str = "conv_wg", variants=VARIANTS) -> dict:
    """Patch csrc/<source>.cu for every variant ({name: ((old, new), ...)},
    each old text present once) and compile them, one nvcc each, all
    started together; returns {name: library path}."""
    from optimaltextures_tpu_torch.ops import cuda_build

    with open(os.path.join(cuda_build.CSRC_DIR, source + ".cu")) as f:
        src = f.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, patches in variants.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"'{old}' is not in csrc/{source}.cu once")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{source}_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{source}_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} build of csrc/{source}.cu:"
                               f"\n{err}{out}")
        libs[name] = lib
    return libs


def time_shape(libs: dict, shape: str, reps: int) -> dict:
    """ms a call of every variant at ``shape`` (CUDA events, ``reps``
    launches after three)."""
    import torch

    from optimaltextures_tpu_torch.ops import codec

    entry, n, h, w, cin, extra = SHAPES[shape]
    up = entry == "optex_upconv_p2_bf16"
    cout = cin if up else (64 if "p2" in entry else 128)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((n, h, w, cin), generator=g, device="cuda").to(torch.bfloat16)
    wt = (torch.randn((cout, cin, 3, 3), generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    b = (torch.randn((cout,), generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    p = (codec.pack_up if up else codec.pack)(wt, b)
    pool = not up and extra[2]
    oh, ow = (2 * h, 2 * w) if up else (((h + 1) // 2, (w + 1) // 2) if pool else (h, w))
    y = torch.empty((n, oh, ow, cout), device="cuda", dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, path in libs.items():
        fn = getattr(ctypes.CDLL(path), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * (4 + len(extra))
                       + [ctypes.c_void_p])
        # the reflect mode (wrap 0)
        args = (x.data_ptr(), p.w_wg.data_ptr(), p.b.data_ptr(), y.data_ptr(), n, h, w,
                *extra, 0, stream)
        for _ in range(3):
            if fn(*args):
                raise RuntimeError(f"wg_diag: {name} {shape}: launch failed")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    args = ap.parse_args()
    sys.path.insert(0, _ROOT)
    import torch

    if not torch.cuda.is_available():
        print("wg_diag: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"wg_diag on {card}", flush=True)
    libs = build_variants(os.path.join(_ROOT, "build", "wg_diag"))
    for shape in args.shapes:
        ms = time_shape(libs, shape, args.reps)
        print(f"wg_diag {shape:9s} " + "  ".join(f"{k} {v:.4f} ms" for k, v in ms.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
