"""What holds the bf16 edge kernels (csrc/edge_mma.cu) back: each kernel
timed beside builds of it with parts switched off, at the slice path's
shape (512^2, batch 128) and at batch 1.

    python3 optimaltextures_tpu_torch/tools/edge_diag.py [--reps R] [--batches 128 1]

Variants (each a copy of the source with one statement patched, built with
the package's nvcc flags, one nvcc per variant, all started together, by
``tools/wg_diag.build_variants``):

* ``full``: both kernels as they are;
* final_to_rgb_mma: ``no_product`` (no ldmatrix, mma or Z store: the ring,
  the reflect repair and the shift-sum of whatever Z holds),
  ``no_sum`` (no shift-sum and no output store), ``loads_only`` (both: the
  TMA ring and the repair alone);
* rgb_to_relu1_mma: ``no_store`` (no TMA store of the staged tile),
  ``no_mma`` (no gather, mma or staging: the halo loads and the stores of
  whatever the staging holds), ``stages3`` and ``stages4`` (three or four
  staged output tiles in place of two), ``no_fetch`` (no global load of
  the input halo), ``blocks2`` (two blocks an SM, at most 128 registers a
  thread).

Each call is timed with CUDA events over R launches after a warm-up, all
variants of a kernel in one process on one card. The outputs of the
builds with a part switched off are garbage; ``full`` and the ``stages``
and ``blocks2`` variants compute the function.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (a statement in csrc/edge_mma.cu, the same with the part switched off)
_PRODUCT = ("for (int mt = warp; mt < kFinMTiles; mt += 8) {",
            "for (int mt = warp; mt < 0; mt += 8) {")
_SUM = ("if (Y < H && X < W) {\n      float s0", "if (false) {\n      float s0")
_STORE = ("tma_store_4d(&ymap, saddr(st), 0, e.x0, e.y0, e.n);", "")
_MMA = ("for (int mt = 0; mt < 2; ++mt) {\n      const int r",
        "for (int mt = 0; mt < 0; ++mt) {\n      const int r")
_STAGES = "constexpr int kEntStages = 2;"
_FETCH = ("pre[l] = __ldg(xn + (static_cast<size_t>(gy) * W + gx) * 3 + ci);",
          "pre[l] = 0.f;")
_BLOCKS = "constexpr int kEntBlocks = 1;"
# kernel: {variant: patches}
VARIANTS = {
    "final_to_rgb": {"full": (), "no_product": (_PRODUCT,), "no_sum": (_SUM,),
                     "loads_only": (_PRODUCT, _SUM)},
    "rgb_to_relu1": {"full": (), "no_store": (_STORE,), "no_mma": (_MMA,),
                     "stages3": ((_STAGES, _STAGES.replace("2", "3")),),
                     "stages4": ((_STAGES, _STAGES.replace("2", "4")),),
                     "no_fetch": (_FETCH,),
                     "blocks2": ((_BLOCKS, _BLOCKS.replace("1", "2")),)},
}


def time_kernel(libs: dict, kernel: str, batch: int, reps: int) -> dict:
    """ms a call of every variant of ``kernel`` at 512^2 x ``batch`` (CUDA
    events, ``reps`` launches after three)."""
    import torch

    from optimaltextures_tpu_torch.ops import codec

    size = 512
    cin, cout = (64, 3) if kernel == "final_to_rgb" else (3, 64)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((batch, size, size, cin), generator=g, device="cuda")
    if kernel == "final_to_rgb":
        x = x.to(torch.bfloat16)
    w = (torch.randn((cout, cin, 3, 3), generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    b = (torch.randn((cout,), generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    p = codec.pack(w, b)
    y = torch.empty((batch, size, size, cout), device="cuda",
                    dtype=torch.float32 if kernel == "final_to_rgb" else torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name in VARIANTS[kernel]:
        fn = getattr(ctypes.CDLL(libs[f"{kernel}.{name}"]), f"optex_{kernel}_bf16")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        # the reflect mode (wrap 0)
        args = (x.data_ptr(), p.w_edge.data_ptr(), p.b.data_ptr(), y.data_ptr(), batch,
                size, size, 0, stream)
        for _ in range(3):
            if fn(*args):
                raise RuntimeError(f"edge_diag: {kernel} {name}: launch failed")
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
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batches", type=int, nargs="+", default=[128, 1])
    args = ap.parse_args()
    sys.path.insert(0, _ROOT)
    import torch

    if not torch.cuda.is_available():
        print("edge_diag: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"edge_diag on {card}", flush=True)
    from optimaltextures_tpu_torch.tools import wg_diag

    libs = wg_diag.build_variants(
        os.path.join(_ROOT, "build", "edge_diag"), "edge_mma",
        {f"{k}.{name}": p for k, v in VARIANTS.items() for name, p in v.items()})
    for batch in args.batches:
        for kernel in VARIANTS:
            ms = time_kernel(libs, kernel, batch, args.reps)
            print(f"edge_diag {kernel:12s} B={batch:<3d} "
                  + "  ".join(f"{k} {v:.4f} ms" for k, v in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
