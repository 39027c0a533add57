"""What holds the fused cdf apply (csrc/cdf.cu ``cdf_segments``, kernel 8)
back: the kernel timed beside builds of it with parts switched off, at the
cdf step's three shapes (tools/cdf_kernels.py's relu1, pixel and relu3
clouds).

    python3 optimaltextures_tpu_torch/tools/cdf_diag.py [--seed N] [--reps R]

Variants (each a copy of the source with one statement patched, built with
the package's nvcc flags, one nvcc per variant, all started together, by
``tools/wg_diag.build_variants``):

* ``full``: the kernel as it is;
* ``no_map``: every sample maps to itself (the stream of 16-byte loads and
  stores and the table build, with no guess, check or lerp);
* ``no_loop``: the sample loop switched off (each thread maps one sample
  of its run's start, so the tables are still built and read: the table
  build, the launch and the block's set-up alone);
* ``rcp_guess``: the guess by a multiply with the step's reciprocal in
  place of the division (the check keeps the output exact; a guess the
  rounding moves over an edge takes the binary search).

Each variant is timed by the profiler's device time over R launches (the
kernel's own record), all variants in one process on one card. The
outputs of ``no_map`` and ``no_loop`` are garbage; ``full`` and
``rcp_guess`` compute the function and must equal the plain version bit
for bit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_MAP = ("    int i = min(max(__float2int_rz(ceilf(u)), 1), kBins) - 1;\n",
        "    return x;\n    int i = min(max(__float2int_rz(ceilf(u)), 1), kBins) - 1;\n")
_LOOP = ("  map_run(GuessedSegments{seg, edges, l, step > 0.0f ? step : 1.0f}, r, v, w, y, e,\n"
         "          xe, q);\n",
         "  y[min(r.head + 4 * r.v0 + tid, n - 1)] =\n"
         "      GuessedSegments{seg, edges, l, step > 0.0f ? step : 1.0f}(xe);\n")
_RCP = ("    const float u = __fdiv_rn(__fsub_rn(x, lo), step_safe);\n    int i",
        "    const float u = __fmul_rn(__fsub_rn(x, lo), __frcp_rn(step_safe));\n    int i")
VARIANTS = {"full": (), "no_map": (_MAP,), "no_loop": (_LOOP,), "rcp_guess": (_RCP,)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, _ROOT)
    import torch

    if not torch.cuda.is_available():
        print("cdf_diag: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"cdf_diag on {card}", flush=True)
    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.ops import cdf
    from optimaltextures_tpu_torch.tools import cdf_kernels, wg_diag

    core.full_f32_precision()
    libs = wg_diag.build_variants(os.path.join(_ROOT, "build", "cdf_diag"), "cdf",
                                  VARIANTS)
    fns = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(path).optex_cdf_remap
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    stream = torch.cuda.current_stream().cuda_stream
    clouds, _, _ = cdf_kernels.clouds(args.seed)
    total = {name: 0.0 for name in fns}
    for label, t, s in clouds:
        c, n = t.shape
        lo = torch.minimum(t.min(dim=1).values, s.min(dim=1).values)
        hi = torch.maximum(t.max(dim=1).values, s.max(dim=1).values)
        t_hist, s_hist = cdf.histogram_plain(t, lo, hi), cdf.histogram_plain(s, lo, hi)
        out = torch.empty_like(t)
        ptrs = (t.data_ptr(), t_hist.data_ptr(), s_hist.data_ptr(), lo.data_ptr(),
                hi.data_ptr(), out.data_ptr(), c, n, stream)
        ref = cdf.cdf_remap_plain(t, t_hist, s_hist, lo, hi)
        line = []
        for name, fn in fns.items():
            launch = lambda: fn(*ptrs)
            if launch():
                raise RuntimeError(f"cdf_diag: the {name} build failed to launch")
            torch.cuda.synchronize()
            if name in ("full", "rcp_guess") and not torch.equal(out, ref):
                raise AssertionError(f"cdf_diag [{label}]: the {name} build differs "
                                     "from the plain version")
            ms = sum(m for m, _ in cdf_kernels.device_breakdown(launch, args.reps).values())
            total[name] += ms
            line.append(f"{name} {ms:.4f} ms")
        print(f"cdf_diag {label:20s} " + "  ".join(line), flush=True)
    print("cdf_diag summed over the three shapes: "
          + "  ".join(f"{k} {v:.4f} ms" for k, v in total.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
