"""The cdf step's two rotation products on the GPU (``ops/rotgemm.py``,
``csrc/rotgemm.cu``): ``rotate_rows`` and ``unrotate_rows`` at the shapes of
the last pass of a batch-128 512-px cdf run, each beside the step's former
expressions (torch.matmul in float32, and torch.aminmax of the rows).

    python3 optimaltextures_tpu_torch/tools/rot_gemm.py
        [--shapes 1:25,2:75,3:177,3:174] [--batch 128] [--size 512] [--reps R]

``--shapes`` are depth:width pairs (relu<depth> at PCA width C). The
default's first three are the widths the benchmark's batch-128 cdf cell
traced most at its last pass (relu1 24-25, relu2 73-76, relu3 173-179,
mostly odd), so they take the kernel's odd-width copies, the staged back
store (C 65-96) and, past 176, the 96-channel slices; relu3 at 174 takes the
88-channel slices. The clouds are (N, C) samples with channels of
decreasing spread around an offset, as a projected feature cloud has, and
a Haar rotation, from a fixed seed: relu1 N = batch x size^2, relu2 a
quarter of it, relu3 a sixteenth.

For each product and depth it prints:

* ``device``: the device time of the ``rot_gemm`` kernels torch.profiler
  saw over R calls, over R (the forward product's range combine included);
* ``events``: CUDA events around the same loop, over R;
* ``matmul``: the same for torch.matmul in float32 (TF32 off), and the
  forward's ``aminmax`` of the rows;
* the bound: the bytes (the cloud read once and written once, the
  rotation once) over the card's memory rate, and three TF32 products'
  operations over the dense TF32 rate; the larger names the bound, and the
  share is the bound over the device time;
* the relative RMS error of the kernel and of torch.matmul against a
  float64 product of the same operands.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (depth, PCA width): the cell's last-pass widths, then relu3 at 174
CELL_SHAPES = ((1, 25), (2, 75), (3, 177))
SHAPES = (*CELL_SHAPES, (3, 174))


def cloud(n: int, c: int, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    spread = torch.linspace(3.0, 0.1, c, device="cuda")
    return torch.randn((n, c), generator=g, device="cuda") * spread + 0.5


def rotation(c: int, seed: int):
    import torch

    from optimaltextures_tpu_torch.ops.rotation import random_rotation

    g = torch.Generator(device="cuda").manual_seed(seed)
    return random_rotation(g, c, "cuda")


def _rel(got, ref64) -> float:
    import torch

    return float(torch.linalg.vector_norm(got.double() - ref64)
                 / torch.linalg.vector_norm(ref64))


def rot_gemm_device_ms(fn, reps: int) -> float:
    """Device ms a call of the kernels whose name holds ``rot_gemm``."""
    from optimaltextures_tpu_torch.tools import edge_convs as ec

    rows = ec.profiled_kernels(fn, reps)
    if rows is None:
        return ec.event_ms(fn, reps)
    return sum(us for name, us, _ in rows if "rot_gemm" in name) / 1e3 / reps


def time_rot_gemm(shapes, reps: int, card: str, batch: int = 128,
                  size: int = 512) -> dict:
    """{(product, label): dict(shape, err, rel_rms, lib_rel_rms, device_ms,
    ms, plain_ms, lib_ms, t_flops, t_bytes)} at each (depth, C) of
    ``shapes``; ``plain_ms`` is the former expression (the forward's with
    its aminmax), ``lib_ms`` the torch.matmul alone."""
    import torch

    from optimaltextures_tpu_torch.ops import rotgemm
    from optimaltextures_tpu_torch.tools import edge_convs as ec

    _, peak_bw = ec.peaks(card)
    tf32, _ = ec.peaks(card, "tf32")
    out = {}
    for depth, c in shapes:
        n = batch * (size >> (depth - 1)) ** 2
        label = f"relu{depth} C={c} N={n}"
        x, rot = cloud(n, c, depth), rotation(c, depth)
        rows, lo, hi = rotgemm.rotate_rows(x, rot)
        back = rotgemm.unrotate_rows(rows, rot)
        ref_f = rot.double().T @ x.double().T
        ref_b = rows.double().T @ rot.double().T
        lib_rows = rot.T @ x.T
        wlo, whi = torch.aminmax(rows, dim=1)
        if not (torch.equal(lo, wlo) and torch.equal(hi, whi)):
            raise AssertionError(f"rotate_rows [{label}]: ranges differ from "
                                 "torch.aminmax of the rows")
        t_bytes = 4.0 * (2 * n * c + c * c) / peak_bw * 1e3
        t_flops = 3 * 2.0 * n * c * c / tf32 * 1e3
        cases = (
            ("rotate_rows", lambda: rotgemm.rotate_rows(x, rot),
             lambda: torch.aminmax(rot.T @ x.T, dim=1), lambda: rot.T @ x.T,
             rows, lib_rows, ref_f),
            ("unrotate_rows", lambda: rotgemm.unrotate_rows(rows, rot), None,
             lambda: rows.T @ rot.T, back, rows.T @ rot.T, ref_b))
        for name, fn, plain, lib, got, lib_out, ref in cases:
            r = dict(shape=(depth, c), rel_rms=_rel(got, ref),
                     lib_rel_rms=_rel(lib_out, ref),
                     err=float((got - lib_out).abs().max()),
                     device_ms=rot_gemm_device_ms(fn, reps),
                     ms=ec.event_ms(fn, reps), lib_ms=ec.event_ms(lib, reps),
                     t_flops=t_flops, t_bytes=t_bytes)
            r["plain_ms"] = (ec.event_ms(plain, reps) if plain is not None
                             else r["lib_ms"])
            out[(name, label)] = r
            bound = max(t_bytes, t_flops)
            print(f"{name:13s} {label:24s} device {r['device_ms']:.4f} ms "
                  f"({100 * bound / r['device_ms']:.1f}% of the bound) events "
                  f"{r['ms']:.4f} ms  matmul {r['lib_ms']:.4f} ms (former "
                  f"expression {r['plain_ms']:.4f})  bound bytes {t_bytes:.4f}, "
                  f"3xTF32 {t_flops:.4f} ms  rel RMS {r['rel_rms']:.3e} "
                  f"(matmul f32 {r['lib_rel_rms']:.3e})  max|kernel - matmul| "
                  f"{r['err']:.3e}  [{card}]", flush=True)
        del x, rows, back, ref_f, ref_b, lib_rows
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=",".join(f"{d}:{c}" for d, c in SHAPES),
                    help="depth:PCA width pairs")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import torch

    if not torch.cuda.is_available():
        print("rot_gemm: no CUDA device is available", file=sys.stderr)
        return 2
    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.ops import rotgemm

    core.full_f32_precision()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    rotgemm.build()
    shapes = [tuple(map(int, s.split(":"))) for s in args.shapes.split(",")]
    time_rot_gemm(shapes, args.reps, card, args.batch, args.size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
