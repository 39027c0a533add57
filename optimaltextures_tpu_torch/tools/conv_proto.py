"""The 64 -> 64 channel 3x3 conv prototype on the GPU (the port of
``tools/pallas_conv_proto.py``): check :func:`ops.conv64.conv64` against
F.conv2d, then time it.

    python -m optimaltextures_tpu_torch.tools.conv_proto [--size 512]
        [--batch 128] [--n 20] [--check_only] [--check_size 64] [--device cuda]

First a correctness check at ``--check_size`` px (64, as the JAX tool):
the kernel (with ``--device cpu`` its plain version itself) against its
plain version, ReLU of one float32 F.conv2d with the unpacked weights (TF32
off) rounded to bf16, the counterpart of the JAX tool's lax.conv
reference; it prints the max abs error and the error relative to
max|ref|.
Then, on the GPU only, the time of one conv64 call at ``--size`` px and
``--batch`` images (CUDA events over ``--n`` calls after a warm-up), its
TF/s, and the card's bound for the same work: the larger of the bytes over
3.35 TB/s and the operations over the 989 TF/s bf16 tensor-core rate (the
H100 SXM data sheet). The input is padded and laid out (H+2, W+2, 64, B)
before the clock starts, as the JAX tool's caller does.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops import conv64 as k9

PEAK_BF16 = 989e12     # dense bf16 tensor-core rate, FLOP/s
PEAK_BYTES = 3.35e12   # HBM3, bytes/s


def work(size: int, batch: int):
    """(operations, bytes) of one call at (size, size, 64, batch): each
    input byte read once, each output byte written once."""
    flops = 2.0 * 9 * 64 * 64 * size * size * batch
    nbytes = 2.0 * ((size + 2) ** 2 * 64 * batch + size * size * 64 * batch
                    + 3 * 128 * 256)
    return flops, nbytes


def check(size: int, batch: int, wrow: torch.Tensor, gen: torch.Generator,
          device) -> float:
    """The kernel at (size, size, 64, batch) against its plain version;
    returns the relative error."""
    xs = torch.randn((size + 2, size + 2, 64, batch), generator=gen,
                     device=device).to(torch.bfloat16)
    got = k9.conv64(xs, wrow).float()
    ref = k9.conv64_plain(xs, wrow).float()
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    print(f"correctness {size}px (batch {batch}, {device.type}): max abs err "
          f"{err:.3e} (rel {rel:.2e})", flush=True)
    return rel


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--check_only", action="store_true")
    ap.add_argument("--check_size", type=int, default=64)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the kernel) or cpu (its plain version; "
                         "check only)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("conv_proto: no CUDA device; pass --device cpu "
                             "with --check_only to check on the CPU")
        torch.backends.cudnn.allow_tf32 = False
    elif not args.check_only:
        raise SystemExit("conv_proto: timing runs on the GPU only; add "
                         "--check_only for the CPU check")
    gen = torch.Generator(device=device).manual_seed(0)
    wrow = k9.pack_wrow((torch.randn((3, 3, 64, 64), generator=gen,
                                     device=device) * 0.1).to(torch.bfloat16))
    check(args.check_size, args.batch, wrow, gen, device)
    if args.check_only:
        return 0

    s, b = args.size, args.batch
    xpad = torch.randn((s + 2, s + 2, 64, b), generator=gen,
                       device=device).to(torch.bfloat16)
    k9.conv64(xpad, wrow)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.n):
        k9.conv64(xpad, wrow)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / args.n
    flops, nbytes = work(s, b)
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    print(f"conv64 kernel ({torch.cuda.get_device_name(device)}), {s}px x {b}: "
          f"{ms:.3f} ms  {flops / ms / 1e9:.1f} TF/s  (bound "
          f"{max(t_ops, t_bytes):.3f} ms by "
          f"{'operations' if t_ops >= t_bytes else 'bytes'}: "
          f"{t_bytes:.3f} ms bytes, {t_ops:.3f} ms operations)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
