"""Device ms of the step's rotation kernels (every kernel whose name holds rot_gemm) per image of the traced calls."""

from benchlib import profiling


def read(ctx):
    us, n = profiling.kernel_us(ctx.trace, ("rot_gemm",)) if ctx.trace else (0.0, 0)
    return us / 1e3 / ctx.traced_images() if n else None
