"""What the per-layer metrics read, one function per quantity; each file
under ``benchmark/metrics/`` calls one of these. A function returns None
where the run holds nothing for it to read (no trace, or a layer the cell
does not run), and the harness then leaves the metric out of the line."""

from __future__ import annotations

from typing import NamedTuple, Optional

from . import bounds, flops, profiling

GEMM_OPS = ("aten::mm", "aten::bmm", "aten::baddbmm", "aten::addmm")


class Ctx(NamedTuple):
    cell: object            # cells.Cell
    result: dict            # session.run's result on rank 0

    @property
    def trace(self):
        return self.result.get("trace")

    @property
    def conv_dtype(self) -> str:
        return self.cell.config["conv_dtype"]

    @property
    def rows(self) -> int:
        return self.cell.traffic.get("spatial_devices", 1)

    def traced_images(self) -> int:
        return len(self.result["traced_calls"]) * self.cell.traffic["batch"]


def launches_per_image(ctx: Ctx) -> Optional[float]:
    """Device ops (kernels, copies, sets) per image in the traced calls."""
    if ctx.trace is None:
        return None
    return len(ctx.trace.device) / ctx.traced_images()


def gemm_ms_per_image(ctx: Ctx) -> Optional[float]:
    """Self device ms of the GEMM ops per image in the traced calls."""
    if ctx.trace is None:
        return None
    us = sum(t for name, t, _ in ctx.trace.ops if name in GEMM_OPS)
    return us / 1e3 / ctx.traced_images() if us > 0 else None


def _roofline(ctx: Ctx, parts, kind: str, peak: float) -> Optional[float]:
    if ctx.trace is None:
        return None
    us, n = profiling.kernel_us(ctx.trace, parts)
    if n == 0 or us <= 0:
        return None
    c, t, r = ctx.cell.config, ctx.cell.traffic, ctx.result
    act = 2 if ctx.conv_dtype == "bfloat16" else 4
    launches = []
    for ks in r["traced_ks"]:
        launches += bounds.call_launches(
            r["plan"], t["batch"], c["num_layers"], act, rows=ctx.rows,
            style_hw=r["style_hw"], ks=ks, kind=kind)
    if len(launches) != n:
        import sys
        print(f"{kind} bound: {len(launches)} launches from the schedule, "
              f"{n} in the trace", file=sys.stderr, flush=True)
    return 100.0 * bounds.bound_s(launches, peak) / (us / 1e6)


def codec_roofline(ctx: Ctx, conv_dtype: str) -> Optional[float]:
    if ctx.conv_dtype != conv_dtype:
        return None
    return _roofline(ctx, bounds.CODEC_KERNELS[conv_dtype], "codec",
                     bounds.PEAK_FLOPS[conv_dtype])


def cdf_roofline(ctx: Ctx) -> Optional[float]:
    if ctx.cell.traffic["hist_mode"] != "cdf":
        return None
    return _roofline(ctx, bounds.CDF_KERNELS, "cdf", 1.0)


def nccl_ms_per_image(ctx: Ctx) -> Optional[float]:
    if ctx.trace is None:
        return None
    us, n = profiling.kernel_us(ctx.trace, ("nccl",))
    return us / 1e3 / ctx.traced_images() if n else None


def device_idle(ctx: Ctx) -> Optional[float]:
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - profiling.busy_us(ctx.trace) / ctx.trace.window_us)


def peak_gib(ctx: Ctx) -> Optional[float]:
    return ctx.result["window_peak"] / 2 ** 30


def mfu(ctx: Ctx) -> Optional[float]:
    """FLOPs of the window's calls over the window, the cards and their
    peak rate in the configuration's precision."""
    ks_all = ctx.result.get("window_ks")
    if not ks_all:
        return None
    c, t = ctx.cell.config, ctx.cell.traffic
    total = sum(flops.run_flops(
        size=t["size"], iters=c["iters"], passes=c["passes"],
        depth=c["num_layers"], batch=t["batch"],
        pastiche_hw=(t["size"], t["size"]), style_hw=ctx.result["style_hw"],
        ks=ks, mode=t["hist_mode"]) for ks in ks_all)
    return 100.0 * total / (ctx.result["window_s"] * ctx.cell.chips
                            * bounds.PEAK_FLOPS[ctx.conv_dtype])
