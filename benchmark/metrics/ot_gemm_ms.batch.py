"""The profiler's self device ms of aten::mm, bmm, baddbmm and addmm per image (the OT's GEMMs, with the PCA projections and resizes)."""

from benchlib import readers


def read(ctx):
    return readers.gemm_ms_per_image(ctx)
