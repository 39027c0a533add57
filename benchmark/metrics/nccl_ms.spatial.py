"""Rank 0's device ms per image in NCCL kernels."""

from benchlib import readers


def read(ctx):
    return readers.nccl_ms_per_image(ctx)
