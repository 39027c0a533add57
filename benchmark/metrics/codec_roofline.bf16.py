"""Bound of the bf16 codec kernels (1b-5b) over their device time (%): max(2 MACs / 989 TF/s, bytes / 3.35 TB/s) a launch."""

from benchlib import readers


def read(ctx):
    return readers.codec_roofline(ctx, "bfloat16")
