"""Bound of the float32 codec kernels (1-5) over their device time (%): 2 MACs counted once at 495 TF/s, the TF32 rate, or bytes at 3.35 TB/s."""

from benchlib import readers


def read(ctx):
    return readers.codec_roofline(ctx, "float32")
