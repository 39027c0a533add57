"""Bytes bound of the histogram and remap launches the schedule implies, over their device time (%)."""

from benchlib import readers


def read(ctx):
    return readers.cdf_roofline(ctx)
