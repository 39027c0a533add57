"""FLOPs of the window's calls (the frozen FLOP model, the benchmark's own PCA widths) over window x cards x the configuration's peak (%)."""

from benchlib import readers


def read(ctx):
    return readers.mfu(ctx)
