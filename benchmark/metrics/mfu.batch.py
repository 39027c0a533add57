"""FLOPs of the window's calls (the frozen FLOP model, the benchmark's own PCA widths) over window x cards x 989 TF/s (%)."""

from benchlib import readers


def read(ctx):
    return readers.mfu(ctx)
