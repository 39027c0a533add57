"""torch.cuda.max_memory_allocated over the window, reset at its start (GiB)."""

from benchlib import readers


def read(ctx):
    return readers.peak_gib(ctx)
