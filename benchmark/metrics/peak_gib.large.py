"""torch.cuda.max_memory_allocated over the window, reset at its start (GiB); rank 0 on several cards."""

from benchlib import readers


def read(ctx):
    return readers.peak_gib(ctx)
