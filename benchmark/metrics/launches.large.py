"""Device kernels, copies and sets per image in the traced calls, counted by torch.profiler."""

from benchlib import readers


def read(ctx):
    return readers.launches_per_image(ctx)
