"""1 - the union of device-op intervals over the traced window (%); rank 0 on several cards."""

from benchlib import readers


def read(ctx):
    return readers.device_idle(ctx)
