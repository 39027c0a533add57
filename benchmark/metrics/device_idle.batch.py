"""1 - the union of device-op intervals over the traced window (%)."""

from benchlib import readers


def read(ctx):
    return readers.device_idle(ctx)
