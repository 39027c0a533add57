"""The program's optex.fetch spans (its copies to the host inside a run, each a wait for the device) per traced call."""

from benchlib import spans


def read(ctx):
    return spans.fetches_per_call(ctx)
