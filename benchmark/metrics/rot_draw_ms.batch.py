"""Device ms launched inside the program's optex.rotations spans (each stage's rotation stack: the Newton-Schulz polar draw) per image of the traced calls."""

from benchlib import spans


def read(ctx):
    return spans.ms_per_image(ctx, ("optex.rotations",))
