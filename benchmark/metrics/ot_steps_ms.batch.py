"""Device ms launched inside the program's optex.ot_steps spans (the transport loop: rotation GEMMs, range, cdf kernels) per image of the traced calls."""

from benchlib import spans


def read(ctx):
    return spans.ms_per_image(ctx, ("optex.ot_steps",))
