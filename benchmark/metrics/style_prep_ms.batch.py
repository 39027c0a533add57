"""Device ms launched inside the program's optex.style_prep span (style resize, multi-tap encode, spectra, targets) per image of the traced calls."""

from benchlib import spans


def read(ctx):
    return spans.ms_per_image(ctx, ("optex.style_prep",))
