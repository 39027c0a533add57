"""Device ms launched inside the program's optex.encode and optex.decode spans (the stage roundtrips' codec, with the widen and the cast back) per image of the traced calls."""

from benchlib import spans


def read(ctx):
    return spans.ms_per_image(ctx, ("optex.encode", "optex.decode"))
