"""Frames of the sequences finished in the window over the window's whole
wall (frames/s)."""


def read(ctx):
    return ctx["frames"] / ctx["window_s"]
