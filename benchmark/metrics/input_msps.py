"""Input samples pumped in the window over the window's wall time, in
millions per second: the capture rate one card keeps up with."""


def read(ctx):
    return ctx["samples"] / ctx["window_s"] / 1e6
