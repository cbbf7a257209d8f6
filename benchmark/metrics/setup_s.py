"""Process start to the first timed block: JAX and CUDA start-up,
capture synthesis, app and radio construction, compilation or cache
loads, and the warm-up blocks."""


def read(ctx):
    return ctx["setup_s"]
