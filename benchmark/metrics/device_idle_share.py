"""Share of the traced window in which no operation ran on the device,
in percent (union of device-operation intervals, benchmark/trace.py)."""


def read(ctx):
    red = ctx["trace"]
    if red is None or red["n_ops"] == 0:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])
