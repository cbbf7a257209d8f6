"""Device busy time (union of operation intervals) per traced block, in
milliseconds."""


def read(ctx):
    red = ctx["trace"]
    if red is None or red["n_ops"] == 0:
        return None
    return red["busy_s"] / red["blocks"] * 1e3
