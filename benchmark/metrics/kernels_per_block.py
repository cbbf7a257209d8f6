"""Device operations launched per traced block: the launch overhead of
per-sample ``lax.scan`` loops and of per-radio chains."""


def read(ctx):
    red = ctx["trace"]
    if red is None or red["n_ops"] == 0:
        return None
    return red["n_ops"] / red["blocks"]
