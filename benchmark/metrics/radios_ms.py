"""Mean host time per window block from the app's ``baseband_event`` to
the return of ``pump_step``: every radio's jitted step, its audio fetch
and the sink layer."""

import numpy as np


def read(ctx):
    return float(np.mean(ctx["radios_s"])) * 1e3
