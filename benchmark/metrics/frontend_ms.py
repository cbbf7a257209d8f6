"""Mean host time per window block from the ``pump_step`` call to the
app's ``baseband_event``: source read, rechunking, the IQ front end and
spectrum step, the baseband and spectrum fetch, the waterfall push."""

import numpy as np


def read(ctx):
    return float(np.mean(ctx["frontend_s"])) * 1e3
