"""95th percentile over all blocks of the window of the wall time of one
``pump_step``: from pulling the block to the return, when every radio's
audio for it has reached its sink stream."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx["block_s"], 95)) * 1e3
