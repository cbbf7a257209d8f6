"""Shared definition of the 256-channel scanner workload (BASELINE
config 5) so the 2-process workers and the single-process baseline run
byte-identical programs.

The workload is the PRODUCTION architecture — the channelized PFB front
end (parallel/chan_time.py), not the chained per-channel pipeline."""

import numpy as np

from sdrplusplusbrown_tpu.models.radio import DEMOD_NFM
from sdrplusplusbrown_tpu.parallel.chan_time import (
    ShardedChannelizedPipeline)

FS = 2_400_000.0


def make_workload(mesh, C=256, target_t_local=144_000):
    """→ (pipe, offsets, wideband x[t_global])  — deterministic."""
    from sdrplusplusbrown_tpu.models.radio import Radio
    radio = Radio(FS, DEMOD_NFM, squelch_enabled=True,
                  pll_mode="normalize")
    g = ShardedChannelizedPipeline.granularity(radio)
    t_local = ((target_t_local + g - 1) // g) * g
    pipe = ShardedChannelizedPipeline(FS, mesh, C, t_local, DEMOD_NFM,
                                      squelch_enabled=True)
    offsets = np.linspace(-1.1e6, 1.1e6, C) + 917.0
    rng = np.random.default_rng(123)
    T = pipe.t_global
    n = np.arange(T)
    x = np.zeros(T, np.complex128)
    for off in offsets[:: max(C // 8, 1)]:      # 8 live carriers
        tone = 0.5 * np.sin(2 * np.pi * 800.0 * n / FS)
        ph = 2 * np.pi * np.cumsum(2500 * tone) / FS
        x += np.exp(1j * (ph + 2 * np.pi * off * n / FS))
    x = (x / 8 + 0.01 * (rng.standard_normal(T)
                         + 1j * rng.standard_normal(T))
         ).astype(np.complex64)
    return pipe, offsets, x
