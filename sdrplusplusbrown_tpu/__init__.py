"""sdrplusplusbrown_tpu — a JAX SDR signal-processing framework.

A from-scratch JAX/XLA re-design of the capabilities of SDR++Brown
(reference surveyed in SURVEY.md).  Instead of the reference's
thread-per-block C++ pipeline (reference: core/src/dsp/block.h,
core/src/dsp/stream.h), every DSP stage is a pure function over fixed-size
sample blocks with explicit carried state:

    y, new_state = block.apply(params, state, x)

where ``x`` is a ``[..., T]`` array (leading axes are batched VFO channels)
and ``state`` is a pytree (filter tails, NCO phases, AGC envelopes, noise
histories).  Pipelines compose blocks into a single ``jit``-compiled program
per configuration; reconfiguration (demod switch, bandwidth change) builds a
new compiled callable and migrates state — the functional equivalent of the
reference's tempStop/re-splice/tempStart protocol
(reference: core/src/dsp/chain.h).

Packages:
  ops      — DSP kernels (FIR, resampler, NCO, demodulators, NR, spectrum)
  models   — composed pipelines (RxVFO, RadioModule, IQFrontEnd, channelizer)
  parallel — multi-chip sharding (channel-sharded and time-sharded w/ halos)
  runtime  — block protocol, chains, host streaming pump
  io       — WAV IQ sources and sinks
  server   — HTTP automation plane and streaming protocol analog
  utils    — config manager, logging
"""

__version__ = "0.1.0"
