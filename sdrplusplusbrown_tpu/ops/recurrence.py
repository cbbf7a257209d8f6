"""First-order recurrences as parallel (associative-scan) kernels.

The reference implements de-emphasis, DC blocking and the noise-blanker
envelope as per-sample sequential loops (reference:
core/src/dsp/filter/deephasis.h:14-80, correction/dc_blocker.h,
noise_reduction/noise_blanker.h:38-58).  All three are *first-order linear*
recurrences y[n] = a[n]*y[n-1] + b[n]; here we evaluate them in
O(log T) depth with ``jax.lax.associative_scan`` over affine-map composition
instead of a serial scan — data-parallel across the whole block and across
batched channels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..runtime.block import Block


def linear_recurrence(a, b, y0):
    """y[n] = a[n]*y[n-1] + b[n] along the last axis, y[-1] = y0.

    ``a`` may be a scalar (broadcast) or an array like ``b``.
    Returns the full y sequence.
    """
    b = jnp.asarray(b)
    a = jnp.broadcast_to(jnp.asarray(a, b.dtype), b.shape)

    def combine(left, right):
        a1, b1 = left
        a2, b2 = right
        return a1 * a2, b1 * a2 + b2

    A, B = jax.lax.associative_scan(combine, (a, b), axis=-1)
    return A * jnp.expand_dims(y0, -1) + B


class Deemphasis(Block):
    """1-pole de-emphasis IIR: y[n] = α x[n] + (1-α) y[n-1].

    α = dt/(τ+dt), τ ∈ {22µs, 50µs, 75µs}; applied to mono or stereo audio
    (stereo as an extra leading batch axis).
    reference: core/src/dsp/filter/deephasis.h:14-101.

    Lowering: at audio rates the pole r = 1-α decays below fp32
    resolution within a few dozen samples (r ≈ 0.71 at 48 kHz/50 µs), so
    the IIR is evaluated EXACTLY (to fp32) as a K-tap FIR over the
    zero-extended block plus an r^(n+1)·y0 head correction — one
    pass instead of the associative scan's O(log T) full-array sweeps.  The carried
    state stays the scalar y[-1], so checkpoints and the time-sharded
    affine-scan rule (parallel/stream_shard.py) are unchanged.  Poles
    too slow for a ≤512-tap horizon fall back to the scan.
    """

    _FIR_KMAX = 512

    def __init__(self, tau: float, samplerate: float):
        dt = 1.0 / float(samplerate)
        self.alpha = float(dt / (tau + dt))
        self.tau = tau
        self.samplerate = samplerate
        r = 1.0 - self.alpha
        # horizon: r^K < 2^-27 (an lsb-level tail on fp32 audio)
        K = int(np.ceil(-27.0 * np.log(2.0) / np.log(r))) if r > 0.0 else 1
        if K <= self._FIR_KMAX:
            self.fir_k = K
            h = self.alpha * np.power(np.float64(r), np.arange(K))
            # correlate() convention: out[i] = Σ_k ext[i+k]·taps[k]
            self._taps = h[::-1].astype(np.float32)
        else:
            self.fir_k = 0

    def impulse(self) -> np.ndarray:
        """Causal impulse response h[j] = α·(1−α)^j, length fir_k —
        the fold-into-resampler form (resampler.py:fold_output_fir)."""
        assert self.fir_k, "pole too slow for the FIR horizon"
        r = 1.0 - self.alpha
        return (self.alpha
                * np.power(np.float64(r), np.arange(self.fir_k)))

    def init_state(self, batch_shape=()):
        return jnp.zeros(batch_shape, jnp.float32)

    def _head_pow(self, T: int) -> np.ndarray:
        r = 1.0 - self.alpha
        pw = np.zeros(T, np.float32)
        n = min(self.fir_k, T)
        pw[:n] = np.power(np.float64(r), np.arange(1, n + 1))
        return pw

    def apply(self, params, state, x):
        if not self.fir_k:
            a = jnp.float32(1.0 - self.alpha)
            b = x * jnp.float32(self.alpha)
            y = linear_recurrence(a, b, state)
            return y, y[..., -1]
        from .fir import correlate
        T = x.shape[-1]
        K = self.fir_k
        ext = jnp.concatenate(
            [jnp.zeros(x.shape[:-1] + (K - 1,), x.dtype), x], axis=-1)
        y = correlate(ext, self._taps)
        y = y + jnp.asarray(self._head_pow(T)) * state[..., None]
        return y, y[..., -1]


class DCBlocker(Block):
    """Running-mean DC removal: out[n] = x[n] - o[n-1];
    o[n] = (1-rate) o[n-1] + rate x[n]   (reference:
    core/src/dsp/correction/dc_blocker.h — out[i] = in[i]-offset;
    offset += out[i]*rate).  Default rate 50/SR as wired by the IQ front end
    (reference: core/src/signal_path/iq_frontend.h:84-86)."""

    def __init__(self, rate: float):
        self.rate = float(rate)

    def init_state(self, batch_shape=(), dtype=jnp.complex64):
        return jnp.zeros(batch_shape, dtype)

    def apply(self, params, state, x):
        r = jnp.asarray(self.rate, jnp.float32)
        offs = linear_recurrence(1.0 - r, x * r, state)
        prev = jnp.concatenate(
            [jnp.expand_dims(state, -1), offs[..., :-1]], axis=-1)
        return x - prev, offs[..., -1]


class NoiseBlanker(Block):
    """Amplitude-ratio limiter against a running average envelope.

    amp[n] = (1-rate)·amp[n-1] + rate·|x[n]|  (linear ⇒ associative scan);
    gain = 1/excess where excess = |x|/amp > level, else 1.
    reference: core/src/dsp/noise_reduction/noise_blanker.h:38-58; the radio
    module instantiates it with rate=500/24000, level=10
    (reference: decoder_modules/radio/src/radio_module.h:92).
    """

    def __init__(self, rate: float = 500.0 / 24000.0, level: float = 10.0):
        self.rate = float(rate)
        self.default_level = float(level)

    def init_state(self, batch_shape=()):
        return jnp.ones(batch_shape, jnp.float32)

    def init_params(self):
        return {"level": jnp.float32(self.default_level)}

    def apply(self, params, state, x):
        level = params["level"] if params else jnp.float32(self.default_level)
        amp_in = jnp.abs(x).astype(jnp.float32)
        nz = amp_in != 0.0
        r = jnp.float32(self.rate)
        a = jnp.where(nz, 1.0 - r, 1.0)
        b = jnp.where(nz, amp_in * r, 0.0)
        amp = linear_recurrence(a, b, state)
        excess = jnp.where(nz, amp_in / amp, 1.0)
        gain = jnp.where(excess > level, 1.0 / excess, 1.0)
        return x * gain.astype(jnp.float32), amp[..., -1]
