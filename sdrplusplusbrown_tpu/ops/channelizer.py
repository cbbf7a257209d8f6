"""Critically-sampled polyphase filter-bank channelizer.

BASELINE config 4: "FT8 band channelizer: 10 MS/s wideband → 64 polyphase
channels → FFT spectra".  The reference achieves multi-channel receive by
running N independent RxVFO chains (xlate → resample each,
reference: core/src/dsp/channel/rx_vfo.h); for a regular channel grid the
PFB computes all M channels for the cost of ~one filter: polyphase-
decompose the input, one batched branch FIR, and an FFT across the
branch axis.

    x_p[k] = x[kM + p]                      (polyphase decompose)
    v_p    = h_p ⊛ x_p ,  h_p[j] = h[jM+p]  (branch FIR, batched over p)
    y_m[k] = Σ_p v_p[k] · e^{-j2πmp/M}      (FFT over p)

Channel m sits at center +m·fs/M (wrapping to negative beyond M/2) at
rate fs/M.  The prototype is the framework's standard windowed-sinc
lowpass with cutoff fs/(2M).
"""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..runtime.block import Block
from . import taps as taps_mod


class PolyphaseChannelizer(Block):
    def __init__(self, samplerate: float, n_channels: int,
                 trans_frac: float = 0.2, atten_taps: int | None = None):
        self.samplerate = float(samplerate)
        self.M = int(n_channels)
        ch_bw = self.samplerate / self.M
        proto = taps_mod.low_pass(ch_bw / 2.0, ch_bw * trans_frac,
                                  self.samplerate)
        # pad prototype to a multiple of M
        K = proto.shape[0]
        tpp = -(-K // self.M)
        proto = np.pad(proto, (0, tpp * self.M - K))
        # h_p[j] = h[j*M + p] → [M, tpp]
        self.branches = proto.reshape(tpp, self.M).T.copy()
        self.tpp = tpp
        self.ratio = Fraction(1, 1)    # emits [M, T/M]: samples conserved
        self.in_multiple = self.M

    def channel_freqs(self) -> np.ndarray:
        """Center frequency (Hz) of each output channel."""
        m = np.arange(self.M)
        m = np.where(m <= self.M // 2, m, m - self.M)
        return m * self.samplerate / self.M

    def init_state(self, batch_shape=()):
        return jnp.zeros(batch_shape + (self.M, self.tpp - 1), jnp.complex64)

    def apply(self, params, state, x):
        """x [..., T] → y [..., M, T/M] (channels × channel-rate time)."""
        T = x.shape[-1]
        assert T % self.M == 0, (T, self.M)
        k = T // self.M
        # [..., k, M] → [..., M, k]
        xp = jnp.moveaxis(x.reshape(x.shape[:-1] + (k, self.M)), -1, -2)
        state = state.astype(x.dtype) if state.dtype != x.dtype else state
        ext = jnp.concatenate([state, xp], axis=-1)
        # batched branch FIR: independent taps per branch → grouped conv
        v = _branch_fir(ext, jnp.asarray(self.branches, jnp.float32))
        new_state = ext[..., ext.shape[-1] - (self.tpp - 1):]
        y = jnp.fft.fft(v, axis=-2)
        return y, new_state


class OversampledChannelizer(Block):
    """2×-oversampled polyphase channelizer: M bins spaced fs/M, each
    emitted at rate 2·fs/M (frame hop D = M/2).

    This is the wide-batch answer to per-channel mix-then-decimate
    (the reference runs one RxVFO chain per channel,
    core/src/dsp/channel/rx_vfo.h:89-121, which is O(C·T) at the full
    input rate): the whole band is filtered once and all M bins fall out
    of one FFT, O(T·taps_per_phase + T·log M).  The 2× oversampling
    leaves each bin alias-free over ±fs/M, so a channel at an
    *arbitrary* frequency can be serviced by its nearest bin plus a
    residual fine-shift at the decimated rate (ChannelizedRxVFOBank).

    Implementation: two critically-sampled branch-FIR passes.  Even
    frames (positions k·M) are the plain pass; odd frames (k·M − M/2)
    run on the input delayed by M/2, and their phase-continuity twiddle
    e^{-j2πb(M/2)/M} = (−1)^b is applied for free as a circular roll of
    the branch axis before the FFT (FFT(roll(v, M/2))_b = (−1)^b·FFT(v)_b).

    The prototype filter is caller-supplied: its passband must cover the
    worst-case residual shift (±fs/2M) plus the channel half-bandwidth,
    and its stopband must start by 2·fs/M − that edge (alias protection
    at the 2·fs/M bin rate).
    """

    def __init__(self, samplerate: float, n_channels: int,
                 proto_taps: np.ndarray):
        self.samplerate = float(samplerate)
        M = int(n_channels)
        if M % 2:
            raise ValueError(f"OversampledChannelizer: M={M} must be even")
        self.M = M
        proto = np.asarray(proto_taps, np.float64)
        K = proto.shape[0]
        tpp = -(-K // M)
        proto = np.pad(proto, (0, tpp * M - K))
        self.branches = proto.reshape(tpp, M).T.copy()
        self.tpp = tpp
        self.ratio = Fraction(2, M)       # per-bin samples per input sample
        self.in_multiple = M

    def channel_freqs(self) -> np.ndarray:
        m = np.arange(self.M)
        m = np.where(m <= self.M // 2, m, m - self.M)
        return m * self.samplerate / self.M

    def init_state(self, batch_shape=()):
        z = jnp.zeros(batch_shape + (self.M, self.tpp - 1), jnp.complex64)
        return {"tail_a": z, "tail_b": z,
                "delay": jnp.zeros(batch_shape + (self.M // 2,),
                                   jnp.complex64)}

    @property
    def halo_len(self) -> int:
        """Input samples that fully determine the streaming state: the
        state after apply(x) is a pure function of x's last ``halo_len``
        samples — the time-sharding rule (parallel/chan_time.py)."""
        return (self.tpp - 1) * self.M + self.M // 2

    def state_from_tail(self, x_tail: jnp.ndarray) -> dict:
        """Reconstruct the streaming state from the last ``halo_len``
        raw input samples (shape [..., halo_len]); equals the state
        apply() would have produced after consuming a block ending in
        exactly these samples."""
        M, tpp = self.M, self.tpp
        h = self.halo_len
        assert x_tail.shape[-1] == h, (x_tail.shape, h)
        lead = x_tail.shape[:-1]
        n = (tpp - 1) * M
        x_tail = x_tail.astype(jnp.complex64)
        dec = lambda seg: jnp.moveaxis(
            seg.reshape(lead + (tpp - 1, M)), -1, -2)
        return {"tail_a": dec(x_tail[..., M // 2:]),
                "tail_b": dec(x_tail[..., :n]),
                "delay": x_tail[..., h - M // 2:]}

    def _cs_pass(self, tail, x):
        """Critically-sampled branch FIR (pre-FFT): [..., T] → [..., M, k]."""
        T = x.shape[-1]
        k = T // self.M
        xp = jnp.moveaxis(x.reshape(x.shape[:-1] + (k, self.M)), -1, -2)
        tail = tail.astype(x.dtype) if tail.dtype != x.dtype else tail
        ext = jnp.concatenate([tail, xp], axis=-1)
        v = _branch_fir(ext, jnp.asarray(self.branches, jnp.float32))
        return v, ext[..., ext.shape[-1] - (self.tpp - 1):]

    def apply(self, params, state, x):
        """x [..., T] → y [..., M, 2T/M] (bins × 2×-oversampled frames)."""
        T = x.shape[-1]
        assert T % self.M == 0, (T, self.M)
        half = self.M // 2
        va, tail_a = self._cs_pass(state["tail_a"], x)
        xd = jnp.concatenate(
            [state["delay"].astype(x.dtype), x[..., :T - half]], axis=-1)
        vb, tail_b = self._cs_pass(state["tail_b"], xd)
        ya = jnp.fft.fft(va, axis=-2)
        yb = jnp.fft.fft(jnp.roll(vb, half, axis=-2), axis=-2)
        # odd (delayed) frames sit half a hop EARLIER: interleave [B, A]
        y = jnp.stack([yb, ya], axis=-1)
        y = y.reshape(y.shape[:-2] + (2 * ya.shape[-1],))
        return y, {"tail_a": tail_a, "tail_b": tail_b,
                   "delay": x[..., T - half:]}


def _branch_fir(ext: jnp.ndarray, branches: jnp.ndarray) -> jnp.ndarray:
    """Per-branch real-tap FIR on complex data.

    ext: [..., M, k + tpp - 1] complex; branches: [M, tpp] float32.
    Returns [..., M, k].

    Lowering note: per-branch taps would be a grouped conv with M groups
    of one channel each.  With tpp small (≤ a few dozen) the tap-shifted
    sum below fuses into one elementwise pass over ``ext`` instead.
    """
    M, tpp = branches.shape
    k = ext.shape[-1] - (tpp - 1)
    er = jnp.real(ext).astype(jnp.float32)
    ei = jnp.imag(ext).astype(jnp.float32)
    b = branches.reshape((1,) * (ext.ndim - 2) + (M, tpp))
    yr = jnp.zeros(ext.shape[:-1] + (k,), jnp.float32)
    yi = jnp.zeros_like(yr)
    # y[.., m, t] = Σ_i b[m, i] · ext[.., m, t + i] — XLA conv is
    # cross-correlation (kernel unflipped), so window index i pairs
    # tap i, matching the previous grouped-conv lowering exactly.
    for i in range(tpp):
        g = b[..., i:i + 1]
        yr = yr + _sl(er, i, k) * g
        yi = yi + _sl(ei, i, k) * g
    return jax.lax.complex(yr, yi)


def _sl(a: jnp.ndarray, i: int, k: int) -> jnp.ndarray:
    return jax.lax.slice_in_dim(a, i, i + k, axis=-1)
