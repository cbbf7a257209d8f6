"""Fused mix-down: fold the per-channel NCO into the first decimating
FIR's taps so the SHARED wideband is read once.

The plain path materializes, per channel, a full-rate rotor table and a
rotated copy of the wideband before the first halfband stage — at C=8 ×
2.4 MS/s that is ~300 MB of device-memory traffic per 0.1 s block.
Algebra:

    y_c[m] = Σ_k rot_c[mD+k−(K−1)]·x[mD+k−(K−1)]·h[k]
           = e^{j(φ_c + ω_c(mD−(K−1)))} · Σ_k x_ext[mD+k]·h[k]e^{jω_c k}

so with channel-modulated taps g_c[k] = h[k]·e^{jω_c k} the inner sum is
one strided convolution of the UNBROADCAST wideband with C complex
output channels (C·2 output features), and the
NCO survives only as a twiddle at the DECIMATED rate.  Bytes go from
O(C·T) to O(T + C·T/D) for the front stage.

Exactness: identical math to FrequencyXlator→FIR(decim) up to fp32
reassociation (tested ≥100 dB against the unfused path).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..runtime.block import Block
from .xlator import rotor, advance_phase, _TWO_PI

_DN = jax.lax.conv_dimension_numbers((1, 2, 8), (2, 2, 1),
                                     ("NCW", "OIW", "NCW"))


def fused_params(offset_hz, samplerate: float, decim: int) -> dict:
    """Host-float64 runtime params for the fused stage: full-rate omega
    (tap modulation) + decimated-rate NCO factors (twiddle)."""
    from .xlator import SPAN
    omega = -np.asarray(offset_hz, np.float64) * (_TWO_PI / samplerate)
    om_d = omega * decim
    return {
        "omega": jnp.asarray(omega, jnp.float32),
        "omega_span": jnp.asarray(np.mod(omega * SPAN, _TWO_PI),
                                  jnp.float32),
        "omega_dec": jnp.asarray(np.mod(om_d + np.pi, _TWO_PI) - np.pi,
                                 jnp.float32),
        "omega_dec_span": jnp.asarray(np.mod(om_d * SPAN, _TWO_PI),
                                      jnp.float32),
    }


class SharedXlateDecimFIR(Block):
    """x[T] shared complex → y[C, T/decim] complex, per-channel ω.

    Equivalent to (FrequencyXlator(ω_c) → FIR(taps, decim)) applied to a
    C-broadcast copy of x, with the overlap-save tail shared (it is the
    RAW wideband tail, identical for every channel) and the per-channel
    NCO phase the only per-channel state.
    """

    def __init__(self, taps: np.ndarray, samplerate: float,
                 decim: int):
        self.taps = np.asarray(taps, np.float64)
        self.K = len(self.taps)
        self.samplerate = float(samplerate)
        self.decim = int(decim)
        from fractions import Fraction
        self.ratio = Fraction(1, self.decim)
        self.in_multiple = self.decim

    def init_state(self, batch_shape=()):
        # batch_shape = (C,); the tail is shared (raw wideband), the
        # per-channel NCO phase is the only per-channel state
        (C,) = batch_shape
        return {"tail": jnp.zeros((self.K - 1,), jnp.complex64),
                "phase": jnp.zeros((C,), jnp.float32)}

    def apply(self, params, state, x):
        assert x.ndim == 1, "shared wideband input"
        T = x.shape[-1]
        D, K = self.decim, self.K
        C = params["omega"].shape[0]
        omega = params["omega"]                      # [C]
        ext = jnp.concatenate([state["tail"], x])    # [T + K - 1]

        # channel-modulated taps g_c[k] = h[k]·e^{jω_c k}  (tiny)
        k = jnp.arange(K, dtype=jnp.float32)
        ang = omega[:, None] * k[None, :]
        h = jnp.asarray(self.taps, jnp.float32)[None, :]
        gr = h * jnp.cos(ang)
        gi = h * jnp.sin(ang)

        # one strided conv of the shared wideband: features (re, im),
        # outputs (re_c, im_c) interleaved
        xf = jnp.stack([jnp.real(ext), jnp.imag(ext)])[None]
        kern = jnp.zeros((2 * C, 2, K), jnp.float32)
        kern = kern.at[0::2, 0].set(gr).at[0::2, 1].set(-gi)
        kern = kern.at[1::2, 0].set(gi).at[1::2, 1].set(gr)
        y = jax.lax.conv_general_dilated(
            xf, kern, window_strides=(D,), padding="VALID",
            dimension_numbers=_DN,
            preferred_element_type=jnp.float32)[0]       # [2C, M]
        pre = jax.lax.complex(y[0::2], y[1::2])          # [C, M]

        # decimated-rate twiddle e^{j(φ_c − ω_c(K−1) + ω_c D·m)}
        M = pre.shape[-1]
        phase0 = jnp.mod(state["phase"] - omega * jnp.float32(K - 1)
                         + np.pi, _TWO_PI) - np.pi
        tw = rotor(phase0, params["omega_dec"],
                   params["omega_dec_span"], M)
        out = pre * tw

        new_phase = advance_phase(state["phase"], params["omega"],
                                  params["omega_span"], T)
        return out, {"tail": ext[T:],
                     "phase": jnp.broadcast_to(new_phase, (C,))}
