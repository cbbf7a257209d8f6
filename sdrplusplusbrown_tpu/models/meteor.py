"""Meteor-M LRPT demodulator — (O)QPSK at 72k/80k sym/s on a 150 kHz
channel, emitting soft symbols for an external LRPT decoder.

reference: decoder_modules/meteor_demodulator/src/meteor_demod.h:150-167 —
RRC(33 taps, β=0.6) → FastAGC(rate 0.1) → MeteorCostas(bw 0.005, optional
"broken modulation" 4-phase detector, meteor_costas.h:33-56) → optional
OQPSK one-sample Q delay → M&M clock recovery (ωgain 1e-6, µgain 0.01).
main.cpp:199-202 writes soft symbols as interleaved int8 re/im, scaled by
84 and clamped to ±127.

Vectorized redesign: RRC/AGC are batched tensor ops; the two sequential loops
(Costas, M&M) are `lax.scan`s.  The whole demod is one jittable block.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..runtime.block import Block
from ..ops import taps as taps_mod
from ..ops.agc import AGC
from ..ops.costas import Costas
from ..ops.fir import FIR
from ..ops.clock_recovery import MMClockRecovery

METEOR_IN_SR = 150_000.0       # reference main.cpp:40

# reference meteor_costas.h:36-39 (behavioral constants of the MeteorM2-x
# "broken" modulator's asymmetric constellation)
BROKEN_PHASES = (0.47439988279190737, 2.1777839908413044,
                 3.8682349942715186, -0.29067248091319986)


def broken_modulation_error(v):
    """Nearest-of-four-phases detector (meteor_costas.h:33-51)."""
    phase = jnp.arctan2(jnp.imag(v), jnp.real(v))
    amp = jnp.abs(v)
    best = None
    for p in BROKEN_PHASES:
        dp = jnp.mod(phase - p + np.pi, 2.0 * np.pi) - np.pi
        best = dp if best is None else jnp.where(
            jnp.abs(dp) < jnp.abs(best), dp, best)
    return best * amp


class MeteorDemod(Block):
    """complex 150 kHz baseband → (soft symbols, valid)."""

    def __init__(self, symbolrate: float = 72_000.0,
                 samplerate: float = METEOR_IN_SR,
                 rrc_tap_count: int = 33, rrc_beta: float = 0.6,
                 agc_rate: float = 0.1, costas_bandwidth: float = 0.005,
                 broken_modulation: bool = False, oqpsk: bool = False,
                 omega_gain: float = 1e-6, mu_gain: float = 0.01,
                 omega_rel_limit: float = 0.01):
        self.symbolrate = float(symbolrate)
        self.samplerate = float(samplerate)
        self.oqpsk = bool(oqpsk)
        self.broken = bool(broken_modulation)
        self.rrc = FIR(taps_mod.root_raised_cosine(
            rrc_tap_count, rrc_beta, samplerate / symbolrate))
        self.agc = AGC(set_point=1.0, attack=agc_rate, decay=agc_rate,
                       max_gain=10e6)
        self.costas = Costas(
            4, costas_bandwidth,
            error_fn=broken_modulation_error if broken_modulation else None)
        self.recov = MMClockRecovery(samplerate / symbolrate, omega_gain,
                                     mu_gain, omega_rel_limit,
                                     complex_data=True)

    def init_state(self, batch_shape=()):
        assert batch_shape == ()
        st = {"rrc": self.rrc.init_state(()),
              "agc": self.agc.init_state(()),
              "costas": self.costas.init_state(()),
              "recov": self.recov.init_state(())}
        if self.oqpsk:
            st["last_q"] = jnp.zeros((), jnp.float32)
        return st

    def apply(self, params, state, x):
        st = dict(state)
        y, st["rrc"] = self.rrc.apply(None, state["rrc"], x)
        y, st["agc"] = self.agc.apply(None, state["agc"], y)
        y, st["costas"] = self.costas.apply(None, state["costas"], y)
        if self.oqpsk:
            # one-sample Q delay + deinterleave (meteor_demod.h:155-164)
            q = jnp.imag(y)
            qd = jnp.concatenate([state["last_q"][None], q[:-1]])
            st["last_q"] = q[-1]
            y = jnp.real(y) + 1j * qd
        (sym, valid), st["recov"] = self.recov.apply(None, state["recov"],
                                                     y)
        return (sym, valid), st


def soft_to_int8(sym: np.ndarray) -> np.ndarray:
    """Interleaved int8 re/im, ×84, clamped (reference main.cpp:199-202)."""
    out = np.empty(sym.size * 2, np.int8)
    out[0::2] = np.clip(np.round(sym.real * 84.0), -127, 127)
    out[1::2] = np.clip(np.round(sym.imag * 84.0), -127, 127)
    return out
