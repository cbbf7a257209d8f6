"""WFM broadcast stereo demodulator with 19 kHz pilot recovery and RDS tap.

reference: core/src/dsp/demod/broadcast_fm.h:35-215.  Signal flow (stereo):

    quadrature FM ──┬── lprDelay ────────────────────────────┐  L=(L+R)+(L−R)
                    └ r→c ─┬─ pilot BPF ─ PLL ─ conj ──┐      ├─ 15 kHz FIRs
                           └ lmrDelay ───────── ×pll² ─┴ 2·re ┘  R=(L+R)−(L−R)
                           └ xlate −57 kHz ─ resample → 5 kHz RDS out

Constants (reference broadcast_fm.h:43-53): pilot band-pass 18750–19250 Hz
(trans 3 kHz, odd taps, complex); PLL bandwidth 25000/fs, init 19 kHz, limits
18750–19250 Hz; delays (pilotTaps−1)/2 + 1; audio low-pass 15 kHz trans 4 kHz;
RDS xlate −57 kHz → 5 kHz.

Pilot recovery has two modes:
  * ``pll_mode="scan"`` — exact reference PLL via lax.scan.
  * ``pll_mode="normalize"`` (default) — p/|p| of the band-passed pilot,
    delayed one sample to match the PLL's one-sample output lag; fully
    parallel (no per-sample dependency anywhere in the WFM chain).

MPX-rate decimation (a redesign, not in the reference): the composite
MPX signal occupies at most 59.4 kHz (RDS 57k±2.4k; 53 kHz without RDS),
but the reference runs the whole stereo section at the 500 kHz IF rate
(broadcast_fm.h:144-215).  Every stage here is a device-memory pass, so
the real MPX is decimated by ``mpx_decim`` (cascaded protecting halfbands) right
after the discriminator; the pilot/stereo/RDS/audio stages then run at
``samplerate/mpx_decim`` — identical math at identical relative
frequencies, a fraction of the bytes.  Audio leaves at the decimated
rate (``out_samplerate``, ``ratio``); the Radio's AF resampler absorbs
the rate change.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import jax.numpy as jnp

from ..runtime.block import Block
from . import taps as taps_mod
from .fir import FIR, RealFIR
from .demod import Quadrature
from .pll import PLL, pilot_normalize
from .delay import Delay
from .xlator import FrequencyXlator
from .resampler import (RationalResampler, PolyphaseResampler,
                        design_halfband_stage)


class BroadcastFM(Block):
    def __init__(self, deviation: float, samplerate: float,
                 stereo: bool = True, low_pass: bool = True,
                 rds_out: bool = False, pll_mode: str = "normalize",
                 mpx_decim: int = 4,
                 audio_rate: float | None = None):
        self.samplerate = float(samplerate)
        self.stereo = stereo
        self.low_pass = low_pass
        self.rds_out = rds_out
        self.pll_mode = pll_mode

        self.quad = Quadrature(deviation, samplerate)

        # protected MPX band: RDS top 57k+2.4k, else L−R top 38k+15k
        protect = 59500.0 if rds_out else 53500.0
        mpx_decim = int(mpx_decim)
        assert mpx_decim >= 1 and (mpx_decim & (mpx_decim - 1)) == 0
        # each halfband stage needs fs_in/2 − protect > protect
        while mpx_decim > 1 and samplerate / mpx_decim <= 2.0 * protect * 1.02:
            mpx_decim //= 2
        self.mpx_decim = mpx_decim
        self.mpx_stages = []
        fs = self.samplerate
        d = mpx_decim
        while d > 1:
            self.mpx_stages.append(RealFIR(design_halfband_stage(
                fs, protect).astype(np.float32), decim=2))
            fs /= 2.0
            d //= 2
        fsm = fs  # MPX processing rate

        self.pilot_taps = taps_mod.band_pass_complex(
            18750.0, 19250.0, 3000.0, fsm, odd_tap_count=True)
        self.pilot_fir = FIR(self.pilot_taps)
        w19 = taps_mod.hz_to_rads(19000.0, fsm)
        # band_pass_complex modulates by exp(-j*w0*(t-half)) (the
        # reference's convention, taps/band_pass.h), so the filtered pilot
        # carries a constant phase offset w0*count/2 on top of the linear
        # group delay.  Squaring doubles it into the recovered 38 kHz
        # carrier: cos(2*w0*count/2) separation loss (~0.3 rad at 500 kHz,
        # ~1.06 rad at 125 kHz).  Cancel the known constant.
        self.pilot_phase_corr = complex(
            np.exp(-1j * w19 * (len(self.pilot_taps) / 2.0)))
        self.pll = PLL(25000.0 / fsm, init_freq=w19,
                       min_freq=taps_mod.hz_to_rads(18750.0, fsm),
                       max_freq=taps_mod.hz_to_rads(19250.0, fsm))
        d = (len(self.pilot_taps) - 1) // 2 + 1
        self.lpr_delay = Delay(d)
        self.lmr_delay = Delay(d)
        self.pilot_lag = Delay(1)  # normalize-mode stand-in for PLL lag
        # Audio low-pass: the 15 kHz LP is also a valid anti-alias for
        # any audio rate >= 38 kHz, so when ``audio_rate`` is rationally
        # related to the MPX rate the LP and the radio's AF resampler
        # MERGE into one polyphase stage straight to the audio rate —
        # one pass instead of three (15 kHz FIR + halfband + 96/125
        # polyphase).
        self.audio_fir = None
        self.audio_poly = None
        self.in_multiple = self.mpx_decim
        if (audio_rate and low_pass and audio_rate != fsm
                and audio_rate >= 2.0 * 19000.0
                and float(audio_rate).is_integer() and fsm.is_integer()):
            from math import gcd
            ai, fi = int(audio_rate), int(fsm)
            g = gcd(ai, fi)
            interp, decim = ai // g, fi // g
            proto = taps_mod.low_pass(15000.0, 4000.0,
                                      fsm * interp) * interp
            self.audio_poly = PolyphaseResampler(interp, decim, proto)
            self.in_multiple = self.mpx_decim * decim
            self.out_samplerate = float(audio_rate)
            self.ratio = Fraction(1, self.mpx_decim) \
                * Fraction(interp, decim)
        else:
            if low_pass:
                self.audio_taps = taps_mod.low_pass(15000.0, 4000.0, fsm)
                self.audio_fir = RealFIR(self.audio_taps)  # stacked L/R
            self.out_samplerate = fsm
            self.ratio = Fraction(1, self.mpx_decim)
        if rds_out:
            self.rds_xlator = FrequencyXlator(-57000.0, fsm)
            self.rds_resamp = RationalResampler(fsm, 5000.0)
            self.in_multiple = int(np.lcm(
                self.in_multiple,
                self.mpx_decim * self.rds_resamp.in_multiple))
        self.out_channels = 2

    def init_state(self, batch_shape=()):
        st = {
            "quad": self.quad.init_state(batch_shape),
            "mpx_decim": [s.init_state(batch_shape, jnp.float32)
                          for s in self.mpx_stages],
            "pilot_fir": self.pilot_fir.init_state(batch_shape),
            "pll": self.pll.init_state(batch_shape),
            "pilot_lag": self.pilot_lag.init_state(batch_shape, jnp.complex64),
            "lpr_delay": self.lpr_delay.init_state(batch_shape, jnp.float32),
            "lmr_delay": self.lmr_delay.init_state(batch_shape, jnp.complex64),
        }
        if self.audio_fir is not None:
            st["audio_fir"] = self.audio_fir.init_state(batch_shape + (2,))
        if self.audio_poly is not None:
            st["audio_rs"] = self.audio_poly.init_state(
                (2,) + batch_shape, jnp.float32)
        if self.rds_out:
            st["rds_xl"] = self.rds_xlator.init_state(batch_shape)
            st["rds_rs"] = self.rds_resamp.init_state(batch_shape)
        return st

    def _stereo_section(self, state, st, mpx):
        """MPX → (L, R) planes [2, ..., T] at the MPX rate."""
        mpx_c = mpx.astype(jnp.complex64)
        pilot, st["pilot_fir"] = self.pilot_fir.apply(
            None, state["pilot_fir"], mpx_c)
        if self.pll_mode == "scan":
            vco, st["pll"] = self.pll.apply(None, state["pll"], pilot)
        else:
            vco = pilot_normalize(pilot)
            vco, st["pilot_lag"] = self.pilot_lag.apply(
                None, state["pilot_lag"], vco)
        vco = vco * jnp.complex64(self.pilot_phase_corr)
        lpr, st["lpr_delay"] = self.lpr_delay.apply(
            None, state["lpr_delay"], mpx)
        lmr_c, st["lmr_delay"] = self.lmr_delay.apply(
            None, state["lmr_delay"], mpx_c)
        # conjugate VCO squared downconverts the 38 kHz L−R subcarrier
        vco2 = jnp.conj(vco)
        lmr_c = lmr_c * vco2 * vco2
        lmr = jnp.real(lmr_c) * 2.0
        return jnp.stack([lpr + lmr, lpr - lmr], axis=0)  # [2, ..., T]

    def _audio_out(self, state, st, lr2):
        """[2, ..., T]@MPX-rate → [..., 2, T'] audio (poly/FIR/raw)."""
        if self.audio_poly is not None:
            lr2, st["audio_rs"] = self.audio_poly.apply(
                None, state["audio_rs"], lr2)
        elif self.audio_fir is not None:
            lr = jnp.moveaxis(lr2, 0, -2)
            lr, st["audio_fir"] = self.audio_fir.apply(
                None, state["audio_fir"], lr)
            return lr
        return jnp.moveaxis(lr2, 0, -2)

    def apply_planes(self, params, state, planes):
        """Like apply(), but the IF arrives as (re, im) float32 planes
        from the shared front end — the discriminator consumes them
        directly (ops/demod.py Quadrature.apply_planes), so the complex
        IF array is never built."""
        xr, xi = planes
        st = dict(state)
        mpx, st["quad"] = self.quad.apply_planes(state["quad"], xr, xi)
        return self._after_quad(params, state, st, mpx)

    def apply(self, params, state, x):
        st = dict(state)
        mpx, st["quad"] = self.quad.apply(None, state["quad"], x)
        return self._after_quad(params, state, st, mpx)

    def _after_quad(self, params, state, st, mpx):
        mpx_states = []
        for stage, sst in zip(self.mpx_stages, state["mpx_decim"]):
            mpx, nst = stage.apply(None, sst, mpx)
            mpx_states.append(nst)
        st["mpx_decim"] = mpx_states

        rds = None
        if self.rds_out:
            mpx_c = mpx.astype(jnp.complex64)
            rds_bb, st["rds_xl"] = self.rds_xlator.apply(
                None, state["rds_xl"], mpx_c)
            rds, st["rds_rs"] = self.rds_resamp.apply(
                None, state["rds_rs"], rds_bb)
        if self.stereo:
            lr2 = self._stereo_section(state, st, mpx)
        else:
            lr2 = jnp.stack([mpx, mpx], axis=0)
        lr = self._audio_out(state, st, lr2) if self.low_pass \
            or self.audio_poly is not None \
            else jnp.moveaxis(lr2, 0, -2)
        if self.rds_out:
            return (lr, rds), st
        return lr, st
