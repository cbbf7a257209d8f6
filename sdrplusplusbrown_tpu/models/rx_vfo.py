"""RxVFO — the channelizer: translate → rational resample → bandwidth FIR.

reference: core/src/dsp/channel/rx_vfo.h:89-121 — xlator(-offset) →
RationalResampler(inSR→outSR) → optional low-pass when bandwidth != outSR
(cutoff = bw/2, trans = bw/2 · 0.1, designed at outSR; rx_vfo.h:117-121).

Batched: one RxVFO instance serves ``[C, T]`` blocks of C channels; the
offset is a runtime param (per-channel array) so hundreds of differently
tuned VFOs share one compiled program — the batched answer to the
reference's one-thread-per-VFO fan-out (reference: core/src/signal_path/
iq_frontend.cpp:159-179).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..runtime.block import Block
from ..ops import taps as taps_mod
from ..ops.fir import FIR
from ..ops.xlator import FrequencyXlator, nco_params
from ..ops.resampler import RationalResampler


class RxVFO(Block):
    def __init__(self, in_samplerate: float, out_samplerate: float,
                 bandwidth: float, offset_hz: float = 0.0):
        self.in_samplerate = float(in_samplerate)
        self.out_samplerate = float(out_samplerate)
        self.bandwidth = float(bandwidth)
        self.offset_hz = float(offset_hz)

        self.xlator = FrequencyXlator(-offset_hz, in_samplerate)
        self.resamp = RationalResampler(in_samplerate, out_samplerate)
        self.filter_needed = bandwidth != out_samplerate
        if self.filter_needed:
            fw = bandwidth / 2.0
            self.fir = FIR(taps_mod.low_pass(fw, fw * 0.1, out_samplerate))
        from fractions import Fraction
        self.ratio = self.resamp.ratio
        self.in_multiple = self.resamp.in_multiple

    def make_params(self, offset_hz):
        """Per-call retune; ``offset_hz`` may be per-channel (numpy array)."""
        return {"xl": nco_params(-np.asarray(offset_hz, np.float64),
                                 self.in_samplerate)}

    def init_params(self):
        return self.make_params(self.offset_hz)

    def init_state(self, batch_shape=()):
        st = {"xl": self.xlator.init_state(batch_shape),
              "rs": self.resamp.init_state(batch_shape)}
        if self.filter_needed:
            st["fir"] = self.fir.init_state(batch_shape)
        return st

    def apply(self, params, state, x):
        if params is None:
            params = self.init_params()
        st = dict(state)
        y, st["xl"] = self.xlator.apply(params["xl"], state["xl"], x)
        y, st["rs"] = self.resamp.apply(None, state["rs"], y)
        if self.filter_needed:
            y, st["fir"] = self.fir.apply(None, state["fir"], y)
        return y, st


class ChannelizedRxVFOBank(Block):
    """RxVFO bank over a SHARED wideband via a 2×-oversampled polyphase
    channelizer — the wide-C answer (scanners, monitoring banks).

    The fused front end (SharedRxVFOBank) still does O(C) work at the
    full input rate, so for wide banks the front end dominates the
    whole chain.  Here the band is split ONCE
    (O(taps) per wideband sample, independent of C); each channel then
    costs only a bin gather + residual NCO + 2:1 decimation at the
    decimated rate:

        wideband ──PFB(M bins @ 2·out_sr)──► gather nearest bin per
        channel ──rotate by Δ=offset−bin·out_sr──► halfband 2:1 ──►
        bandwidth FIR  (same design as RxVFO's, rx_vfo.h:117-121)

    Requires in_sr/out_sr = M an even integer and bandwidth < out_sr.
    Offsets (bin index + Δ rotor) are runtime params — retuning any
    channel is a new params pytree, no recompile.  Unlike
    SharedRxVFOBank this path is *signal-equivalent* rather than
    bit-near to the per-channel chain (different anti-alias filters),
    so tests assert demod-audio fidelity, not IF equality.
    """

    def __init__(self, in_samplerate: float, out_samplerate: float,
                 bandwidth: float):
        from ..ops.channelizer import OversampledChannelizer
        self.in_samplerate = float(in_samplerate)
        self.out_samplerate = float(out_samplerate)
        self.bandwidth = float(bandwidth)
        r = in_samplerate / out_samplerate
        M = int(round(r))
        if abs(r - M) > 1e-9 or M % 2:
            raise ValueError(
                f"ChannelizedRxVFOBank: in/out rate ratio {r} must be an "
                f"even integer")
        if not bandwidth < out_samplerate:
            raise ValueError(
                f"ChannelizedRxVFOBank: bandwidth {bandwidth} must be < "
                f"out rate {out_samplerate} (need transition room)")
        self.M = M
        # prototype: −6 dB at out_sr, passband down to out_sr/2 + bw/2
        # (worst-case residual shift + channel half-band), stopband from
        # 3/2·out_sr − bw/2 (alias edge at the 2·out_sr bin rate)
        proto = taps_mod.low_pass(out_samplerate,
                                  out_samplerate - bandwidth,
                                  in_samplerate)
        self.chz = OversampledChannelizer(in_samplerate, M, proto)
        self.fine = FrequencyXlator(0.0, 2.0 * out_samplerate)
        # 2:1 anti-alias: components at out_sr ± bw/2 fold into the
        # channel passband after decimation, so the stopband must start
        # by out_sr − bw/2 — transition (out_sr − bw)/2, NOT out_sr − bw
        # (which put the stopband edge past Nyquist and let ~50 kHz-
        # offset carriers alias into the audio band at −20 dB, tripping
        # the squelch on neighbouring channels)
        self.decim2 = FIR(taps_mod.low_pass(out_samplerate / 2.0,
                                            (out_samplerate - bandwidth)
                                            / 2.0,
                                            2.0 * out_samplerate), decim=2)
        self.filter_needed = bandwidth != out_samplerate
        if self.filter_needed:
            fw = bandwidth / 2.0
            self.fir = FIR(taps_mod.low_pass(fw, fw * 0.1, out_samplerate))
        from fractions import Fraction
        self.ratio = Fraction(1, M)
        self.in_multiple = M

    def make_params(self, offsets_hz):
        f = np.asarray(offsets_hz, np.float64)
        k = np.round(f / self.out_samplerate)
        delta = f - k * self.out_samplerate
        idx = np.mod(k.astype(np.int64), self.M).astype(np.int32)
        return {"bin": jnp.asarray(idx),
                "xl": nco_params(-delta, 2.0 * self.out_samplerate)}

    def init_state(self, C: int):
        st = {"chz": self.chz.init_state(),
              "xl": self.fine.init_state((C,)),
              "d2": self.decim2.init_state((C,))}
        if self.filter_needed:
            st["fir"] = self.fir.init_state((C,))
        return st

    def apply(self, params, state, x):
        """x: [T] shared wideband → ([C, T/M], state')."""
        st = dict(state)
        bins, st["chz"] = self.chz.apply(None, state["chz"], x)
        y = jnp.take(bins, params["bin"], axis=0)        # [C, 2T/M]
        y, st["xl"] = self.fine.apply(params["xl"], state["xl"], y)
        y, st["d2"] = self.decim2.apply(None, state["d2"], y)
        if self.filter_needed:
            y, st["fir"] = self.fir.apply(None, state["fir"], y)
        return y, st


class SharedRxVFOBank(Block):
    """RxVFO over a SHARED wideband: the per-channel mix-down is folded
    into the first predecimation halfband (ops/fused_frontend.py), so
    the full-rate wideband is read once instead of C times.

    Produces bit-near (~90 dB) the same output as broadcasting the
    wideband into a batched RxVFO; the remaining (decimated-rate) chain
    reuses the exact same blocks.
    """

    def __init__(self, in_samplerate: float, out_samplerate: float,
                 bandwidth: float):
        from ..ops.fused_frontend import SharedXlateDecimFIR, fused_params
        self.base = RxVFO(in_samplerate, out_samplerate, bandwidth)
        self.in_samplerate = float(in_samplerate)
        self._fused_params = fused_params
        blocks = self.base.resamp.chain.named_blocks
        self.has_predec = bool(blocks) and blocks[0][0] == "decim"
        if self.has_predec:
            stage0 = blocks[0][1].stages[0]
            self.fused = SharedXlateDecimFIR(stage0.taps,
                                             in_samplerate, stage0.decim)
            self.rest_decim = blocks[0][1].stages[1:]
        else:
            # no predecimation to fold into — plain broadcast path
            self.fused = None
            self.rest_decim = []
        self.rest = [(n, b) for n, b in blocks if n != "decim"]
        self.ratio = self.base.ratio
        self.in_multiple = self.base.in_multiple
        self.filter_needed = self.base.filter_needed

    def make_params(self, offsets_hz):
        if self.fused is None:
            return {"xl": self.base.make_params(offsets_hz)["xl"]}
        return {"fused": self._fused_params(
            np.asarray(offsets_hz, np.float64), self.in_samplerate,
            self.fused.decim)}

    def init_state(self, C: int):
        st = {}
        if self.fused is None:
            st["xl"] = self.base.xlator.init_state((C,))
        else:
            st["fused"] = self.fused.init_state((C,))
            st["rest_decim"] = [s.init_state((C,))
                                for s in self.rest_decim]
        for n, b in self.rest:
            st[n] = b.init_state((C,))
        if self.filter_needed:
            st["fir"] = self.base.fir.init_state((C,))
        return st

    def apply(self, params, state, x, return_planes: bool = False):
        """x: [T] shared wideband (complex64, or (xr, xi) float32
        planes) → ([C, T_out], state').  With ``return_planes``:
        ((re, im) float32 [C, T_out] planes, state')."""
        if isinstance(x, tuple):
            x = jax.lax.complex(*x)
        st = dict(state)
        if self.fused is None:
            C = params["xl"]["omega"].shape[0]
            xb = jnp.broadcast_to(x[None, :], (C, x.shape[-1]))
            y, st["xl"] = self.base.xlator.apply(params["xl"],
                                                 state["xl"], xb)
        else:
            y, st["fused"] = self.fused.apply(params["fused"],
                                              state["fused"], x)
            new_rd = []
            for blk, s in zip(self.rest_decim, state["rest_decim"]):
                y, ns = blk.apply(None, s, y)
                new_rd.append(ns)
            st["rest_decim"] = new_rd
        for n, b in self.rest:
            y, st[n] = b.apply(None, state[n], y)
        if self.filter_needed:
            y, st["fir"] = self.base.fir.apply(None, state["fir"], y)
        if return_planes:
            return (jnp.real(y), jnp.imag(y)), st
        return y, st
