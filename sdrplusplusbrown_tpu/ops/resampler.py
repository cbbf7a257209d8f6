"""Polyphase rational resampling and power-of-two decimation.

Vectorized re-design of the reference's multirate stack:

  * ``PolyphaseBank`` construction — prototype lowpass split into ``interp``
    phases, tapsPerPhase = ceil(size/phases), *reversed* phase order
    (reference: core/src/dsp/multirate/polyphase_bank.h:14-48).
  * ``PolyphaseResampler`` — per output o: phase=(o*decim)%interp,
    offset=floor(o*decim/interp)
    (reference: core/src/dsp/multirate/polyphase_resampler.h:69-99).
  * ``PowerDecimator`` — cascaded decimate-by-2 FIR stages up to 2^13
    (reference: core/src/dsp/multirate/power_decimator.h:51-113).  The
    reference ships pre-computed "magic optimized FIR" coefficient tables
    (multirate/decim/taps/*); we instead *design* each half-band stage at
    build time with the same windowed-sinc machinery, protecting the final
    passband so cascade aliasing stays below ~90 dB.
  * ``RationalResampler`` — orchestration: largest power-of-2 pre-decimation,
    gcd-reduced interp/decim, Nuttall lowpass prototype scaled by interp,
    0.01% rate-error check (reference: multirate/rational_resampler.h:128-173).

The static-shape trick: JAX needs static output lengths, but the reference's
resampler emits a data-dependent ``outCount``.  Requiring the block length to
be a multiple of ``decim`` makes the (phase, offset) carry *identically zero*
across blocks, so output length is exactly ``len*interp//decim`` and the whole
gather pattern becomes a single strided conv with ``interp`` output channels
(one per output phase, offsets folded into the kernels).
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from . import taps as taps_mod
from .fir import FIR, _conv1d
from ..runtime.block import Block, Chain


def build_polyphase_bank(interp: int, prototype: np.ndarray) -> np.ndarray:
    """Split prototype into ``interp`` phases, reversed phase order.

    Returns [interp, tapsPerPhase]; phases[(interp-1) - (i % interp), i//interp]
    = prototype[i]  (reference polyphase_bank.h:31-37).
    """
    size = prototype.shape[0]
    tpp = (size + interp - 1) // interp
    bank = np.zeros((interp, tpp), dtype=prototype.dtype)
    idx = np.arange(interp * tpp)
    vals = np.where(idx < size, np.pad(prototype, (0, interp * tpp - size)), 0)
    bank[(interp - 1) - (idx % interp), idx // interp] = vals
    return bank


class PolyphaseResampler(Block):
    """Rational L/M resampler as one strided grouped convolution.

    For output o = m*interp + r (with zero carried phase/offset):
        y[o] = sum_k ext[m*decim + c_r + k] * bank[p_r, k]
        p_r = (r*decim) % interp ;  c_r = floor(r*decim / interp)
    The shift c_r ∈ [0, decim) is embedded into a widened kernel
    [interp, K + decim - 1] so one conv with stride=decim and ``interp``
    output channels produces all phases; outputs interleave as [m, r].
    """

    def __init__(self, interp: int, decim: int, prototype: np.ndarray):
        self.interp = int(interp)
        self.decim = int(decim)
        bank = build_polyphase_bank(self.interp, np.asarray(prototype, np.float64))
        self.tpp = bank.shape[1]
        K = self.tpp
        kw = K + self.decim - 1
        kernel = np.zeros((self.interp, kw), dtype=np.float64)
        for r in range(self.interp):
            p_r = (r * self.decim) % self.interp
            c_r = (r * self.decim) // self.interp
            kernel[r, c_r:c_r + K] = bank[p_r]
        self.kernel = kernel
        self.ratio = Fraction(self.interp, self.decim)
        self.in_multiple = self.decim

    def init_state(self, batch_shape=(), dtype=jnp.complex64):
        return jnp.zeros(batch_shape + (self.tpp - 1,), dtype)

    def apply(self, params, state, x):
        if x.shape[-1] % self.decim:
            raise ValueError(
                f"PolyphaseResampler: block length {x.shape[-1]} is not a "
                f"multiple of decim={self.decim}; pad the block to the "
                f"pipeline granularity (Block.in_multiple)")
        lead = x.shape[:-1]
        state = state.astype(x.dtype) if state.dtype != x.dtype else state
        ext = jnp.concatenate([state, x], axis=-1)
        W = ext.shape[-1]
        if jnp.iscomplexobj(x):
            xf = jnp.stack([jnp.real(ext), jnp.imag(ext)], axis=-2)
            xf = xf.reshape((-1, 1, W)).astype(jnp.float32)
            ker = jnp.asarray(self.kernel, jnp.float32)[:, None, :]
            y = _conv1d(xf, ker, self.decim)            # [N*2, interp, M]
            M = y.shape[-1]
            y = jnp.moveaxis(y, 1, 2).reshape((-1, 2, M * self.interp))
            out = jax.lax.complex(y[:, 0], y[:, 1])
            out = out.reshape(lead + (M * self.interp,))
        else:
            xf = ext.reshape((-1, 1, W)).astype(jnp.float32)
            ker = jnp.asarray(self.kernel, jnp.float32)[:, None, :]
            y = _conv1d(xf, ker, self.decim)            # [N, interp, M]
            M = y.shape[-1]
            out = jnp.moveaxis(y, 1, 2).reshape(lead + (M * self.interp,))
        new_state = ext[..., W - (self.tpp - 1):]
        return out, new_state


def fold_output_fir(poly: PolyphaseResampler,
                    fir_taps: np.ndarray) -> PolyphaseResampler:
    """Fold a causal output-rate FIR h (z[o] = Σ_j h[j]·y[o−j]) INTO a
    polyphase L/M resampler, returning a new resampler computing the
    exact cascade in ONE pass.

    Derivation is operational, against the implementation's own widened
    form y[m·I + r] = Σ_l kernel[r, l]·ext[m·D + l]:

        z[m·I + r] = Σ_j h[j]·y[(m + ⌊(r−j)/I⌋)·I + (r−j) mod I]
                   = Σ_λ k″[r, λ]·ext[(m−S)·D + λ]

    with S = ⌈(K−1)/I⌉ extra input blocks of history and
    k″[r, λ] = Σ_j h[j]·kernel[(r−j) mod I, λ − D·(S + ⌊(r−j)/I⌋)].
    The longer ``tpp`` (= +S·D) is the whole state: the input-side
    history reproduces the FIR's output-side memory exactly, so the
    separate downstream block (and its state) disappears.  Used to fuse
    WFM de-emphasis into the AF resampler (the truncated-exponential
    FIR form of the 1-pole IIR, ops/recurrence.py:Deemphasis) — one
    HBM pass instead of resample + deemphasis sweeps.
    """
    h = np.asarray(fir_taps, np.float64)
    K = h.shape[0]
    I, D = poly.interp, poly.decim
    S = (K - 1 + I - 1) // I
    kern = np.asarray(poly.kernel, np.float64)
    kw = kern.shape[1]
    kw2 = kw + S * D
    k2 = np.zeros((I, kw2), np.float64)
    for r in range(I):
        for j in range(K):
            rp = (r - j) % I
            sh = D * (S + (r - j) // I)
            k2[r, sh:sh + kw] += h[j] * kern[rp]
    out = PolyphaseResampler.__new__(PolyphaseResampler)
    out.interp = I
    out.decim = D
    out.tpp = poly.tpp + S * D
    out.kernel = k2
    out.ratio = poly.ratio
    out.in_multiple = poly.in_multiple
    return out


def design_decim_stage(fs_in: float, decim: int,
                       protect: float) -> np.ndarray:
    """Design one decimate-by-``decim`` lowpass stage protecting
    [0, protect] Hz.

    Aliasing into the protected band after decimation comes from
    [fs_in/decim - protect, fs_in/2]; we place the stopband edge there
    and the passband edge at ``protect`` (designed at build time in place
    of the reference's pre-baked tables, multirate/decim/plans.h).
    """
    pass_edge = protect
    stop_edge = fs_in / float(decim) - protect
    assert stop_edge > pass_edge, (fs_in, decim, protect)
    # windowed-sinc with the 3.8 tap rule reaches ~-90 dB at cutoff + trans
    # (and is flat by cutoff - trans), so center the transition and use half
    # the available width on each side.
    trans = (stop_edge - pass_edge) / 2.0
    cutoff = (pass_edge + stop_edge) / 2.0
    count = taps_mod.estimate_tap_count(trans, fs_in)
    count = max(count, 7)
    return taps_mod.windowed_sinc_hz(count, cutoff, fs_in, norm=1.0)


def design_halfband_stage(fs_in: float, protect: float) -> np.ndarray:
    """Decimate-by-2 special case of :func:`design_decim_stage`."""
    return design_decim_stage(fs_in, 2, protect)


class PowerDecimator(Block):
    """Power-of-2 decimation via cascaded decimating FIR stages.

    reference: core/src/dsp/multirate/power_decimator.h (max ratio 2^13)
    — the reference cascades HALFBANDS, the CPU-optimal plan (fewest
    taps·samples).  Here each intermediate buffer costs a device-memory
    write+read regardless of tap count, so stages decimate by 4 where
    the tap budget allows (K ≤ ``MAX_STAGE_TAPS``), halving the number
    of full-rate intermediates for the same ~90 dB band protection.  The
    fold-the-mix-down front end (ops/fused_frontend) then absorbs a
    ratio-4 predecimation in one strided convolution.
    """

    MAX_RATIO = 8192
    MAX_STAGE_TAPS = 320

    def __init__(self, fs_in: float, ratio: int, protect_frac: float = 0.45):
        assert ratio >= 2 and (ratio & (ratio - 1)) == 0 and ratio <= self.MAX_RATIO
        self.ratio_int = ratio
        fs_out = fs_in / ratio
        protect = protect_frac * fs_out
        stages: List[FIR] = []
        fs = fs_in
        rem = ratio
        while rem > 1:
            d = 4 if rem % 4 == 0 else 2
            if d == 4:
                # decim-4 only when the transition stays open and the
                # tap count within budget; else fall back to a halfband
                if fs / 4.0 - protect <= protect:
                    d = 2
                else:
                    taps = design_decim_stage(fs, 4, protect)
                    if len(taps) > self.MAX_STAGE_TAPS:
                        d = 2
            if d == 2:
                taps = design_decim_stage(fs, 2, protect)
            stages.append(FIR(taps, decim=d))
            fs /= d
            rem //= d
        self.stages = stages
        self.ratio = Fraction(1, ratio)
        self.in_multiple = ratio

    def init_state(self, batch_shape=(), dtype=jnp.complex64):
        return [s.init_state(batch_shape, dtype) for s in self.stages]

    def apply(self, params, state, x):
        new_state = []
        for s, st in zip(self.stages, state):
            x, nst = s.apply(None, st, x)
            new_state.append(nst)
        return x, new_state


class RationalResampler(Block):
    """Arbitrary-rate resampler: PowerDecimator then PolyphaseResampler.

    Mirrors reference multirate/rational_resampler.h:128-173 reconfigure():
      predecPower = min(floor(log2(in/out)), 13); int rate = in/2^p;
      interp/decim = round(outSR)/gcd, round(intSR)/gcd;
      prototype lowpass: cutoff = min(in,out)/2, trans = cutoff*0.1, designed
      at rate intSR*interp and scaled by interp; warn at >0.01% rate error.
    """

    def __init__(self, fs_in: float, fs_out: float):
        self.fs_in = float(fs_in)
        self.fs_out = float(fs_out)
        predec_power = 0
        if fs_in > fs_out:
            predec_power = min(int(math.floor(math.log2(fs_in / fs_out))), 13)
        # prefer the largest power-of-2 that divides fs_in *exactly*: a
        # fractional intermediate rate would be rounded (reference
        # rational_resampler.h:141 `(int)`), costing up to 0.01% rate error
        # and a huge gcd-reduced interp/decim (= giant static block
        # granularity here).  Backing off a step keeps the chain exact.
        while predec_power > 0 and \
                (fs_in / (1 << predec_power)) != round(fs_in / (1 << predec_power)):
            predec_power -= 1
        predec_ratio = min(1 << predec_power, PowerDecimator.MAX_RATIO)
        use_decim = fs_in > fs_out and predec_power > 0
        int_sr = fs_in / predec_ratio if use_decim else fs_in

        int_i = round(int_sr)
        out_i = round(fs_out)
        g = math.gcd(int_i, out_i)
        interp = out_i // g
        decim = int_i // g
        # true achieved rate: the chain resamples the *actual* int_sr by
        # interp/decim (the reference computes int_i·interp/decim, which
        # is algebraically always == round(fs_out) — a tautology,
        # rational_resampler.h:148)
        actual_out = int_sr * interp / decim
        self.rate_error_pct = abs((actual_out - fs_out) / fs_out) * 100.0

        blocks = []
        if use_decim:
            blocks.append(("decim", PowerDecimator(fs_in, predec_ratio)))
        if interp != decim:
            tap_sr = int_sr * interp
            bw = min(fs_in, fs_out) / 2.0
            proto = taps_mod.low_pass(bw, bw * 0.1, tap_sr) * interp
            blocks.append(("resamp", PolyphaseResampler(interp, decim, proto)))
        self.chain = Chain(blocks)
        self.ratio = self.chain.ratio
        self.in_multiple = self.chain.in_multiple

    def init_state(self, batch_shape=(), dtype=jnp.complex64):
        return {name: blk.init_state(batch_shape, dtype)
                for name, blk in self.chain.named_blocks}

    def apply(self, params, state, x):
        return self.chain.apply(None, state, x)
