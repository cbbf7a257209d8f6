"""LogMMSE noise reduction — the fork's flagship feature, as a batched
STFT pipeline.

reference: misc_modules/noise_reduction_logmmse/src/logmmse.h.  Algorithm
(Ephraim-Malah log-MMSE with decision-directed a-priori SNR):

  * framing: Slen = ⌊0.02·SR⌋ (even), 50 % overlap (len1 = len2 = Slen/2),
    nFFT = 2·Slen zero-padded FFT, symmetric Hann window scaled by
    len2/Σwin  (logmmse.h:286-312 logmmse_sample).
  * per frame: sig = |FFT(win·x)|; γk = min(sig²/noise_µ2, 40);
    ξ = aa·Xk_prev/noise_µ2 + (1−aa)·max(γk−1, 0)  clamped at ksi_min
    (aa = 0.98, ksi_min = 10^−2.5); A = ξ/(1+ξ); vk = A·γk;
    hw = A·exp(½·E1(vk)); Xk_prev = (sig·hw)²; output = overlap-add of
    IFFT(hw·spec)  (logmmse.h:341-438 logmmse_all).
  * noise tracking: every frame's |spec| enters a sliding history of
    H = 2000 (nFFT<1000) / 200 frames with running sums and running
    squared-deviation sums (add_noise_history, logmmse.h:117-140).  Once
    >100 frames exist, the noise PSD updates once per processed block:
      - audio path (SR ≤ 24 kHz): mean of the last 12 history frames,
        squared; accepted when its smoothed min+max undercuts the current
        floor (update_noise_mu2 audio branch, logmmse.h:164-216).
      - wideband path: per-bin deviation thresholding against a histogram-
        mode background-noise estimate (bgnoise.h), zeroed bins filled by
        linear interpolation (update_noise_mu2 wideband branch,
        logmmse.h:217-253, arrays.cpp:433-469 linearInterpolateHoles).

Vectorized structure: all frames of a block are FFT'd in one batched FFT;
the only sequential parts are two light ``lax.scan``s — the history-ring
bookkeeping and the decision-directed ξ recursion — over per-frame [nFFT]
vectors.  The overlap-add is closed-form (shift + add), not a loop.  E1 is
computed with the Abramowitz-Stegun 5.1.53/5.1.56 rational approximations
instead of the reference's interpolation table (arrays.cpp:61, ~1e-7 abs
error vs the table's ~1e-3).
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..runtime.block import Block
from .recurrence import linear_recurrence

ERASED_SAMPLE = 1e9  # bgnoise.h:19
NBUCKETS = 1000      # bgnoise.h:11
SKIP_FRAMES = 10     # bgnoise.h:12


# ----------------------------------------------------------------------
def expn_e1(x: jnp.ndarray) -> jnp.ndarray:
    """Exponential integral E1(x), x>0 (float32).

    Abramowitz & Stegun 5.1.53 (x≤1) / 5.1.56 (x>1); |ε| < 2e-7.
    Replaces the reference's x^(1/4)-gridded lookup table
    (arrays.cpp:61-432)."""
    x = jnp.maximum(x, 1e-8)
    # x <= 1: E1 = -ln x + Σ a_k x^k
    a = jnp.array([-0.57721566, 0.99999193, -0.24991055,
                   0.05519968, -0.00976004, 0.00107857], jnp.float32)
    xs = jnp.minimum(x, 1.0)
    small = (-jnp.log(xs) + a[0] + xs * (a[1] + xs * (a[2] + xs *
             (a[3] + xs * (a[4] + xs * a[5])))))
    # x >= 1: E1 = exp(-x)/x · P(x)/Q(x)
    xl = jnp.maximum(x, 1.0)
    p = jnp.array([8.5733287401, 18.0590169730, 8.6347608925,
                   0.2677737343], jnp.float32)
    q = jnp.array([9.5733223454, 25.6329561486, 21.0996530827,
                   3.9584969228], jnp.float32)
    num = xl ** 4 + p[0] * xl ** 3 + p[1] * xl ** 2 + p[2] * xl + p[3]
    den = xl ** 4 + q[0] * xl ** 3 + q[1] * xl ** 2 + q[2] * xl + q[3]
    large = jnp.exp(-xl) / xl * (num / den)
    return jnp.where(x <= 1.0, small, large).astype(jnp.float32)


def moving_average(v: jnp.ndarray, window: int) -> jnp.ndarray:
    """Centered moving average with edge-clamped counts
    (numpy-style analog of reference npmavg, arrays.cpp:1068-1092)."""
    n = v.shape[-1]
    w = window + 1
    ker = np.ones((1, 1, w), np.float32)
    lead = v.shape[:-1]
    pad = [(w // 2, w - 1 - w // 2)]
    vp = jnp.pad(v.reshape((-1, 1, n)).astype(jnp.float32),
                 [(0, 0), (0, 0)] + pad)
    ones = jnp.pad(jnp.ones((1, 1, n), jnp.float32),
                   [(0, 0), (0, 0)] + pad)
    dn = jax.lax.ConvDimensionNumbers((0, 1, 2), (0, 1, 2), (0, 1, 2))
    s = jax.lax.conv_general_dilated(vp, jnp.asarray(ker), (1,), "VALID",
                                     dimension_numbers=dn)
    c = jax.lax.conv_general_dilated(ones, jnp.asarray(ker), (1,), "VALID",
                                     dimension_numbers=dn)
    return (s / c).reshape(lead + (n,))


def linear_interpolate_holes(arr: jnp.ndarray):
    """Fill zero-valued holes by linear interpolation between neighbours,
    clamping the edges (reference arrays.cpp:433-469).  Returns
    (filled, any_nonzero)."""
    n = arr.shape[-1]
    idx = jnp.arange(n, dtype=jnp.int32)
    nz = arr != 0.0
    prev_i = jax.lax.cummax(jnp.where(nz, idx, -1), axis=arr.ndim - 1)
    next_i = -jax.lax.cummax(
        jnp.where(nz, -idx, -(n)), axis=arr.ndim - 1, reverse=True)
    prev_v = jnp.take_along_axis(arr, jnp.maximum(prev_i, 0), axis=-1)
    next_v = jnp.take_along_axis(arr, jnp.minimum(next_i, n - 1), axis=-1)
    both = (prev_i >= 0) & (next_i < n)
    denom = jnp.maximum(next_i - prev_i, 1).astype(arr.dtype)
    interp = prev_v + (next_v - prev_v) * (idx - prev_i).astype(arr.dtype) / denom
    filled = jnp.where(nz, arr,
                       jnp.where(both, interp,
                                 jnp.where(prev_i >= 0, prev_v, next_v)))
    any_nz = jnp.any(nz, axis=-1)
    return filled, any_nz


def _bg_noise_update(dev_square, last_noise, frame_count):
    """Histogram-mode background noise tracker (reference bgnoise.h:26-59).

    dev_square: [..., nFFT] with ERASED_SAMPLE holes; returns updated
    (last_noise, frame_count)."""
    do_update = (frame_count == 0) | (frame_count % SKIP_FRAMES == 0)
    mask = dev_square != ERASED_SAMPLE
    logf = jnp.where(mask, jnp.log10(jnp.maximum(dev_square, 1e-30)), 0.0)
    minn = jnp.min(jnp.where(mask, logf, np.inf), axis=-1)
    maxx = jnp.max(jnp.where(mask, logf, -np.inf), axis=-1)
    width = jnp.maximum(maxx - minn, 1e-12)
    bucket = (NBUCKETS * (logf - minn[..., None]) / width[..., None])
    bucket = jnp.clip(bucket.astype(jnp.int32), 0, NBUCKETS - 1)
    # scatter-add histogram: O(nFFT + NBUCKETS) (a one-hot would
    # materialize an nFFT×1000 tensor — 384 MB at the 2.4 MS/s IF rate)
    w = mask.astype(jnp.float32)

    def hist_1d(b, wv):
        return jnp.zeros((NBUCKETS,), jnp.float32).at[b].add(wv)

    lead = bucket.shape[:-1]
    counts = jax.vmap(hist_1d)(bucket.reshape((-1, bucket.shape[-1])),
                               w.reshape((-1, w.shape[-1])))
    counts = counts.reshape(lead + (NBUCKETS,))
    ix = jnp.argmax(counts, axis=-1).astype(jnp.float32)
    maxf = 10.0 ** ((ix / NBUCKETS) * width + minn)
    first = last_noise == ERASED_SAMPLE
    new_noise = jnp.where(first, maxf, 0.9 * last_noise + 0.1 * maxf)
    last_noise = jnp.where(do_update, new_noise, last_noise)
    return last_noise, frame_count + 1


class LogMMSE(Block):
    """Streaming log-MMSE NR over complex blocks (batched on leading axes).

    ``wideband`` selects the noise-floor detector; default follows the
    reference rule SR ≤ 24 kHz → audio (logmmse.h:299).
    """

    NOISE_FRAMES = 12  # initial sampling frames (if_nr.h:83, af_nr.h:298)

    def __init__(self, samplerate: float, wideband: Optional[bool] = None):
        self.samplerate = float(samplerate)
        slen = int(math.floor(0.02 * samplerate))
        if slen % 2 == 1:
            slen += 1
        self.Slen = slen
        self.len1 = slen // 2
        self.len2 = slen - self.len1
        self.nFFT = 2 * slen
        # reference: audioFrequency = nFFT < 1200 (logmmse.h:265 in
        # update_noise_mu2) — i.e. samplerate < 30 kHz, not <= 24 kHz
        self.audio = (self.nFFT < 1200) if wideband is None \
            else (not wideband)
        self.H = 2000 if self.nFFT < 1000 else 200
        win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(slen) / (slen - 1))
        self.win = (win * self.len2 / win.sum()).astype(np.float32)
        self.aa = 0.98
        self.ksi_min = 10.0 ** (-25.0 / 10.0)
        self.in_multiple = self.len2
        self.ratio = Fraction(1, 1)

    # ------------------------------------------------------------------
    def init_state(self, batch_shape=()):
        b = batch_shape
        f32 = jnp.float32
        return {
            "tail": jnp.zeros(b + (self.Slen,), jnp.complex64),
            "x_old": jnp.zeros(b + (self.len1,), jnp.complex64),
            "Xk_prev": jnp.zeros(b + (self.nFFT,), f32),
            "has_prev": jnp.zeros(b, jnp.bool_),
            "noise_mu2": jnp.ones(b + (self.nFFT,), f32),
            "primed": jnp.zeros(b, jnp.bool_),
            "hist": jnp.zeros(b + (self.H, self.nFFT), f32),
            "dev_hist": jnp.zeros(b + (self.H, self.nFFT), f32),
            "sums": jnp.zeros(b + (self.nFFT,), f32),
            "devs": jnp.zeros(b + (self.nFFT,), f32),
            # frame counters advance identically for every channel → scalars
            "count": jnp.zeros((), jnp.int32),
            "pos": jnp.zeros((), jnp.int32),
            "mindb": jnp.zeros(b, f32),
            "maxdb": jnp.zeros(b, f32),
            "stable": jnp.zeros(b, jnp.bool_),
            "generation": jnp.zeros((), jnp.int32),
            "bg_last_noise": jnp.full(b, ERASED_SAMPLE, f32),
            "bg_frame_count": jnp.zeros((), jnp.int32),
        }

    def init_params(self):
        return {"hold": jnp.asarray(False)}

    # ------------------------------------------------------------------
    def _frames(self, ext: jnp.ndarray, F: int) -> jnp.ndarray:
        """[..., T+Slen] → [..., F, Slen] windows at stride len2."""
        idx = (np.arange(F)[:, None] * self.len2
               + np.arange(self.Slen)[None, :])
        return ext[..., idx]

    def _spectra(self, frames: jnp.ndarray):
        """frames [..., F, Slen] → (spec [..., F, nFFT], sig |spec|)."""
        w = jnp.asarray(self.win)
        insign = frames * w
        pad = [(0, 0)] * (insign.ndim - 1) + [(0, self.nFFT - self.Slen)]
        spec = jnp.fft.fft(jnp.pad(insign, pad), axis=-1)
        sig = jnp.abs(spec).astype(jnp.float32)
        # zero-fix: sig[z]==0 → previous bin (logmmse.h:364-368), a
        # first-order select-recurrence along bins
        isz = (sig == 0.0)
        sig = linear_recurrence(isz.astype(jnp.float32),
                                jnp.where(isz, 0.0, sig),
                                jnp.zeros(sig.shape[:-1], jnp.float32))
        return spec, sig

    def _push_history(self, st: dict, sigs: jnp.ndarray, hold) -> dict:
        """Scan the per-frame sliding-window bookkeeping
        (reference add_noise_history, logmmse.h:117-140)."""
        H = self.H

        def step(carry, noise):
            hist, dev_hist, sums, devs, count, pos = carry
            full = count >= H
            old = jax.lax.dynamic_slice_in_dim(hist, pos, 1,
                                               axis=hist.ndim - 2)[..., 0, :]
            old_dev = jax.lax.dynamic_slice_in_dim(
                dev_hist, pos, 1, axis=hist.ndim - 2)[..., 0, :]
            sums2 = sums + noise - jnp.where(full, old, 0.0)
            count2 = jnp.where(full, count, count + 1)
            navg = sums2 / count2.astype(jnp.float32)
            diff = (noise - navg) ** 2
            devs2 = devs + diff - jnp.where(full, old_dev, 0.0)
            hist2 = jax.lax.dynamic_update_slice_in_dim(
                hist, noise[..., None, :], pos, axis=hist.ndim - 2)
            dev2 = jax.lax.dynamic_update_slice_in_dim(
                dev_hist, diff[..., None, :], pos, axis=hist.ndim - 2)
            pos2 = (pos + 1) % H
            return (hist2, dev2, sums2, devs2, count2, pos2), None

        def no_step(carry, noise):
            return carry, None

        init = (st["hist"], st["dev_hist"], st["sums"], st["devs"],
                st["count"], st["pos"])
        # frames axis first for scan
        sig_t = jnp.moveaxis(sigs, -2, 0)
        (hist, dev_hist, sums, devs, count, pos), _ = jax.lax.scan(
            lambda c, n: jax.lax.cond(hold, no_step, step, c, n),
            init, sig_t)
        st.update(hist=hist, dev_hist=dev_hist, sums=sums, devs=devs,
                  count=count, pos=pos)
        return st

    # ------------------------------------------------------------------
    def _update_noise_mu2(self, st: dict, hold) -> dict:
        """Once-per-block noise PSD refresh (logmmse.h:152-283)."""
        nframes = st["count"]
        gate = (nframes > 100) & jnp.logical_not(hold)

        if self.audio:
            # mean of the last NOISE_FRAMES=12 history frames
            k = 12
            offs = (st["pos"] - k + jnp.arange(k)) % self.H
            last = jnp.take(st["hist"], offs, axis=st["hist"].ndim - 2)
            lower = jnp.mean(last, axis=-2)
            tnm = lower * lower
            tsm = moving_average(tnm, 6)
            tmin = jnp.min(tsm, axis=-1)
            tmax = jnp.max(tsm, axis=-1)
            accept = gate & (st["generation"] > 0) & \
                (tmin + tmax < st["mindb"] + st["maxdb"])
            noise_mu2 = jnp.where(accept[..., None], tnm, st["noise_mu2"])
            mindb = jnp.where(accept, tmin, st["mindb"])
            maxdb = jnp.where(accept, tmax, st["maxdb"])
            stable = st["stable"] | accept
            # generation==0 && !stable: initialize floor from current mu2
            init0 = gate & (st["generation"] == 0) & \
                jnp.logical_not(st["stable"])
            cur = moving_average(st["noise_mu2"], 6)
            mindb = jnp.where(init0, jnp.min(cur, axis=-1), mindb)
            maxdb = jnp.where(init0, jnp.max(cur, axis=-1), maxdb)
            st.update(noise_mu2=noise_mu2, mindb=mindb, maxdb=maxdb,
                      stable=stable,
                      generation=st["generation"] + gate.astype(jnp.int32))
            return st

        # wideband path
        navg = st["sums"] / jnp.maximum(nframes.astype(jnp.float32), 1.0)
        hi = st["devs"] / jnp.maximum(nframes.astype(jnp.float32), 1.0)
        dev_sq = hi * hi
        n = self.nFFT
        z = np.arange(n)
        erased = np.abs(z - n // 2) < (n * 15) // 100
        dev_sq = jnp.where(jnp.asarray(erased), ERASED_SAMPLE, dev_sq)
        last_noise, fc = _bg_noise_update(
            dev_sq, st["bg_last_noise"], st["bg_frame_count"])
        nmu2 = jnp.where(dev_sq < last_noise[..., None], navg * navg, 0.0)
        filled, any_nz = linear_interpolate_holes(nmu2)
        ok = gate & any_nz
        noise_mu2 = jnp.where(ok[..., None], filled, st["noise_mu2"])
        st.update(noise_mu2=noise_mu2,
                  bg_last_noise=jnp.where(gate, last_noise,
                                          st["bg_last_noise"]),
                  bg_frame_count=jnp.where(gate, fc, st["bg_frame_count"]))
        return st

    # ------------------------------------------------------------------
    def _gains(self, st: dict, sigs: jnp.ndarray):
        """Decision-directed ξ recursion over frames → hw [..., F, nFFT]
        (logmmse.h:376-397)."""
        aa = jnp.float32(self.aa)
        ksi_min = jnp.float32(self.ksi_min)
        mu2 = jnp.maximum(st["noise_mu2"], 1e-30)

        def step(carry, sig):
            xk_prev, has_prev = carry
            sig2 = sig * sig
            gammak = jnp.minimum(sig2 / mu2, 40.0)
            gm = jnp.maximum(gammak - 1.0, 0.0)
            ksi_first = (1.0 - aa) * gm + aa
            ksi_dd = jnp.maximum(aa * xk_prev / mu2 + (1.0 - aa) * gm,
                                 ksi_min)
            ksi = jnp.where(has_prev[..., None], ksi_dd, ksi_first)
            A = ksi / (1.0 + ksi)
            vk = A * gammak
            hw = A * jnp.exp(0.5 * expn_e1(vk))
            sig_hw = sig * hw
            return (sig_hw * sig_hw,
                    jnp.ones_like(has_prev)), hw

        sig_t = jnp.moveaxis(sigs, -2, 0)
        (xk_prev, has_prev), hws = jax.lax.scan(
            step, (st["Xk_prev"], st["has_prev"]), sig_t)
        st.update(Xk_prev=xk_prev, has_prev=has_prev)
        return st, jnp.moveaxis(hws, 0, -2)

    # ------------------------------------------------------------------
    def apply(self, params, state, x):
        if x.shape[-1] % self.len2:
            raise ValueError(
                f"LogMMSE: block length {x.shape[-1]} must be a multiple "
                f"of len2={self.len2}")
        hold = params["hold"] if params else jnp.asarray(False)
        T = x.shape[-1]
        F = T // self.len2
        st = dict(state)

        ext = jnp.concatenate([st["tail"], x], axis=-1)
        st["tail"] = ext[..., T:]

        frames = self._frames(ext, F)
        spec, sig = self._spectra(frames)

        # noise PSD refresh uses the history as of the previous block
        st = self._update_noise_mu2(st, hold)
        st = self._push_history(st, sig, hold)
        st, hw = self._gains(st, sig)

        xi = jnp.fft.ifft(hw.astype(jnp.complex64) * spec, axis=-1)
        head = xi[..., :self.len1]                    # [..., F, len1]
        tail = xi[..., self.len1:self.Slen]
        prev_tail = jnp.concatenate(
            [st["x_old"][..., None, :], tail[..., :-1, :]], axis=-2)
        out_frames = head + prev_tail
        st["x_old"] = tail[..., -1, :]
        out = out_frames.reshape(out_frames.shape[:-2] + (F * self.len1,))
        return out.astype(jnp.complex64), st

    # ------------------------------------------------------------------
    def prime(self, state, x0):
        """Initial noise sampling (reference logmmse_sample,
        logmmse.h:286-339): NOISE_FRAMES non-overlapping Slen frames of
        ``x0`` seed noise_mu2 and the history."""
        need = self.NOISE_FRAMES * self.Slen
        assert x0.shape[-1] >= need, (x0.shape, need)
        frames = x0[..., :need].reshape(
            x0.shape[:-1] + (self.NOISE_FRAMES, self.Slen))
        _, sig = self._spectra(frames)
        st = dict(state)
        st = self._push_history(st, sig, jnp.asarray(False))
        noise_mean = jnp.mean(sig, axis=-2)
        if not self.audio:
            noise_mean = moving_average(noise_mean, 120)
        st["noise_mu2"] = noise_mean * noise_mean
        st["primed"] = jnp.ones(st["primed"].shape, jnp.bool_)
        return st


class IFNRLogMMSE(Block):
    """Baseband (IF) noise reduction preprocessor: wideband LogMMSE with
    the reference's ×4 output gain (if_nr.h:99-104)."""

    def __init__(self, samplerate: float):
        self.core = LogMMSE(samplerate, wideband=True)
        self.in_multiple = self.core.in_multiple

    def init_state(self, batch_shape=()):
        return self.core.init_state(batch_shape)

    def init_params(self):
        return self.core.init_params()

    def prime(self, state, x0):
        return self.core.prime(state, x0)

    def apply(self, params, state, x):
        y, st = self.core.apply(params, state, x)
        return y * 4.0, st


class AFNRLogMMSE(Block):
    """Audio noise reduction: audio-path LogMMSE at 24 kHz processing
    bandwidth with a 5-sample moving-average smoother
    (af_nr.h:208-345, SMAStream<5>)."""

    SMA = 5

    def __init__(self, samplerate: float = 24000.0):
        self.core = LogMMSE(samplerate, wideband=False)
        self.in_multiple = self.core.in_multiple

    def init_state(self, batch_shape=()):
        st = self.core.init_state(batch_shape)
        st["sma"] = jnp.zeros(batch_shape + (self.SMA - 1,), jnp.complex64)
        return st

    def init_params(self):
        return self.core.init_params()

    def prime(self, state, x0):
        st = dict(state)
        st.update(self.core.prime(
            {k: v for k, v in state.items() if k != "sma"}, x0))
        return st

    def apply(self, params, state, x):
        core_state = {k: v for k, v in state.items() if k != "sma"}
        y, st = self.core.apply(params, core_state, x)
        ext = jnp.concatenate([state["sma"], y], axis=-1)
        ker = np.ones(self.SMA, np.float32) / self.SMA
        from .fir import correlate
        sm = correlate(ext, ker)
        st["sma"] = ext[..., ext.shape[-1] - (self.SMA - 1):]
        return sm, st
