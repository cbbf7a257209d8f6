"""OM-LSA speech enhancement with MCRA noise estimation.

reference: misc_modules/noise_reduction_logmmse/src/omlsa_mcra/* — the
fork vendors a fixed-point OMLSA-MCRA implementation (CORDIC + base-4
FFT) as the `AFNR_OMLSA_MCRA` audio NR option.  This is a float32
Vectorized implementation of the same published algorithm
(Cohen & Berdugo 2001/2002):

  * STFT, 50 % overlap, Hann analysis/synthesis.
  * MCRA noise PSD: frequency-smoothed periodogram Sf, recursive smoothing
    S, a running minimum Smin over a sliding window (tracked with the
    standard two-buffer trick), speech-presence indicator
    I = (S/Smin > delta), presence probability p' smoothed by alpha_p, and
    noise update λ_d ← α_d' λ_d + (1-α_d') |Y|² with
    α_d' = α_d + (1-α_d) p'.
  * OM-LSA gain: decision-directed ξ (α=0.92), v = ξγ/(1+ξ),
    G_H1 = ξ/(1+ξ)·exp(½E1(v)), presence prob p from the a-priori ratio,
    final gain G = G_H1^p · G_min^(1-p).

Like ops/logmmse.py, all frames of a block are FFT'd batched; the serial
parts (ξ recursion, MCRA state) run in one light lax.scan over frames.
"""

from __future__ import annotations

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..runtime.block import Block
from .logmmse import expn_e1


class OMLSA(Block):
    def __init__(self, samplerate: float, frame_len: int | None = None,
                 g_min: float = 10.0 ** (-25.0 / 20.0),
                 alpha: float = 0.92, alpha_d: float = 0.85,
                 alpha_s: float = 0.8, alpha_p: float = 0.2,
                 delta: float = 5.0, min_window_frames: int = 60):
        self.samplerate = float(samplerate)
        n = frame_len or (1 << int(round(math.log2(0.02 * samplerate))))
        self.N = int(n)
        self.hop = self.N // 2
        # sqrt-Hann at analysis AND synthesis: periodic Hann satisfies
        # w[n] + w[n+N/2] = 1 at 50% overlap, so the analysis·synthesis
        # product (= Hann) overlap-adds to exactly 1 (COLA)
        win = np.hanning(self.N + 1)[:-1]
        self.win = np.sqrt(win).astype(np.float32)
        self.g_min = float(g_min)
        self.alpha = float(alpha)
        self.alpha_d = float(alpha_d)
        self.alpha_s = float(alpha_s)
        self.alpha_p = float(alpha_p)
        self.delta = float(delta)
        self.L = int(min_window_frames)
        self.in_multiple = self.hop
        self.ratio = Fraction(1, 1)

    def init_state(self, batch_shape=()):
        b = batch_shape
        F = self.N // 2 + 1       # rfft bins
        f32 = jnp.float32
        big = jnp.full(b + (F,), 1e10, f32)
        return {
            "tail": jnp.zeros(b + (self.N,), f32),
            "ola": jnp.zeros(b + (self.hop,), f32),
            "S": jnp.zeros(b + (F,), f32),
            "Smin": big,
            "Stmp": big,
            "lambda_d": jnp.full(b + (F,), 1e-6, f32),
            "p_prev": jnp.zeros(b + (F,), f32),
            "xi_prev": jnp.full(b + (F,), 1.0, f32),
            "G_prev": jnp.ones(b + (F,), f32),
            "frame_count": jnp.zeros((), jnp.int32),
            "primed": jnp.zeros(b, jnp.bool_),
        }

    def _freq_smooth(self, p):
        k = jnp.asarray([0.25, 0.5, 0.25], jnp.float32)
        pad = [(0, 0)] * (p.ndim - 1) + [(1, 1)]
        pp = jnp.pad(p, pad, mode="edge")
        return (k[0] * pp[..., :-2] + k[1] * pp[..., 1:-1]
                + k[2] * pp[..., 2:])

    def apply(self, params, state, x):
        if x.shape[-1] % self.hop:
            raise ValueError(
                f"OMLSA: block length {x.shape[-1]} must be a multiple of "
                f"hop={self.hop}")
        st = dict(state)
        T = x.shape[-1]
        Fn = T // self.hop
        ext = jnp.concatenate([st["tail"], x], axis=-1)
        st["tail"] = ext[..., T:]
        idx = (np.arange(Fn)[:, None] * self.hop
               + np.arange(self.N)[None, :])
        frames = ext[..., idx] * jnp.asarray(self.win)
        spec = jnp.fft.rfft(frames, axis=-1)
        ps = (jnp.abs(spec) ** 2).astype(jnp.float32)  # [..., Fn, N/2+1]

        a = jnp.float32(self.alpha)
        ad = jnp.float32(self.alpha_d)
        as_ = jnp.float32(self.alpha_s)
        ap = jnp.float32(self.alpha_p)
        delta = jnp.float32(self.delta)
        gmin = jnp.float32(self.g_min)
        L = self.L

        def step(carry, inputs):
            S, Smin, Stmp, lam, p_prev, xi_prev, G_prev, fc = carry
            p = inputs
            Sf = self._freq_smooth(p)
            S2 = as_ * S + (1 - as_) * Sf
            Smin2 = jnp.minimum(Smin, S2)
            Stmp2 = jnp.minimum(Stmp, S2)
            wrap = (fc % L) == (L - 1)
            Smin3 = jnp.where(wrap, Stmp2, Smin2)
            Stmp3 = jnp.where(wrap, S2, Stmp2)
            # speech presence from minima ratio
            Sr = S2 / jnp.maximum(Smin3, 1e-20)
            I = (Sr > delta).astype(jnp.float32)
            # MCRA smoothed presence probability p' = α_p p' + (1-α_p) I
            p_prob = ap * p_prev + (1 - ap) * I
            ad_eff = ad + (1 - ad) * p_prob
            lam2 = ad_eff * lam + (1 - ad_eff) * p
            # OM-LSA gain
            lam_safe = jnp.maximum(lam2, 1e-20)
            gamma = jnp.minimum(p / lam_safe, 40.0)
            gm = jnp.maximum(gamma - 1.0, 0.0)
            # decision-directed: xi_prev carries G²·γ of the previous frame
            xi = jnp.maximum(a * xi_prev + (1 - a) * gm, 1e-6)
            v = jnp.clip(xi * gamma / (1.0 + xi), 1e-8, 50.0)
            G_h1 = (xi / (1.0 + xi)) * jnp.exp(0.5 * expn_e1(v))
            # a-priori speech absence → presence probability
            q = jnp.clip(1.0 - p_prob, 0.05, 0.95)
            ratio = (q / (1.0 - q)) * (1.0 + xi) * jnp.exp(-v)
            p_post = 1.0 / (1.0 + ratio)
            G = (G_h1 ** p_post) * (gmin ** (1.0 - p_post))
            xi_new = (G_h1 ** 2) * gamma   # for decision-directed next frame
            return (S2, Smin3, Stmp3, lam2, p_prob, xi_new, G, fc + 1), G

        ps_t = jnp.moveaxis(ps, -2, 0)
        init = (st["S"], st["Smin"], st["Stmp"], st["lambda_d"],
                st["p_prev"], st["xi_prev"], st["G_prev"],
                st["frame_count"])
        (S, Smin, Stmp, lam, p_prev, xi_prev, G_prev, fc), gains = \
            jax.lax.scan(step, init, ps_t)
        st.update(S=S, Smin=Smin, Stmp=Stmp, lambda_d=lam, p_prev=p_prev,
                  xi_prev=xi_prev, G_prev=G_prev, frame_count=fc)

        G = jnp.moveaxis(gains, 0, -2)
        out_spec = spec * G.astype(spec.dtype)
        frames_out = jnp.fft.irfft(out_spec, n=self.N, axis=-1) \
            * jnp.asarray(self.win)
        # 50% overlap-add: out[f] = head(f) + tail(f-1)
        head = frames_out[..., :self.hop]
        tail = frames_out[..., self.hop:]
        prev = jnp.concatenate([st["ola"][..., None, :], tail[..., :-1, :]],
                               axis=-2)
        out = (head + prev).reshape(x.shape[:-1] + (Fn * self.hop,))
        st["ola"] = tail[..., -1, :]
        # hann² OLA at 50% sums to 1.0 with this periodic window
        return out.astype(jnp.float32), st
