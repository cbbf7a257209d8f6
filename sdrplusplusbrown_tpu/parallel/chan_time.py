"""Time×channel sharded CHANNELIZED radio pipeline — the production
wide-bank path (PFB front end) under ``shard_map``.

The single-device scanner path (models/radio.py:apply_channelized) is a
2×-oversampled polyphase channelizer feeding the per-channel gather,
fine NCO, 2:1 decimation and bandwidth FIR, then the demod and audio
chain.  This module runs that SAME architecture over a
``("time", "ch")`` mesh:

* the wideband is time-sharded; the PFB's streaming state is a pure
  function of the last ``halo_len`` raw input samples
  (ops/channelizer.py:state_from_tail), so one ``ppermute`` of that raw
  tail gives every shard an exact channelizer state — no sequential
  relay;
* every downstream stage's overlap-save state is likewise a pure
  function of a short trailing window of an OBSERVABLE intermediate
  (the PFB bins, the final IF) — each shard reconstructs the state its
  RIGHT neighbour needs from its own trailing bins/IF window with the
  blocks' own ``apply`` methods, and one ppermute ships the small state
  pytree instead of re-running any heavy kernel;
* the fine-NCO phase advances analytically (mod-2π spans computed host-
  side in float64, the ops/xlator.py discipline), so shard i starts at
  the exact global phase;
* channels are data-parallel over "ch" (each ch-shard runs the full PFB
  on its replicated time slice — O(taps) per wideband sample, cheap next
  to the per-channel tail at scanner widths);
* the squelch gate needs the GLOBAL block's mean |IF| (reference:
  noise_reduction/squelch.h:55-69): per-shard sums are ``psum``ed over
  "time".

Demod coverage (round 4): mono FM/NFM takes a zero-relay fast path
(every demod state is reconstructed from a short trailing IF window);
WFM stereo, de-emphasized NFM, AM and SSB/CW run the shared
``DemodTail`` (parallel/radio_time.py) — per-block stream_shard rules
(halo, affine scan, relay, the documented AGC approximation) on the
PFB front end's IF, exactly as ShardedRadioPipeline runs them on the
fused-VFO front end.

Exactness: equal to the unsharded ``apply_channelized`` stream (same
stages, same state conventions) up to float32 phase-table rounding;
tests/test_chan_time.py asserts >55 dB stream equality for
NFM/WFM-stereo/AM/USB/NFM-deemph.  Equality oracles score POPULATED
channels: an idle FM channel demodulates noise floor whose quadrature
angle is a chaotic ±π-wrap walk — both pipelines are 'correct' there
but decohere from f32 rounding.

reference: core/src/server.cpp:84-180 (the multi-host scale-out being
redesigned), core/src/dsp/channel/rx_vfo.h:89-121 (per-channel chain).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..models.radio import Radio, DEMOD_NFM
from ..ops.demod import FMDemod
from ..ops.xlator import rotor, advance_phase, _TWO_PI
from .halo import left_halo, last_shard_tail

TIME_AXIS = "time"
CH_AXIS = "ch"


def _pshift_right(tree, carry_tree, axis_name: str):
    """Ship each shard's pytree to its right neighbour; shard 0 receives
    ``carry_tree`` (the stream-level carry)."""
    size = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)

    def shift(leaf, cleaf):
        leaf = jnp.asarray(leaf)
        if size == 1:
            recv = jnp.zeros_like(leaf)
        else:
            perm = [(i, i + 1) for i in range(size - 1)]
            recv = jax.lax.ppermute(leaf, axis_name, perm=perm)
        return jnp.where(idx == 0, cleaf.astype(leaf.dtype), recv)

    return jax.tree.map(shift, tree, carry_tree)


def _last_shard(tree, axis_name: str):
    """Each leaf of the LAST time shard, replicated to every shard —
    the new stream-level carry."""
    size = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)

    def pick(leaf):
        leaf = jnp.asarray(leaf)
        if size == 1:
            return leaf
        if jnp.iscomplexobj(leaf):
            re = pick(jnp.real(leaf))
            im = pick(jnp.imag(leaf))
            return jax.lax.complex(re, im)
        masked = jnp.where(idx == size - 1, leaf, jnp.zeros_like(leaf))
        return jax.lax.psum(masked, axis_name)

    return jax.tree.map(pick, tree)


class ShardedChannelizedPipeline:
    """BASELINE config 5 on the production architecture: C NFM channels
    on one wideband, PFB-channelized, time×channel sharded."""

    def __init__(self, in_samplerate: float, mesh: Mesh, n_channels: int,
                 t_local: int, demod_id=DEMOD_NFM,
                 squelch_enabled: bool = True,
                 spectrum_fft: int = 0, spectrum_rate: float = 20.0,
                 **radio_kwargs):
        radio_kwargs.setdefault("pll_mode", "normalize")
        self.radio = Radio(in_samplerate, demod_id,
                           squelch_enabled=squelch_enabled,
                           **radio_kwargs)
        r = self.radio
        if not r.can_channelize():
            raise ValueError("demod config cannot use the PFB front end")
        # mono FM/NFM takes the zero-relay reconstruction fast path
        # (demod states are pure functions of a short IF tail); every
        # other mode (WFM stereo, deemphasized NFM, AM/SSB/CW) runs the
        # shared per-block DemodTail (radio_time.py) on the PFB front
        # end — same sharding rules as ShardedRadioPipeline
        self._nfm_fast = (isinstance(r.demod, FMDemod)
                          and r.demod.filtering and r.deemp is None
                          and not r.demod_stereo)
        self.vb = vb = r._build_vfo_channelized()
        self.mesh = mesh
        self.nt = mesh.shape[TIME_AXIS]
        self.nc = mesh.shape[CH_AXIS]
        self.C = int(n_channels)
        assert self.C % self.nc == 0, (self.C, self.nc)
        self.C_local = self.C // self.nc
        self.M = vb.M
        self.samplerate = float(in_samplerate)

        # ---- geometry ----------------------------------------------------
        g = self.granularity(r)
        assert t_local % g == 0, (
            f"t_local {t_local} must be a multiple of {g}")
        self.t_local = int(t_local)
        self.t_global = self.t_local * self.nt
        self.Tb_local = 2 * self.t_local // self.M      # bin-rate samples
        self.m_if = self.t_local // self.M              # IF samples/shard

        self.h_pfb = vb.chz.halo_len
        self.Kd2 = int(vb.decim2.K)
        self.Kbw = int(vb.fir.K) if vb.filter_needed else 0
        # gathered-signal window that determines the post-channelizer
        # states: K_d2-1 bin samples (decim2 history) plus 2 per needed
        # decim2 output (bandwidth-FIR history)
        self.n_gath = (self.Kd2 - 1) + 2 * max(self.Kbw - 1, 0)
        assert self.n_gath <= self.Tb_local, (self.n_gath, self.Tb_local)

        d = r.demod
        if self._nfm_fast:
            self.Kf = int(d.fir.K)
            poly = None
            if r.af_resamp is not None:
                nb = r.af_resamp.chain.named_blocks
                assert len(nb) == 1 and nb[0][0] == "resamp", nb
                poly = nb[0][1]
            self.poly = poly
            self.tppP = int(poly.tpp) if poly is not None else 1
            # IF window that determines quad + audio-FIR + AF-poly
            # states
            self.n_if = 1 + (self.Kf - 1) + (self.tppP - 1)
            assert self.n_if <= self.m_if, (self.n_if, self.m_if)
            self.m_aud = (self.m_if * poly.interp // poly.decim
                          if poly is not None else self.m_if)
            self.tail = None
        else:
            from fractions import Fraction
            from .radio_time import DemodTail
            self.tail = DemodTail(r, self.C)
            if2aud = (Fraction(getattr(d, "ratio", 1))
                      * (r.af_resamp.ratio if r.af_resamp is not None
                         else Fraction(1)))
            m_aud = Fraction(self.m_if) * if2aud
            assert m_aud.denominator == 1, (self.m_if, if2aud)
            self.m_aud = int(m_aud)
        self.t_out_local = self.m_aud

        self.spectrum = None
        if spectrum_fft:
            from ..ops.spectrum import SpectrumPath
            self.spectrum = SpectrumPath(in_samplerate, spectrum_fft,
                                         spectrum_rate)
            assert t_local % self.spectrum.in_multiple == 0, (
                t_local, self.spectrum.in_multiple)

        self._step = self._build_step()

    # ------------------------------------------------------------------
    @staticmethod
    def granularity(radio: Radio) -> int:
        """Smallest valid t_local quantum: PFB frames (M), decim2
        pairs, and the demod + AF chain's input multiples all mapped to
        the input rate (1 IF sample == M input samples)."""
        from fractions import Fraction
        vb = radio._build_vfo_channelized()
        d = radio.demod

        def lcm_frac(a: Fraction, b: Fraction) -> Fraction:
            return Fraction(math.lcm(a.numerator, b.numerator),
                            math.gcd(a.denominator, b.denominator))

        need_if = Fraction(int(getattr(d, "in_multiple", 1)))
        ratio = Fraction(getattr(d, "ratio", 1))
        if radio.af_resamp is not None:
            need_if = lcm_frac(need_if,
                               Fraction(radio.af_resamp.in_multiple)
                               / ratio)
        # smallest INTEGER IF-sample count that is a multiple of need_if
        p, q = need_if.numerator, need_if.denominator
        g_if = p // math.gcd(p, q)
        return vb.M * max(g_if, 1)

    # ------------------------------------------------------------------
    def make_params(self, offsets_hz, squelch_level=None) -> dict:
        """Same retune contract as Radio.make_params_channelized: offsets
        and squelch level are runtime params, never a recompile."""
        offs = np.asarray(offsets_hz, np.float64)
        assert offs.shape == (self.C,), offs.shape
        p = dict(self.vb.make_params(offs))
        # residual-NCO omega per BIN sample (float64 host-side)
        out_sr = self.vb.out_samplerate
        k = np.round(offs / out_sr)
        delta = offs - k * out_sr
        omega = -delta * (_TWO_PI / (2.0 * out_sr))
        p["xl_shard"] = jnp.asarray(
            np.mod(omega * self.Tb_local, _TWO_PI), jnp.float32)
        p["xl_ntail"] = jnp.asarray(
            np.mod(omega * self.n_gath, _TWO_PI), jnp.float32)
        if self.radio.squelch_enabled:
            lvl = squelch_level if squelch_level is not None \
                else self.radio.squelch.default_level
            p["squelch_level"] = jnp.float32(lvl)
        return p

    def init_carry(self) -> dict:
        C, r = self.C, self.radio
        front = {"xl": jnp.zeros((C,), jnp.float32),
                 "d2": jnp.zeros((C, self.Kd2 - 1), jnp.complex64)}
        if self.vb.filter_needed:
            front["fir"] = jnp.zeros((C, self.Kbw - 1), jnp.complex64)
        if self._nfm_fast:
            demod = {"quad": jnp.ones((C, 1), jnp.complex64),
                     "fir": jnp.zeros((C, self.Kf - 1), jnp.float32)}
            af = ({"resamp": jnp.zeros((C, self.tppP - 1), jnp.float32)}
                  if self.poly is not None else {})
        else:
            demod = self.tail.init_carry()
            af = {}
        return {"x_tail": jnp.zeros((self.h_pfb,), jnp.complex64),
                "front": front, "demod": demod, "af": af}

    # ------------------------------------------------------------------
    def _front_tail_states(self, params, bins_tail_c, end_phase):
        """State pytree the RIGHT neighbour's front end needs, computed
        from this shard's trailing ``n_gath`` complex bins and its END
        phase (== the neighbour's start phase)."""
        vb = self.vb
        y = jnp.take(bins_tail_c, params["bin"], axis=0)
        start = jnp.mod(end_phase - params["xl_ntail"], _TWO_PI)
        rot = rotor(start, params["xl"]["omega"],
                    params["xl"]["omega_span"], self.n_gath)
        y = y * rot
        st = {"xl": end_phase, "d2": y[..., -(self.Kd2 - 1):]}
        if vb.filter_needed:
            d2o, _ = vb.decim2.apply(None, y[..., :self.Kd2 - 1],
                                     y[..., self.Kd2 - 1:])
            st["fir"] = d2o
        return st

    def _demod_tail_states(self, if_tail_c):
        """Demod + AF state pytrees from the trailing ``n_if`` (gated)
        IF samples."""
        d = self.radio.demod
        qout, _ = d.quad.apply(None, if_tail_c[..., :1],
                               if_tail_c[..., 1:])
        dst = {"quad": if_tail_c[..., -1:],
               "fir": qout[..., -(self.Kf - 1):]}
        ast = {}
        if self.poly is not None:
            aud, _ = d.fir.apply(None, qout[..., :self.Kf - 1],
                                 qout[..., self.Kf - 1:])
            ast = {"resamp": aud}
        return dst, ast

    # ------------------------------------------------------------------
    def _local_step(self, params, carry, x_local):
        r, vb = self.radio, self.vb
        ta = TIME_AXIS
        t_idx = jax.lax.axis_index(ta).astype(jnp.float32)
        nt = jax.lax.axis_size(ta)

        # ---- channelizer state from the raw-input halo -----------------
        xt = left_halo(x_local, self.h_pfb, ta, carry["x_tail"])
        chz_state = vb.chz.state_from_tail(xt)

        # ---- PFB bins ---------------------------------------------------
        Tb = self.Tb_local
        bins_c, _ = vb.chz.apply(None, chz_state, x_local)
        bins_tail_c = bins_c[..., Tb - self.n_gath:]

        # ---- exact per-shard NCO phase -----------------------------------
        phase0 = jnp.mod(carry["front"]["xl"]
                         + params["xl_shard"] * t_idx, _TWO_PI)
        end_phase = jnp.mod(phase0 + params["xl_shard"], _TWO_PI)

        # ---- front states: reconstruct for the right neighbour ----------
        front_out = self._front_tail_states(params, bins_tail_c,
                                            end_phase)
        carry_front = {k: v for k, v in carry["front"].items()}
        front_in = _pshift_right(front_out, carry_front, ta)
        front_in["xl"] = phase0     # analytic (identical, but cheaper)

        # ---- post-channelizer --------------------------------------------
        y = jnp.take(bins_c, params["bin"], axis=0)
        rot = rotor(phase0, params["xl"]["omega"],
                    params["xl"]["omega_span"], Tb)
        y = y * rot
        y, _ = vb.decim2.apply(None, front_in["d2"], y)
        if vb.filter_needed:
            y, _ = vb.fir.apply(None, front_in["fir"], y)
        sq_sums = jnp.sum(jnp.abs(y), axis=-1)

        # ---- squelch gate over the GLOBAL block --------------------------
        gate = None
        if r.squelch_enabled:
            total = jax.lax.psum(sq_sums, ta)
            mean_amp = total / jnp.float32(self.m_if * self.nt)
            power_db = 10.0 * jnp.log10(jnp.maximum(mean_amp, 1e-20))
            gate = (power_db >= params["squelch_level"]
                    ).astype(jnp.float32)

        if self._nfm_fast:
            # ---- demod states from the gated IF tail ---------------------
            tr = y[..., -self.n_if:]
            if gate is not None:
                tr = tr * gate[:, None]
            demod_out, af_out = self._demod_tail_states(tr)
            shifted = _pshift_right(
                {"d": demod_out, "a": af_out},
                {"d": carry["demod"], "a": carry["af"]}, ta)
            dp, ap = shifted["d"], shifted["a"]

            # ---- demod + audio -------------------------------------------
            yc = y * gate[:, None] if gate is not None else y
            audio, _ = r.demod.apply(None, dp, yc)
            if r.af_resamp is not None:
                audio, _ = r.af_resamp.apply(None, ap, audio)
            demod_new = _last_shard(demod_out, ta)
            af_new = _last_shard(af_out, ta)
            out = jnp.stack([audio, audio], axis=-2).astype(jnp.float32)
        else:
            # ---- generic demod tail (shared per-block sharding rules) ----
            yc = y * gate[:, None] if gate is not None else y
            out, _rds, demod_new = self.tail.apply(carry["demod"], yc,
                                                   self.m_if)
            af_new = {}

        # ---- new stream-level carry ---------------------------------------
        new_carry = {
            "x_tail": last_shard_tail(x_local, self.h_pfb, ta),
            "front": _last_shard(front_out, ta),
            "demod": demod_new,
            "af": af_new,
        }
        new_carry["front"]["xl"] = jnp.mod(
            carry["front"]["xl"] + params["xl_shard"] * nt, _TWO_PI)

        if self.spectrum is not None:
            spectra, _ = self.spectrum.apply(None, None, x_local)
            return (out, spectra), new_carry
        return out, new_carry

    # ------------------------------------------------------------------
    def _specs(self, tree):
        def spec(leaf):
            leaf = jnp.asarray(leaf)
            if leaf.ndim >= 1 and leaf.shape[0] == self.C:
                return P(CH_AXIS, *([None] * (leaf.ndim - 1)))
            return P(*([None] * leaf.ndim))
        return jax.tree.map(spec, tree)

    def _build_step(self):
        params0 = self.make_params(np.zeros((self.C,)))
        carry0 = self.init_carry()
        cspecs = self._specs(carry0)
        cspecs["x_tail"] = P(None)      # raw-input halo is replicated
        audio_spec = P(CH_AXIS, None, TIME_AXIS)
        out_specs = ((audio_spec, P(TIME_AXIS, None))
                     if self.spectrum is not None else audio_spec,
                     cspecs)
        fn = jax.shard_map(
            self._local_step, mesh=self.mesh,
            in_specs=(self._specs(params0), cspecs, P(TIME_AXIS)),
            out_specs=out_specs,
            check_vma=False)
        return jax.jit(fn)

    def step(self, params, carry, x):
        """x [t_global] complex64 → ([C, 2, m_aud·nt] audio, carry')."""
        return self._step(params, carry, x)
