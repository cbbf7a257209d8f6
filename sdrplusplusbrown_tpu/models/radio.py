"""Radio — the demodulation pipeline ("model"), the analog of the
reference's radio decoder module.

reference: decoder_modules/radio/src/radio_module.h — a VFO feeds an IF
chain [NoiseBlanker, Squelch, FMIF] (radio_module.h:92-98), the selected
demodulator, then an AF chain [RationalResampler→48 kHz, Deemphasis]
(radio_module.h:100-107).  Demodulator IDs and their fixed IF rates
(reference: radio_module_interface.h:6-16 and demodulators/*.h):

    id  name  IF rate   default bw   default deemphasis
    0   NFM    50 kHz    12.5 kHz    none        (nfm.h:65,69)
    1   WFM   500 kHz   150 kHz      50 µs       (wfm.h:261-271)
    2   AM     15 kHz    10 kHz      none        (am.h:76-86)
    3   DSB    24 kHz     4.6 kHz    none        (dsb.h:69-79)
    4   USB    24 kHz     2.8 kHz    none        (usb.h:70-80)
    5   CW      3 kHz     0.2 kHz    none; 800 Hz tone (cw.h:82-86)
    6   LSB    24 kHz     2.8 kHz    none        (lsb.h:69-79)
    7   RAW    48 kHz    audio SR    none        (raw.h:48-59)

A demod switch builds a new compiled pipeline (the functional analog of
selectDemod's tempStop→re-splice→tempStart, radio_module.h:655-774).

Everything is batched over a leading channel axis: a Radio built with
``batch_shape=(C,)`` demodulates C VFOs of the same mode in one kernel;
mixed modes are grouped by the RadioBank (models/radio_bank.py).
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..runtime.block import Block, Chain
from ..ops import taps as taps_mod
from ..ops.demod import (FMDemod, AMDemod, SSBDemod, CWDemod, Squelch)
from ..ops.recurrence import Deemphasis, NoiseBlanker
from ..ops.fmif import FMIF
from ..ops.wfm import BroadcastFM
from ..ops.resampler import RationalResampler
from .rx_vfo import RxVFO

# reference: radio_module_interface.h:6-16 (RADIO_IFACE_MODE_* order)
DEMOD_NFM, DEMOD_WFM, DEMOD_AM, DEMOD_DSB = 0, 1, 2, 3
DEMOD_USB, DEMOD_CW, DEMOD_LSB, DEMOD_RAW = 4, 5, 6, 7

DEMOD_NAMES = ["NFM", "WFM", "AM", "DSB", "USB", "CW", "LSB", "RAW"]
DEMOD_IDS = {n: i for i, n in enumerate(DEMOD_NAMES)}

#: (IF samplerate, default bandwidth) per demod id; RAW uses audio SR.
DEMOD_IF_RATES = {
    DEMOD_NFM: (50_000.0, 12_500.0),
    DEMOD_WFM: (500_000.0, 150_000.0),
    DEMOD_AM: (15_000.0, 10_000.0),
    DEMOD_DSB: (24_000.0, 4_600.0),
    DEMOD_USB: (24_000.0, 2_800.0),
    DEMOD_CW: (3_000.0, 200.0),
    DEMOD_LSB: (24_000.0, 2_800.0),
    DEMOD_RAW: (48_000.0, 48_000.0),
}

DEEMP_TAUS = {"none": None, "22us": 22e-6, "50us": 50e-6, "75us": 75e-6}

#: Plugin-provided demodulators (the analog of the reference's
#: RadioModuleInterface::demodulatorProviders, radio_module_interface.h:19-60
#: — decoder modules like ch_extravhf_decoder register extra demods here).
#: name → factory(bandwidth, audio_sr) -> (Block, if_rate: float,
#: stereo: bool)
DEMOD_PROVIDERS: dict = {}


def register_demod_provider(name: str, factory):
    DEMOD_PROVIDERS[name.upper()] = factory


def list_demods():
    """Built-in names + plugin-provided names, built-ins in enum order."""
    return list(DEMOD_NAMES) + sorted(DEMOD_PROVIDERS)


class _RawDemod(Block):
    """RAW mode: complex IQ re-interpreted as L=I, R=Q stereo."""

    def apply(self, params, state, x):
        return jnp.stack([jnp.real(x), jnp.imag(x)], axis=-2) \
            .astype(jnp.float32), state


def make_demod(demod_id: int, bandwidth: float, audio_sr: float = 48_000.0,
               stereo: bool = True, rds: bool = False,
               pll_mode: str = "normalize", cw_tone: float = 800.0):
    if_rate = DEMOD_IF_RATES[demod_id][0]
    if demod_id == DEMOD_NFM:
        return FMDemod(if_rate, bandwidth, low_pass=True), if_rate, False
    if demod_id == DEMOD_WFM:
        return BroadcastFM(bandwidth / 2.0, if_rate, stereo=stereo,
                           low_pass=True, rds_out=rds,
                           pll_mode=pll_mode,
                           audio_rate=audio_sr), if_rate, True
    if demod_id == DEMOD_AM:
        return AMDemod(if_rate, bandwidth), if_rate, False
    if demod_id in (DEMOD_USB, DEMOD_LSB, DEMOD_DSB):
        mode = {DEMOD_USB: SSBDemod.USB, DEMOD_LSB: SSBDemod.LSB,
                DEMOD_DSB: SSBDemod.DSB}[demod_id]
        return SSBDemod(mode, bandwidth, if_rate), if_rate, False
    if demod_id == DEMOD_CW:
        return CWDemod(cw_tone, if_rate), if_rate, False
    if demod_id == DEMOD_RAW:
        return _RawDemod(), audio_sr, True
    raise ValueError(f"unknown demod id {demod_id}")


class Radio(Block):
    """Full per-VFO demodulation pipeline: RxVFO → IF chain → demod → AF."""

    def __init__(self, in_samplerate: float, demod_id: int,
                 bandwidth: Optional[float] = None,
                 audio_samplerate: float = 48_000.0,
                 offset_hz: float = 0.0,
                 stereo: bool = True, rds: bool = False,
                 deemphasis: Optional[str] = None,
                 nb_enabled: bool = False, squelch_enabled: bool = False,
                 squelch_level: float = -100.0, fmif_enabled: bool = False,
                 pll_mode: str = "normalize"):
        self.in_samplerate = float(in_samplerate)
        self.audio_samplerate = float(audio_samplerate)

        provider = None
        if isinstance(demod_id, str):
            name = demod_id.upper()
            if name in DEMOD_IDS:
                demod_id = DEMOD_IDS[name]
            elif name in DEMOD_PROVIDERS:
                provider = DEMOD_PROVIDERS[name]
                self.demod_name = name
            else:
                raise ValueError(f"unknown demodulator '{demod_id}'")
        self.demod_id = demod_id if provider is None else None
        if provider is None:
            self.demod_name = DEMOD_NAMES[demod_id]
            if bandwidth is None:
                bandwidth = DEMOD_IF_RATES[demod_id][1]
            self.bandwidth = float(bandwidth)
            self.demod, self.if_rate, self.demod_stereo = make_demod(
                demod_id, self.bandwidth, audio_samplerate, stereo, rds,
                pll_mode)
        else:
            # plugin-provided demodulator (radio_module_interface.h:19-60)
            spec = provider(bandwidth, audio_samplerate)
            self.demod = spec["block"]
            self.if_rate = float(spec["if_rate"])
            self.demod_stereo = bool(spec.get("stereo", False))
            self.bandwidth = float(spec.get("bandwidth")
                                   or bandwidth or self.if_rate)
            demod_id = DEMOD_NFM  # deemphasis/IF-chain defaults

        self.vfo = RxVFO(in_samplerate, self.if_rate, self.bandwidth,
                         offset_hz)

        # IF chain (reference radio_module.h:92-98; NB rate 500/24000 lvl 10,
        # FMIF 32 bins)
        self.nb = NoiseBlanker(500.0 / 24000.0, 10.0)
        self.squelch = Squelch(squelch_level)
        self.fmif = FMIF(32)
        self.nb_enabled = nb_enabled
        self.squelch_enabled = squelch_enabled
        self.fmif_enabled = fmif_enabled

        # AF chain (reference radio_module.h:100-107).  The demod may emit
        # audio below the IF rate (WFM's decimated MPX path, ops/wfm.py).
        af_in_rate = float(getattr(self.demod, "out_samplerate",
                                   self.if_rate))
        self.af_resamp = None
        if af_in_rate != self.audio_samplerate:
            self.af_resamp = RationalResampler(af_in_rate,
                                               self.audio_samplerate)
        if deemphasis is None:
            deemphasis = "50us" if demod_id == DEMOD_WFM else "none"
        self.deemp_tau = DEEMP_TAUS[deemphasis]
        self.deemp = (Deemphasis(self.deemp_tau, self.audio_samplerate)
                      if self.deemp_tau else None)
        # Fuse the de-emphasis into the demod's AF polyphase resampler
        # when both exist (WFM): its truncated-exponential FIR form
        # (recurrence.py) folds into the widened resampler kernel
        # (resampler.py:fold_output_fir), making the resampler's
        # input-side history the COMPLETE state of the cascade — one
        # HBM pass instead of resample + O(log T) de-emphasis sweeps.
        # The separate Deemphasis block remains the lowering everywhere
        # an AF resampler isn't present (reference AF-chain semantics,
        # radio_module.h:100-107, are unchanged: same cascade, fused).
        if (self.deemp is not None and self.deemp.fir_k
                and getattr(self.demod, "audio_poly", None) is not None):
            from ..ops.resampler import fold_output_fir
            self.demod.audio_poly = fold_output_fir(
                self.demod.audio_poly, self.deemp.impulse())
            self.deemp = None

        # --- static granularity: input length L must make every stage length
        # an exact integer multiple of its in_multiple.
        need = Fraction(self.vfo.in_multiple)
        r = self.vfo.ratio
        for blk in ([self.demod] if getattr(self.demod, "in_multiple", 1) > 1
                    else []):
            need = self._lcm(need, Fraction(blk.in_multiple) / r)
        r = r * getattr(self.demod, "ratio", Fraction(1))
        if self.af_resamp is not None:
            need = self._lcm(need, Fraction(self.af_resamp.in_multiple) / r)
            r = r * self.af_resamp.ratio
        # xlator outer-product span (ops/xlator.py) wants multiples of 1024
        # for long blocks; harmless for short ones.
        self.in_multiple = int(self._lcm(need, Fraction(1)))
        self.ratio = r

    @staticmethod
    def _lcm(a: Fraction, b: Fraction) -> Fraction:
        return Fraction(math.lcm(a.numerator, b.numerator),
                        math.gcd(a.denominator, b.denominator))

    # ------------------------------------------------------------------
    def init_state(self, batch_shape=()):
        st = {"vfo": self.vfo.init_state(batch_shape),
              "demod": self.demod.init_state(batch_shape)}
        if self.nb_enabled:
            st["nb"] = self.nb.init_state(batch_shape)
        if self.fmif_enabled:
            st["fmif"] = self.fmif.init_state(batch_shape)
        af_shape = batch_shape + (2,) if self.demod_stereo else batch_shape
        if self.af_resamp is not None:
            st["af_resamp"] = self.af_resamp.init_state(af_shape, jnp.float32)
        if self.deemp is not None:
            st["deemp"] = self.deemp.init_state(af_shape)
        return st

    def init_params(self):
        p = {"vfo": self.vfo.init_params()}
        if self.squelch_enabled:
            p["squelch"] = self.squelch.init_params()
        return p

    def make_params(self, offset_hz, squelch_level=None):
        p = {"vfo": self.vfo.make_params(offset_hz)}
        if self.squelch_enabled:
            lvl = squelch_level if squelch_level is not None \
                else self.squelch.default_level
            p["squelch"] = {"level": jnp.float32(lvl)}
        return p

    def _if_chain_empty(self) -> bool:
        return not (self.nb_enabled or self.squelch_enabled
                    or self.fmif_enabled)

    def _post_vfo(self, params, state, st, y, mono_out=False):
        """IF chain → demod → AF chain, shared by every front-end path."""
        if self.nb_enabled:
            y, st["nb"] = self.nb.apply(None, state["nb"], y)
        if self.squelch_enabled:
            y, _ = self.squelch.apply(params.get("squelch"), None, y)
        if self.fmif_enabled:
            y, st["fmif"] = self.fmif.apply(None, state["fmif"], y)
        y, st["demod"] = self.demod.apply(None, state["demod"], y)
        return self._post_demod(state, st, y, mono_out=mono_out)

    def _post_demod(self, state, st, y, mono_out=False):
        rds = None
        if isinstance(y, tuple):
            y, rds = y
        if self.af_resamp is not None:
            y, st["af_resamp"] = self.af_resamp.apply(
                None, state["af_resamp"], y)
        if self.deemp is not None:
            y, st["deemp"] = self.deemp.apply(None, state["deemp"], y)
        if not self.demod_stereo and not mono_out:
            # mono → stereo presentation copy; wide banks skip it
            # (``mono_out``) and let the sink duplicate host-side
            y = jnp.stack([y, y], axis=-2)
        if rds is not None:
            return (y, rds), st
        return y, st

    def apply(self, params, state, x):
        if x.shape[-1] % self.in_multiple:
            raise ValueError(
                f"Radio[{self.demod_name}]: block length "
                f"{x.shape[-1]} must be a multiple of in_multiple="
                f"{self.in_multiple}")
        if params is None:
            params = self.init_params()
        st = dict(state)
        y, st["vfo"] = self.vfo.apply(params["vfo"], state["vfo"], x)
        return self._post_vfo(params, state, st, y)

    # convenience: jitted step
    def jit_step(self):
        return jax.jit(lambda p, s, x: self.apply(p, s, x))


def _build_vfo_shared(self):
    from .rx_vfo import SharedRxVFOBank
    if getattr(self, "_vfo_shared", None) is None:
        self._vfo_shared = SharedRxVFOBank(
            self.vfo.in_samplerate, self.vfo.out_samplerate,
            self.vfo.bandwidth)
    return self._vfo_shared


def make_params_shared(self, offsets_hz, squelch_level=None):
    """Runtime params for apply_shared (same retune contract)."""
    vs = self._build_vfo_shared()
    p = {"vfo": vs.make_params(np.asarray(offsets_hz, np.float64))}
    if self.squelch_enabled:
        lvl = squelch_level if squelch_level is not None \
            else self.squelch.default_level
        p["squelch"] = {"level": jnp.float32(lvl)}
    return p


def init_state_shared(self, C: int):
    vs = self._build_vfo_shared()
    st = self.init_state((C,))
    st["vfo"] = vs.init_state(C)
    return st


def apply_shared(self, params, state, x, mono_out=False, spectrum=None):
    """x: [T] SHARED wideband — complex64, or (xr, xi) float32 planes —
    → same outputs as apply() on a C-broadcast copy, but the full-rate
    mix-down is fused into the first halfband (ops/fused_frontend.py)
    so the wideband is read once.  ``spectrum``: a SpectrumPath run on
    the same block; then returns ((audio, spectra), state')."""
    T_in = (x[0] if isinstance(x, tuple) else x).shape[-1]
    if T_in % self.in_multiple:
        raise ValueError(
            f"Radio[{self.demod_name}]: block length {T_in} must "
            f"be a multiple of in_multiple={self.in_multiple}")
    vs = self._build_vfo_shared()
    st = dict(state)
    if self._if_chain_empty() and hasattr(self.demod, "apply_planes"):
        # plane handoff: the discriminator eats the IF's re/im planes,
        # so the IF is never recombined into a complex array
        planes, st["vfo"] = vs.apply(params["vfo"], state["vfo"], x,
                                     return_planes=True)
        y, st["demod"] = self.demod.apply_planes(None, state["demod"],
                                                 planes)
        out, st = self._post_demod(state, st, y, mono_out=mono_out)
    else:
        y, st["vfo"] = vs.apply(params["vfo"], state["vfo"], x)
        out, st = self._post_vfo(params, state, st, y, mono_out=mono_out)
    if spectrum is None:
        return out, st
    spectra, _ = spectrum.apply(None, None, x)
    return (out, spectra), st


def can_channelize(self) -> bool:
    """True when the PFB front end can serve this demod config: the
    in/IF rate ratio is an even integer and the bandwidth leaves
    transition room (models/rx_vfo.py:ChannelizedRxVFOBank)."""
    r = self.in_samplerate / self.if_rate
    return (abs(r - round(r)) < 1e-9 and int(round(r)) % 2 == 0
            and self.bandwidth < self.if_rate)


def _build_vfo_channelized(self):
    from .rx_vfo import ChannelizedRxVFOBank
    if getattr(self, "_vfo_channelized", None) is None:
        self._vfo_channelized = ChannelizedRxVFOBank(
            self.vfo.in_samplerate, self.vfo.out_samplerate,
            self.vfo.bandwidth)
    return self._vfo_channelized


def make_params_channelized(self, offsets_hz, squelch_level=None):
    """Runtime params for apply_channelized (same retune contract)."""
    vb = self._build_vfo_channelized()
    p = {"vfo": vb.make_params(np.asarray(offsets_hz, np.float64))}
    if self.squelch_enabled:
        lvl = squelch_level if squelch_level is not None \
            else self.squelch.default_level
        p["squelch"] = {"level": jnp.float32(lvl)}
    return p


def init_state_channelized(self, C: int):
    vb = self._build_vfo_channelized()
    st = self.init_state((C,))
    st["vfo"] = vb.init_state(C)
    return st


def apply_channelized(self, params, state, x, mono_out=False):
    """x: [T] SHARED wideband (complex64 or (xr, xi) float32 planes) →
    per-channel audio via the 2×-oversampled PFB front end
    (ChannelizedRxVFOBank) — O(C)-free at the full input rate, the
    wide-bank/scanner path.  Signal-equivalent (not bit-near) to
    apply(): different anti-alias filters."""
    Tx = (x[0] if isinstance(x, tuple) else x).shape[-1]
    if Tx % self.in_multiple:
        raise ValueError(
            f"Radio[{self.demod_name}]: block length {Tx} must "
            f"be a multiple of in_multiple={self.in_multiple}")
    vb = self._build_vfo_channelized()
    st = dict(state)
    if isinstance(x, tuple):
        x = jax.lax.complex(*x)
    y, st["vfo"] = vb.apply(params["vfo"], state["vfo"], x)
    return self._post_vfo(params, state, st, y, mono_out=mono_out)


Radio._build_vfo_shared = _build_vfo_shared
Radio.make_params_shared = make_params_shared
Radio.init_state_shared = init_state_shared
Radio.apply_shared = apply_shared
Radio.can_channelize = can_channelize
Radio._build_vfo_channelized = _build_vfo_channelized
Radio.make_params_channelized = make_params_channelized
Radio.init_state_channelized = init_state_channelized
Radio.apply_channelized = apply_channelized
