"""RadioBank — many VFOs of mixed demod modes on one wideband baseband.

The reference runs each radio instance as an independent thread chain off
the IQFrontEnd splitter (reference: core/src/signal_path/
iq_frontend.cpp:159-202, decoder_modules/radio/src/radio_module.h).  Here
VFOs of the *same* mode batch into one compiled kernel (a [C, T] channel
axis), and a bank is a dict mode → batched Radio.  Retunes are runtime
params; adding/removing a VFO or switching its mode rebuilds only the
affected mode-group (the analog of selectDemod's rebuild,
radio_module.h:655-774).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..runtime.block import Block
from .radio import Radio, DEMOD_NAMES, DEMOD_IDS


class VFOSpec:
    def __init__(self, name: str, demod_id: int, offset_hz: float,
                 bandwidth: Optional[float] = None):
        self.name = name
        self.demod_id = demod_id
        self.offset_hz = float(offset_hz)
        self.bandwidth = bandwidth


# Group width from which "auto" takes the PFB channelized front end: the
# fused shared front end does O(C) work at the full input rate, the PFB
# path O(taps) per input sample.  The crossover has not been measured on
# the GPU yet.
CHANNELIZE_MIN_C = 16


class RadioBank:
    """Group VFO specs by demod mode; one batched Radio per group.

    ``channelize``: "auto" picks the front end per group — the
    2x-oversampled PFB channelized path (Radio.apply_channelized,
    O(C)-free at the input rate) for wide groups that satisfy
    Radio.can_channelize, the fused shared front end otherwise.
    """

    def __init__(self, in_samplerate: float, vfos: List[VFOSpec],
                 audio_samplerate: float = 48_000.0,
                 channelize: object = "auto", **radio_kwargs):
        self.in_samplerate = float(in_samplerate)
        self.audio_samplerate = float(audio_samplerate)
        self.groups: Dict[int, List[VFOSpec]] = {}
        for v in vfos:
            self.groups.setdefault(v.demod_id, []).append(v)
        self.radios: Dict[int, Radio] = {}
        self.channelized: Dict[int, bool] = {}
        for demod_id, group in self.groups.items():
            bw = group[0].bandwidth
            r = Radio(in_samplerate, demod_id, bandwidth=bw,
                      audio_samplerate=audio_samplerate, **radio_kwargs)
            self.radios[demod_id] = r
            if channelize == "auto":
                self.channelized[demod_id] = (
                    r.can_channelize() and len(group) >= CHANNELIZE_MIN_C)
            else:
                self.channelized[demod_id] = bool(channelize)
                if self.channelized[demod_id] and not r.can_channelize():
                    raise ValueError(
                        f"RadioBank: demod {demod_id} cannot channelize "
                        f"(in/IF ratio must be an even integer)")
        self.in_multiple = math.lcm(
            *[r.in_multiple for r in self.radios.values()]) \
            if self.radios else 1

    def _padded_c(self, d: int) -> int:
        """Groups of 1-3 channels pad to 4; whether the padding pays on
        the GPU is not measured yet.  Outputs are sliced back to the
        real count in apply()."""
        C = len(self.groups[d])
        return 4 if (not self.channelized[d] and C < 4) else C

    def init_state(self):
        return {d: (r.init_state_channelized(len(self.groups[d]))
                    if self.channelized[d]
                    else r.init_state_shared(self._padded_c(d)))
                for d, r in self.radios.items()}

    def make_params(self):
        out = {}
        for d, r in self.radios.items():
            offs = np.array([v.offset_hz for v in self.groups[d]])
            if self.channelized[d]:
                out[d] = r.make_params_channelized(offs)
            else:
                cp = self._padded_c(d)
                if cp > len(offs):
                    offs = np.concatenate(
                        [offs, np.repeat(offs[-1:], cp - len(offs))])
                out[d] = r.make_params_shared(offs)
        return out

    def apply(self, params, state, x, mono_out: bool = False):
        """x: [T] wideband → dict demod_id → ([C_d, 2, T_out_d], ...).

        Each mode group reads the wideband once, not C_d times: via the
        fused shared front end (ops/fused_frontend.py) or, for wide
        groups, the PFB channelizer (models/rx_vfo.py).

        ``mono_out``: skip the presentational stereo duplication
        ([C_d, T_out_d] instead) — the sink duplicates host-side, the
        same contract as the channelized scanner path, and it saves the
        device the L/R stack."""
        outs = {}
        new_state = {}
        for d, radio in self.radios.items():
            if self.channelized[d]:
                y, new_state[d] = radio.apply_channelized(
                    params[d], state[d], x, mono_out=mono_out)
            else:
                y, new_state[d] = radio.apply_shared(params[d], state[d],
                                                     x, mono_out=mono_out)
                C_real = len(self.groups[d])
                if (y.shape[0] if not isinstance(y, tuple)
                        else y[0].shape[0]) > C_real:
                    y = (y[0][:C_real], y[1][:C_real]) \
                        if isinstance(y, tuple) else y[:C_real]
            outs[d] = y
        return outs, new_state

    def jit_step(self):
        return jax.jit(lambda p, s, x: self.apply(p, s, x))

    def vfo_names(self) -> List[Tuple[str, int, int]]:
        """(name, demod_id, index within group)."""
        out = []
        for d, group in self.groups.items():
            for i, v in enumerate(group):
                out.append((v.name, d, i))
        return out
