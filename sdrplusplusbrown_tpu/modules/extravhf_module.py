"""ExtraVHF decoder module: DMR/P25 4FSK channel → DSD-style frame
sync (sync counts + voice/data classification over the control plane).

reference: decoder_modules/ch_extravhf_decoder — its vendored DSD
stack demodulates the 12.5 kHz channel (dsd_demod.cpp's dmrFilt +
slicer), runs ``findFrameSync`` over the dibit stream
(dsd_demod.cpp:136) and latches the frame state the burst processors
consume.  The JAX analog channels the wideband through an RxVFO, runs
the jitted 4FSK demod (ops/demod_digital.py FourFSKDemod) and the
batched sync correlation (models/dsd.py DSDFrameSync); the vendored
AMBE voice payload stack stays out of scope (README boundary note) —
status surfaces sync counts, types and cadence like the reference's
frame_status.
"""

from __future__ import annotations

import threading

import numpy as np

from ..app import ModuleInstance
from ..models.rx_vfo import RxVFO
from ..models.dmr_burst import DMRBurstProcessor
from ..ops.ctcss import CTCSSDetector, DCSDetector
from ..ops.demod_digital import FourFSKDemod
from ..runtime.pump import Rechunker

DMR_IF_SR = 16_000.0
DMR_BW = 12_500.0
DMR_SYMBOLRATE = 4_800.0
DMR_DEVIATION = 1_944.0


class ExtraVhfDecoderModule(ModuleInstance):
    def __init__(self, name: str, app, offset_hz: float = 0.0):
        super().__init__(name)
        self.app = app
        self.offset_hz = float(offset_hz)
        self._mtx = threading.Lock()
        # full burst layer past frame sync (models/dmr_burst.py; its
        # summary() is a superset of DSDFrameSync's)
        self.burst = DMRBurstProcessor()
        self.sync = self.burst.sync
        # analog subaudible squelch decoders (reference ctcss.h/dcs.h)
        # fed from the quadrature-demod audio of the same channel
        self.ctcss = CTCSSDetector(DMR_IF_SR)
        self.dcs = DCSDetector(DMR_IF_SR)
        self._build()
        app.baseband_event.bind(self._on_baseband)

    def module_type(self) -> str:
        return "ch_extravhf_decoder"

    def _build(self):
        import jax
        from ..ops.demod import Quadrature
        sr = self.app.frontend.effective_sr
        chan = RxVFO(sr, DMR_IF_SR, DMR_BW, offset_hz=self.offset_hz)
        dem = FourFSKDemod(DMR_SYMBOLRATE, DMR_IF_SR, DMR_DEVIATION)
        quad = Quadrature(DMR_DEVIATION, DMR_IF_SR)
        with self._mtx:
            self.chan = chan
            self.dem = dem
            self.quad = quad
            self.cparams = chan.make_params(self.offset_hz)
            self.cstate = chan.init_state(())
            self.dstate = dem.init_state(())
            self.qstate = quad.init_state(())
            self._cstep = jax.jit(lambda p, s, x: chan.apply(p, s, x))
            self._dstep = jax.jit(lambda s, x: dem.apply(None, s, x))
            self._qstep = jax.jit(lambda s, x: quad.apply(None, s, x))
            # ~0.1 s blocks: the adaptive 4FSK slicer needs a few
            # hundred symbol instants per block for its level estimate
            # (a bare in_multiple block holds 0-1 symbols)
            g = int(chan.in_multiple)
            blk = ((int(0.1 * sr) + g - 1) // g) * g
            self.rc = Rechunker(blk)

    def set_offset(self, offset_hz: float):
        with self._mtx:
            self.offset_hz = float(offset_hz)
            self.cparams = self.chan.make_params(self.offset_hz)

    def _on_baseband(self, iq: np.ndarray):
        if not self.is_enabled():
            return
        import jax.numpy as jnp
        for chunk in self.rc.push(iq):
            with self._mtx:
                y, self.cstate = self._cstep(self.cparams, self.cstate,
                                             jnp.asarray(chunk))
                (soft, dibit, valid), self.dstate = self._dstep(
                    self.dstate, y)
                audio, self.qstate = self._qstep(self.qstate, y)
            db = np.asarray(dibit)[np.asarray(valid)]
            if db.size:
                self.burst.push(db)
            af = np.asarray(audio)
            self.ctcss.push(af)
            self.dcs.push(af)

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        if cmd == "status":
            out = self.burst.summary()
            out["ctcss"] = self.ctcss.summary()
            out["dcs"] = self.dcs.summary()
            return out
        if cmd == "set_offset":
            self.set_offset(float(args))
            return {"status": "ok", "offset": self.offset_hz}
        return super().handle_debug_command(cmd, args)
