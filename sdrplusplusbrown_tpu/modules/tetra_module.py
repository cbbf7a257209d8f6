"""TETRA demodulator module: 25 kHz channel → π/4-DQPSK → burst sync →
BSCH/AACH lower-MAC decode.

reference: decoder_modules/ch_tetra_demodulator (osmo-tetra derived) —
the JAX analog channels the wideband baseband through an RxVFO, runs
the jitted π/4-DQPSK front end (ops/demod_digital.py) and the
lower-MAC burst decoder (models/tetra.py).  Status surfaces the cell
identity (colour code, MCC/MNC), TDMA time and burst/CRC counters over
the control plane, like the reference's status commands."""

from __future__ import annotations

import threading

import numpy as np

from ..app import ModuleInstance
from ..models.rx_vfo import RxVFO
from ..models.tetra import TetraDownlinkDecoder
from ..ops.demod_digital import Pi4DQPSKDemod
from ..runtime.pump import Rechunker

TETRA_IF_SR = 36_000.0        # 2 samples/symbol at 18 ksym/s
TETRA_BW = 25_000.0


class TetraDemodulatorModule(ModuleInstance):
    def __init__(self, name: str, app, offset_hz: float = 0.0):
        super().__init__(name)
        self.app = app
        self.offset_hz = float(offset_hz)
        self._mtx = threading.Lock()
        self.decoder = TetraDownlinkDecoder()
        self._build()
        app.baseband_event.bind(self._on_baseband)

    def module_type(self) -> str:
        return "ch_tetra_demodulator"

    def _build(self):
        import jax
        sr = self.app.frontend.effective_sr
        chan = RxVFO(sr, TETRA_IF_SR, TETRA_BW,
                     offset_hz=self.offset_hz)
        dem = Pi4DQPSKDemod(18_000.0, TETRA_IF_SR)
        with self._mtx:
            self.chan = chan
            self.dem = dem
            self.cparams = chan.make_params(self.offset_hz)
            self.cstate = chan.init_state(())
            self.dstate = dem.init_state(())
            self._cstep = jax.jit(
                lambda p, s, x: chan.apply(p, s, x))
            self._dstep = jax.jit(
                lambda s, x: dem.apply(None, s, x))
            self.rc = Rechunker(int(np.lcm(chan.in_multiple, 1)))

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
                (d, dibit, valid), self.dstate = self._dstep(
                    self.dstate, y)
            db = np.asarray(dibit)[np.asarray(valid)]
            if db.size:
                self.decoder.push(db)

    @staticmethod
    def _clean(pdu):
        """JSON-safe copy (drops raw bit arrays)."""
        if pdu is None:
            return None
        return {k: v for k, v in pdu.items()
                if k not in ("sdu", "tmSdu")}

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        dec = self.decoder
        if cmd == "status":
            last = dec.sync_infos[-1].as_dict() if dec.sync_infos \
                else None
            done = dec.reassembler.completed
            return {"bursts": dec.bursts_seen,
                    "sync_decodes": len(dec.sync_infos),
                    "aach_decodes": len(dec.aach),
                    "cell": last,
                    "ndb_bursts": dec.ndb_seen,
                    "sch_hd_decodes": dec.sch_hd_decodes,
                    "sch_f_decodes": dec.sch_f_decodes,
                    "mac_pdu_counts": dict(dec.mac_pdu_counts),
                    "sysinfo": (self._clean(dec.sysinfo[-1])
                                if dec.sysinfo else None),
                    "tm_sdu_reassembled": len(done),
                    "last_tm_sdu": (self._clean(done[-1]) if done
                                    else None)}
        if cmd == "sysinfo":
            return {"sysinfo": [self._clean(p)
                                for p in dec.sysinfo[-20:]],
                    "mac_resource": [self._clean(p)
                                     for p in dec.mac_resource[-20:]]}
        if cmd == "tm_sdus":
            return {"tm_sdus": [self._clean(p) for p in
                                dec.reassembler.completed[-20:]]}
        if cmd == "sync_infos":
            return {"sync_infos": [s.as_dict()
                                   for s in dec.sync_infos[-50:]]}
        if cmd == "set_offset":
            self.set_offset(float(args))
            return {"status": "ok", "offset": self.offset_hz}
        return super().handle_debug_command(cmd, args)
