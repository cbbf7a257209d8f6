"""FT8/FT4-style decoder module: 15 s window slicing + isolated decoding.

reference: decoder_modules/ft8_decoder — slices the VFO's 12 kHz audio
into 15 s windows aligned to the UTC cycle and ships each window to an
isolated decoder process (the vendored MSHV core runs as the separate
``sdrpp_ft8_mshv`` executable via the fork server, ft8_decoder.h:150-212).
This module provides the full runtime — window alignment,
pool/subprocess isolation, decode collection — with the decoder
pluggable: by default the built-in vectorized FT8 decoder
(models/ft8.py, batched candidate search + LDPC in one jitted call), or
an external command (the MSHV contract: float32 PCM on stdin, decode
lines on stdout) for drop-in use of the reference executable.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from ..app import ModuleInstance, RadioModuleInstance
from ..runtime.window_decoder import (WindowedDecodeRunner,
                                      run_external_decoder,
                                      run_mshv_decoder)
from ..ops.resampler import RationalResampler
from ..utils.flog import flog

FT8_WINDOW_S = 15.0
FT8_RATE = 12_000.0     # MSHV decoder input rate


def is_signal_strength(tok: str) -> bool:
    """symbolic.cpp:7-14 — ``+NN``/``-NN`` report token."""
    return (len(tok) >= 2 and tok[0] in "+-"
            and all(c.isdigit() for c in tok[1:]))


def is_locator(tok: str) -> bool:
    """symbolic.cpp:16-22 — 4-char Maidenhead square."""
    return (len(tok) == 4 and tok[0].isupper() and tok[1].isupper()
            and tok[0].isalpha() and tok[1].isalpha()
            and tok[2].isdigit() and tok[3].isdigit())


def extract_callsign_ft8(message: str) -> str:
    """Pull the sender's callsign out of a standard FT8 message
    (symbolic.cpp:25-46): ``... CALL LOC`` / ``... CALL RR73|RRR|73`` /
    ``DX CALL [R]±NN`` / ``CQ CALL``."""
    parts = message.split()
    if not parts:
        return ""
    last = parts[-1]
    if len(parts) > 1 and (last in ("RR73", "RRR", "73")
                           or is_locator(last)):
        return parts[-2]
    if len(last) > 2 and ((last[0] == "R" and is_signal_strength(last[1:]))
                          or is_signal_strength(last)):
        return parts[-2] if len(parts) > 1 else ""
    if len(parts) == 2 and parts[0] == "CQ":
        return parts[1]
    return ""


class FT8DecoderModule(ModuleInstance):
    def __init__(self, name: str, app, stream: str = "Radio",
                 decoder_cmd: Optional[List[str]] = None,
                 decoder_style: str = "pipe", mode: str = "FT8",
                 window_seconds: Optional[float] = None,
                 max_workers: int = 4, my_grid: str = "",
                 cty=None, psk_upload: Optional[dict] = None):
        super().__init__(name)
        self.app = app
        self.stream = stream
        self.decoder_cmd = decoder_cmd
        #: "mshv" = the reference sdrpp_ft8_mshv file contract
        #: (ft8_decoder.h:196-312); "pipe" = float32-on-stdin
        self.decoder_style = decoder_style
        self.mode = mode
        self.decodes: List[dict] = []
        self._native = None
        import jax
        self._resamp = RationalResampler(48_000.0, FT8_RATE)
        self._rs_state = self._resamp.init_state(())
        self._rs_step = jax.jit(
            lambda s, x: self._resamp.apply(None, s, x))
        self._buf = np.zeros(0, np.float32)
        if window_seconds is None:
            # FT8 transmits in 15 s cycles, FT4 in 7.5 s cycles
            window_seconds = 7.5 if mode == "FT4" else FT8_WINDOW_S
        self.window_seconds = float(window_seconds)
        #: own Maidenhead grid → decode distance column
        #: (main.cpp:983 gridToLatLng(lastLocation))
        self.my_grid = my_grid
        self.cty = cty      # utils.cty.CTY, or None to skip lookups
        # UTC cycle alignment: drop samples until the next window
        # boundary so windows line up with FT8 transmit periods
        # (approximate to pipeline latency; reference aligns the same way)
        self._skip_samples: Optional[int] = None
        # PSKReporter spot upload (reference main.cpp upload path):
        # psk_upload = {"callsign", "locator", optional "host"/"port",
        # "flush_seconds"}; spots batch and ship on the flush cadence
        self.psk = None
        self._psk_flush_s = 300.0
        self._psk_last_flush = time.time()
        if psk_upload and psk_upload.get("callsign"):
            from ..utils.pskreporter import PSKReporterClient
            kw = {}
            if psk_upload.get("host"):
                kw["host"] = psk_upload["host"]
            if psk_upload.get("port"):
                kw["port"] = int(psk_upload["port"])
            self.psk = PSKReporterClient(
                psk_upload["callsign"], psk_upload.get("locator", ""),
                **kw)
            self._psk_flush_s = float(psk_upload.get("flush_seconds",
                                                     300.0))
        self.runner = WindowedDecodeRunner(
            FT8_RATE, window_seconds, self._decode, self._on_result,
            max_workers=max_workers)
        m = app.modules.get(stream)
        if isinstance(m, RadioModuleInstance):
            m.audio_event.bind(self._on_audio)

    def module_type(self) -> str:
        return "ft8_decoder"

    # ------------------------------------------------------------------
    def _on_audio(self, audio: np.ndarray):
        import jax.numpy as jnp
        mono = audio[0] if audio.ndim == 2 else audio
        self._buf = np.concatenate([self._buf,
                                    np.asarray(mono, np.float32)])
        g = self._resamp.in_multiple
        n = (len(self._buf) // g) * g
        if n == 0:
            return
        blk, self._buf = self._buf[:n], self._buf[n:]
        y, self._rs_state = self._rs_step(
            self._rs_state, jnp.asarray(blk.astype(np.complex64)))
        samples = np.real(np.asarray(y)).astype(np.float32)
        if self._skip_samples is None:
            to_next = (self.window_seconds
                       - (time.time() % self.window_seconds)) \
                % self.window_seconds
            self._skip_samples = int(to_next * FT8_RATE)
        if self._skip_samples > 0:
            drop = min(self._skip_samples, len(samples))
            samples = samples[drop:]
            self._skip_samples -= drop
        if len(samples):
            self.runner.push(samples)

    def _decode(self, window: np.ndarray, samplerate: float, t0: int):
        if self.decoder_cmd and self.decoder_style == "mshv":
            return run_mshv_decoder(list(self.decoder_cmd), window,
                                    samplerate, mode=self.mode)
        if self.decoder_cmd:
            return run_external_decoder(list(self.decoder_cmd), window,
                                        samplerate)
        if self.mode in ("FT8", "FT4"):
            from ..models.ft8 import (FT4_PROTO, FT8_PROTO,
                                      FT4NativeDecoder, FT8NativeDecoder)
            proto = FT8_PROTO if self.mode == "FT8" else FT4_PROTO
            if len(window) >= proto.nsym * proto.sps(samplerate):
                # built-in native decoder (models/ft8.py): the whole
                # candidate search + LDPC batch is one jitted call
                if self._native is None:
                    cls = (FT8NativeDecoder if self.mode == "FT8"
                           else FT4NativeDecoder)
                    self._native = cls(samplerate)
                return self._native.decode(window)
            # fall through: the configured window is shorter than one
            # transmission (e.g. sped-up tests) — FT8/FT4 can't decode
        # fallback: report active tone candidates (lets the pipeline be
        # exercised without the external MSHV binary or a full slot)
        X = np.abs(np.fft.rfft(window * np.hanning(len(window))))
        floor = np.median(X)
        peaks = np.flatnonzero(X > 20 * floor)
        return [f"TONE {p * samplerate / len(window):.1f}Hz"
                for p in peaks[:16]]

    def _annotate(self, rec: dict):
        """Attach callsign/DXCC/continent/distance like the reference
        decode table (main.cpp:1232-1272). Hashed ``<call>`` tokens are
        not looked up (the reference drops those rows from its table;
        we keep the decode un-annotated)."""
        call = extract_callsign_ft8(rec.get("text", ""))
        if not call or "<" in call:
            return
        rec["callsign"] = call
        if self.cty is None:
            return
        from ..utils.cty import bearing_distance, grid_to_latlng
        cs = self.cty.find_callsign(call)
        if cs.dxccname:
            rec["dxcc"] = cs.dxccname
            rec["continent"] = cs.continent
        mypos = grid_to_latlng(self.my_grid) if self.my_grid else None
        if mypos is not None and mypos.is_valid() and cs.ll.is_valid():
            rec["distance_km"] = round(
                bearing_distance(mypos, cs.ll).distance, 1)

    def _on_result(self, lines, t0: int):
        for line in lines:
            if isinstance(line, dict):      # mshv record
                rec = {"t0": t0 / FT8_RATE, **line,
                       "text": line.get("message", "")}
            else:
                rec = {"t0": t0 / FT8_RATE, "text": str(line)}
            self._annotate(rec)
            self.decodes.append(rec)
            if self.psk is not None and rec.get("callsign"):
                dial = float(getattr(self.app, "frequency", 0.0) or 0.0)
                self.psk.add_spot(rec["callsign"],
                                  dial + float(rec.get("freq", 0.0)),
                                  float(rec.get("snr", 0.0)), self.mode)
        self.decodes = self.decodes[-200:]
        if self.psk is not None and self.psk.pending \
                and time.time() - self._psk_last_flush >= self._psk_flush_s:
            self.psk.flush()
            self._psk_last_flush = time.time()
        if lines:
            flog.info("ft8[{}]: {} decodes @ {}s", self.name, len(lines),
                      round(t0 / FT8_RATE, 1))

    def shutdown(self):
        self.runner.shutdown()
        if self.psk is not None:
            self.psk.flush()
            self.psk.close()

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        if cmd == "decodes":
            return {"decodes": self.decodes[-50:]}
        if cmd == "psk_flush":
            n = self.psk.flush() if self.psk is not None else 0
            return {"shipped": n,
                    "packets": (self.psk.packets_sent
                                if self.psk else 0)}
        if cmd == "status":
            return {"windows": self.runner.windows_dispatched,
                    "errors": self.runner.decode_errors,
                    "decodes": len(self.decodes)}
        if cmd == "clear":
            self.decodes = []
            return {"status": "ok"}
        if cmd == "set_grid":
            self.my_grid = args.strip()
            return {"status": "ok", "grid": self.my_grid}
        if cmd == "load_cty":
            from ..utils.cty import load_all_cty
            self.cty = load_all_cty(args.strip())
            return {"status": "ok",
                    "entities": len(self.cty.dxcc)}
        return super().handle_debug_command(cmd, args)
