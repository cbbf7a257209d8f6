"""Windowed decode fan-out — the subprocess-parallelism analog.

reference: the FT8 decoder slices VFO audio into 15 s windows and spawns
an isolated decoder process per window through a pre-fork server
(decoder_modules/ft8_decoder/src/ft8_decoder.h:150-212,
core/src/core.cpp:233-300 forkIt) so decoder crashes cannot take down the
app.  Here each completed window is dispatched to a process pool (true
isolation) or, for decoders that are just Python callables on jitted
kernels, run as independent dispatches; results arrive via callback in
completion order.

An external-command mode mirrors the reference's separate executable:
the window is piped to the command as float32 PCM on stdin and its
stdout lines are the decodes.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing
import os
import subprocess
import sys
import threading
from typing import Callable, List, Optional

import numpy as np


def run_external_decoder(cmd: List[str], audio: np.ndarray,
                         samplerate: float, timeout: float = 60.0):
    """Pipe float32 mono audio to an external decoder executable; return
    its stdout lines (simple pipe contract for Python-side decoders)."""
    proc = subprocess.run(
        cmd + [str(int(samplerate))],
        input=np.asarray(audio, np.float32).tobytes(),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        timeout=timeout)
    return proc.stdout.decode(errors="replace").splitlines()


def parse_mshv_line(line: str) -> Optional[dict]:
    """Parse one decoder output line (reference ft8_decoder.h:262-296:
    tab-split; FT8_OUT/FT4_OUT records take fields 4,6,8,10,12,14,16,18).
    """
    t = line.split("\t")
    if t[0] in ("FT8_OUT", "FT4_OUT") and len(t) > 18:
        keys = ("when_ms", "snr", "dt", "freq", "message",
                "info", "dt2", "freq2")
        return {"type": t[0], **{k: t[i] for k, i in
                                 zip(keys, range(4, 19, 2))}}
    if t[0] == "ERROR" and len(t) > 1:
        return {"type": "ERROR", "message": t[1]}
    if t[0] == "DECODE_EOF":
        return {"type": "DECODE_EOF"}
    return None


def run_mshv_decoder(cmd: List[str], audio: np.ndarray,
                     samplerate: float, mode: str = "FT8",
                     threads: int = 1, timeout: float = 30.0,
                     workdir: Optional[str] = None) -> List[dict]:
    """Reference-faithful ``sdrpp_ft8_mshv`` exec contract
    (ft8_decoder.h:196-312): write the window to a WAV file, spawn

        <decoder> <outPath> --decode <wavPath> --mode <FT8|FT4>
                  --threads <n>

    and POLL <outPath> while the decoder runs, collecting
    FT8_OUT/FT4_OUT/ERROR tab-separated records until DECODE_EOF (or
    timeout; the reference caps at 20 s, ft8_decoder.h:217)."""
    import os
    import tempfile
    import time as _time
    from ..io.wav import write_wav

    d = workdir or tempfile.mkdtemp(prefix="mshv_")
    os.makedirs(d, exist_ok=True)
    wav_path = os.path.join(d, "window.wav")
    out_path = os.path.join(d, "decode.out")
    write_wav(wav_path, np.asarray(audio, np.float32),
              samplerate, bits=16)
    if os.path.exists(out_path):
        os.unlink(out_path)
    argv = list(cmd) + [out_path, "--decode", wav_path,
                        "--mode", mode, "--threads", str(int(threads))]
    proc = subprocess.Popen(argv, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    results: List[dict] = []
    nsent = 0
    deadline = _time.monotonic() + timeout
    finished = False
    try:
        while not finished and _time.monotonic() < deadline:
            _time.sleep(0.1)
            if proc.poll() is not None and proc.returncode != 0:
                results.append({"type": "ERROR",
                                "message": "decoder exec failed"})
                break
            try:
                with open(out_path, "r", errors="replace") as f:
                    lines = [ln for ln in f.read().split("\n")
                             if ln.split("\t")[0] in
                             ("FT8_OUT", "FT4_OUT", "ERROR",
                              "DECODE_EOF")]
            except FileNotFoundError:
                continue
            for ln in lines[nsent:]:
                rec = parse_mshv_line(ln)
                if rec is None:
                    continue
                if rec["type"] == "DECODE_EOF":
                    finished = True
                    break
                results.append(rec)
            nsent = len(lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    # a failed or timed-out decoder must surface as an ERROR record even
    # when the deadline expires before the poll loop observes the exit
    # (reference ft8_decoder.h:222-228 reports every non-zero outcome)
    if not finished and not any(r["type"] == "ERROR" for r in results):
        msg = ("decoder exec failed" if proc.returncode not in (0, None)
               else "decoder timeout")
        results.append({"type": "ERROR", "message": msg})
    return results


def _pin_worker_to_cpu():
    os.environ["JAX_PLATFORMS"] = "cpu"
    if "jax" in sys.modules:
        sys.modules["jax"].config.update("jax_platforms", "cpu")


class WindowedDecodeRunner:
    """Accumulate samples; dispatch each full window to the decoder pool.

    decoder: callable(audio[np.float32], samplerate, t0_samples) -> result
    on_result: callable(result, t0_samples)
    """

    def __init__(self, samplerate: float, window_seconds: float,
                 decoder: Callable, on_result: Callable,
                 max_workers: int = 4, use_processes: bool = False):
        self.samplerate = float(samplerate)
        self.window_len = int(round(window_seconds * samplerate))
        self.decoder = decoder
        self.on_result = on_result
        if use_processes:
            # Workers pin JAX to the CPU before any task runs: one JAX
            # process already holds the accelerator, and a second one
            # that touched it would fail for want of device memory.
            self.pool = cf.ProcessPoolExecutor(
                max_workers=max_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_pin_worker_to_cpu)
        else:
            self.pool = cf.ThreadPoolExecutor(max_workers=max_workers)
        self._buf = np.zeros(0, np.float32)
        self._t0 = 0
        self._pending: set = set()
        self._lock = threading.Lock()
        self.windows_dispatched = 0
        self.decode_errors = 0

    def push(self, audio: np.ndarray):
        self._buf = np.concatenate([self._buf,
                                    np.asarray(audio, np.float32)])
        while len(self._buf) >= self.window_len:
            window = self._buf[:self.window_len].copy()
            self._buf = self._buf[self.window_len:]
            t0 = self._t0
            self._t0 += self.window_len
            fut = self.pool.submit(self.decoder, window, self.samplerate,
                                   t0)
            self.windows_dispatched += 1
            with self._lock:
                self._pending.add(fut)
            fut.add_done_callback(lambda f, t=t0: self._done(f, t))

    def _done(self, fut, t0):
        with self._lock:
            self._pending.discard(fut)
        try:
            result = fut.result()
        except Exception:
            # decoder crash is isolated — the app keeps running
            # (the reference gets this from fork-server process isolation)
            self.decode_errors += 1
            return
        self.on_result(result, t0)

    def drain(self, timeout: float = 60.0):
        with self._lock:
            pending = list(self._pending)
        cf.wait(pending, timeout=timeout)

    def shutdown(self):
        self.drain(timeout=10.0)
        self.pool.shutdown(wait=False, cancel_futures=True)
