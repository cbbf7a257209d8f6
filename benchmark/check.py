"""The output check: what the timed pump produced against the reference.

The window keeps the outputs of a seeded sample of its blocks: the
baseband the front end fetched, the last spectrum line it produced, and
the audio every radio delivered to its sink stream. Each kept block ``k``
of the stream is compared with the reference's block ``k mod P`` of the
periodic steady state, ``P`` being the capture's period in pump blocks
(see ``traffic.py``). The window starts after a full period of warm-up,
and no earlier than the slowest radio needs to settle, so every kept
block is past the program's own start-up transient too.

Numbers compared (each with the limit the configuration file states):

* ``baseband_max_abs_diff``: the fetched baseband against the capture
  (exact: the front end has no decimation, DC block or inversion here);
* ``spectrum_db_rms``: the worst line's RMS difference, in dB, from the
  reference's windowed FFT;
* ``<MODE>_audio_err``: the worst block's error power over its reference
  power, for each radio mode of the cell. A product detector (USB)
  leaves the carrier phase undefined, and the program's float32 NCO
  drifts by about 6e-5 rad per 120 000 samples, so USB audio is compared
  after turning the reference by the one phase that fits each block;
* ``missing_audio_blocks``: radio-blocks of the window whose audio did
  not reach the sink stream in full;
* the signal oracles on the program's own output: the lowest tone SNR
  of any radio, the lowest stereo separation (WFM), the lowest SDR++
  spectrum SNR on a carrier.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Dict, List

import numpy as np

from . import reference, signals

#: seconds of stream after which a mode's output no longer depends on
#: the state it started from: the FIR-only chains remember far less
#: than a block; the AGC chains settle over ten of their 0.2 s decay
#: time constants. The window starts no earlier than this.
SETTLE_S = {"WFM": 0.0, "NFM": 0.0}
AGC_SETTLE_S = 2.0


def settle_blocks(radios, samplerate: float, block: int) -> int:
    """Pump blocks the slowest radio needs to settle (at least one)."""
    s = max(SETTLE_S.get(r.demod, AGC_SETTLE_S) for r in radios)
    return max(1, -(-int(round(s * samplerate)) // block))


def _reference_audio(tr, config, block, period, radio, nq):
    """Steady-state audio of ``radio`` for one period of stream blocks,
    from a zeroed start far enough back for it to have settled. A chain
    with an AGC starts at the stream's start, as the program's does, so
    that the AGC's start ramp lies where it lies in the program."""
    settle = settle_blocks([radio], tr.samplerate, block)
    periods = max(1, -(-settle // period))
    end = (periods + 1) * period
    start = 0 if radio.demod not in SETTLE_S else end - period - settle
    n = np.arange(start * block, end * block) % len(tr.capture)
    y = reference.radio(tr.capture[n].astype(np.complex128), start * block,
                        block, config, radio.demod, radio.offset_hz, nq)
    per = y.shape[-1] // (end - start)
    return y[..., (end - period - start) * per:]


def reference_outputs(tr, config, block: int, kept: Dict[int, dict],
                      control: bool = False, workers: int = 8):
    """Reference outputs for the kept blocks: {k: {"bb", "line",
    "audio": {radio: array}}}, float64 (``control``: bfloat16)."""
    nq = reference.Numerics(control)
    period = len(tr.capture) // block
    with cf.ThreadPoolExecutor(max(1, min(workers, os.cpu_count() or 1))) \
            as ex:
        futs = {r.name: ex.submit(_reference_audio, tr, config, block,
                                  period, r, nq) for r in tr.radios}
        steady = {name: f.result() for name, f in futs.items()}
    fft_size = int(config["fftSize"])
    interval = int(round(config["samplerate"] / config["fftRate"]))
    nz = min(interval, fft_size)
    frames = block // interval
    out = {}
    for k in kept:
        j = k % period
        start = (j * block + (frames - 1) * interval)
        idx = np.arange(start, start + nz) % len(tr.capture)
        line = reference.spectrum_line(tr.capture[idx].astype(np.complex128),
                                       fft_size, nq)
        bb = tr.capture[j * block:(j + 1) * block]
        audio = {}
        for name, y in steady.items():
            per = y.shape[-1] // period
            audio[name] = y[..., j * per:(j + 1) * per]
        out[k] = {"bb": nq.q(bb), "line": line, "audio": audio}
    return out


def _err(got, ref):
    return float(np.sum((got - ref) ** 2) / max(np.sum(ref ** 2), 1e-300))


def _usb_err(got, iq):
    """Error after turning the reference by the phase that fits best."""
    yi, yq = iq[0], iq[1]
    d = np.arctan2(-np.sum(got * yq), np.sum(got * yi))
    return _err(got, np.cos(d) * yi - np.sin(d) * yq), float(d)


def numbers(tr, config, kept: Dict[int, dict], ref: Dict[int, dict],
            missing: int) -> Dict[str, float]:
    """The numbers compared, from the program's kept outputs and the
    reference's."""
    fs = float(config["samplerate"])
    audio_sr = float(config["audio_samplerate"])
    out = {"missing_audio_blocks": float(missing)}
    bb = [float(np.max(np.abs(kept[k]["bb"] - ref[k]["bb"])))
          for k in kept]
    out["baseband_max_abs_diff"] = max(bb) if bb else float("inf")
    out["spectrum_db_rms"] = max(
        (float(np.sqrt(np.mean((np.asarray(kept[k]["line"], np.float64)
                                - ref[k]["line"]) ** 2))) for k in kept),
        default=float("inf"))
    errs: Dict[str, List[float]] = {}
    tone, sep, car, phase = [], [], [], [0.0]
    for r in tr.radios:
        for k in kept:
            got = kept[k]["audio"].get(r.name)
            want = ref[k]["audio"][r.name]
            if got is None or got.shape[-1] != want.shape[-1]:
                errs.setdefault(r.demod, []).append(float("inf"))
                continue
            got = np.asarray(got, np.float64)
            if r.demod == "USB":
                e, d = _usb_err(got, want)
                phase.append(abs(d))
            else:
                e = _err(got, want)
            errs.setdefault(r.demod, []).append(e)
            tone.append(signals.tone_snr(got[0], r.tones_hz[0], audio_sr))
            if r.demod == "WFM":
                sep.append(signals.stereo_separation_db(
                    got, r.tones_hz[0], r.tones_hz[1], audio_sr))
            car.append(signals.vfo_snr_db(kept[k]["line"], r.offset_hz,
                                          r.bandwidth, fs))
    for mode, e in sorted(errs.items()):
        out[f"{mode}_audio_err"] = max(e)
    out["tone_snr_min_db"] = min(tone, default=float("-inf"))
    if any(r.demod == "WFM" for r in tr.radios):
        out["stereo_sep_min_db"] = min(sep, default=float("-inf"))
    out["carrier_snr_min_db"] = min(car, default=float("-inf"))
    out["_usb_phase_max_rad"] = max(phase)
    return out


def judge(values: Dict[str, float], limits: Dict[str, dict]):
    """[(name, value, bound kind, limit, ok)] for every compared number;
    a number without a limit, or a limit without a number, fails."""
    rows = []
    for name in sorted(set(values) | set(limits)):
        if name.startswith("_"):
            continue
        v, lim = values.get(name), limits.get(name, {})
        if "max" in lim:
            rows.append((name, v, "max", lim["max"],
                         v is not None and v <= lim["max"]))
        elif "min" in lim:
            rows.append((name, v, "min", lim["min"],
                         v is not None and v >= lim["min"]))
        else:
            rows.append((name, v, "none", None, False))
    return rows
