"""The one traffic generator: a traffic file → a seeded capture and the
radios tuned to it.

A traffic file (``traffic/<name>.json``) lists carriers, each with its
modulation (``kind``), the radio mode that demodulates it, the offset of
the radio's VFO from the capture's centre and its tones. The capture is
``capture_s`` seconds long and is looped by the file source, so the
stream the pump sees is periodic. Every offset is a whole number of
cycles over the capture, which makes the receiver's mixing periodic too:
once the filters and AGCs have settled, block ``k`` of the stream gives
the same output as block ``k + period``, and the reference needs to
compute one period only.

The seed draws the noise and the phase of every carrier; it changes no
size, offset, tone or block, so every seed asks for the same work.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import json
import os
import struct
from fractions import Fraction
from typing import List

import numpy as np

from . import signals

HERE = os.path.dirname(os.path.abspath(__file__))

#: carrier kind → the radio mode that demodulates it
KINDS = {"fm_stereo": "WFM", "nfm": "NFM", "am": "AM", "usb": "USB"}


@dataclasses.dataclass
class Radio:
    name: str
    demod: str
    offset_hz: float        # VFO centre relative to the capture's centre
    bandwidth: float
    tones_hz: List[float]


@dataclasses.dataclass
class Traffic:
    samplerate: float
    capture: np.ndarray     # complex64, one period of the stream
    radios: List[Radio]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, spec_dir: str = HERE,
              bench_json: str = os.path.join(os.path.dirname(HERE),
                                             "BENCHMARK.json")):
    """(workload entry, configuration, traffic spec) of cell ``name``:
    the entry of ``bench_json`` and the files it names under
    ``spec_dir``."""
    bench = load_json(bench_json)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; "
                         f"BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    config = load_json(os.path.join(spec_dir, "configs",
                                    f"{w['config']}.json"))
    traffic = load_json(os.path.join(spec_dir, "traffic",
                                     f"{w['traffic']}.json"))
    return w, config, traffic


def _whole_cycles(freq: float, seconds: float, what: str):
    cycles = Fraction(freq).limit_denominator(10 ** 9) \
        * Fraction(seconds).limit_denominator(10 ** 9)
    if cycles.denominator != 1:
        raise ValueError(f"{what} {freq} Hz is not a whole number of "
                         f"cycles over the {seconds} s capture")


def build(config: dict, spec: dict, seed: int) -> Traffic:
    fs = float(config["samplerate"])
    seconds = float(spec["capture_s"])
    T = int(round(fs * seconds))
    n = np.arange(T)
    jobs, radios = [], []
    for i, c in enumerate(spec["carriers"]):
        kind, demod = c["kind"], c["demod"]
        if KINDS.get(kind) != demod:
            raise ValueError(f"carrier {i}: {kind} is not for {demod}")
        bw = float(config["demods"][demod]["bandwidth"])
        off = float(c["offset_hz"])
        tones = [float(t) for t in c["tones_hz"]]
        _whole_cycles(off, seconds, f"carrier {i} offset")
        if kind == "fm_stereo":
            jobs.append((signals.fm_stereo, off, *tones))
        elif kind == "nfm":
            jobs.append((signals.nfm, off, tones[0]))
        elif kind == "am":
            jobs.append((signals.am, off, tones[0]))
        else:
            # the VFO is tuned to the passband centre; the suppressed
            # carrier sits half a bandwidth below it
            _whole_cycles(bw / 2.0, seconds, "USB half bandwidth")
            jobs.append((signals.usb, off - bw / 2.0, tones[0]))
        radios.append(Radio(f"{demod.lower()}{i}", demod, off, bw, tones))
    # numpy's array functions release the GIL: one thread per carrier
    with cf.ThreadPoolExecutor(min(len(jobs), 8)) as ex:
        carriers = list(ex.map(lambda j: j[0](n, fs, *j[1:]), jobs))
    rng = np.random.default_rng(int(seed) % (1 << 64))
    capture = signals.band(carriers, T, float(spec["noise"]), rng)
    return Traffic(fs, capture, radios)


def write_wav_f32(path: str, x: np.ndarray, samplerate: float):
    """IEEE-float stereo (I, Q) WAV, the format the file source reads
    back bit for bit."""
    payload = np.stack([x.real, x.imag], -1).astype("<f4").tobytes()
    rate = int(round(samplerate))
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
           + b"fmt " + struct.pack("<IHHIIHH", 16, 3, 2, rate, rate * 8,
                                   8, 32)
           + b"data" + struct.pack("<I", len(payload)))
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(payload)
