"""Throughput benchmark on the GPU: the five receiver configurations.

Each configuration ("cell") is one jitted, state-carrying step over a
block of wideband IQ (about 0.1 s of input at the cell's sample rate):

  wfm8           8 WFM-stereo VFOs on a shared 2.4 MS/s band + the
                 65536-bin / 20 fps spectrum (reference defaults,
                 core/src/core.cpp:559-561)
  multimode8     4 NFM + 2 AM + 2 USB VFOs on 2.4 MS/s (RadioBank)
  channelizer64  10 MS/s → 64-channel polyphase filter bank → 1024-bin
                 spectra per channel
  scanner128     128 NFM channels on 2.4 MS/s via the PFB front end
  scanner256     256 of the same

The bands hold real modulated carriers synthesized from ``--seed``
(utils/synth.py), so the same builders serve the chip smoke test's
output checks.

Timing: K steps run inside ONE jitted ``lax.scan`` (the DSP state is the
carry, so the steps are serially dependent and cannot be elided; each
step's outputs are stacked, so none is dead code).  Wall time is taken
at scan lengths K and 2K, each the best of several calls ending in
``block_until_ready``; the per-step time is the slope
``(t(2K) - t(K)) / K``, which cancels the per-call host cost.

Usage:
  python bench.py [--fir=auto|conv|toeplitz|fft] [--details=PATH]
                  [--seed=N]

Runs on the GPU only: with no GPU it exits 2 and prints no result.
Prints the device (platform, kind, name and power limit) on an earlier
line and, as the last line, ``{"configs": {name: Msamples/s}}``; the
full numbers go to the details file (default ``bench_details.json``).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from typing import Any, Callable, List, NamedTuple

import numpy as np

from sdrplusplusbrown_tpu.utils import synth


class Check(NamedTuple):
    """One signal-level oracle: ``value`` against ``bound``."""
    name: str
    value: float
    bound: float
    ok: bool


def at_least(name: str, value: float, bound: float) -> Check:
    return Check(name, float(value), bound, bool(value >= bound))


def at_most(name: str, value: float, bound: float) -> Check:
    return Check(name, float(value), bound, bool(value <= bound))


class Cell(NamedTuple):
    """One benchmark configuration, ready to run."""
    name: str
    step: Callable          # (params, state, x) -> (outs, state')
    params: Any
    state: Any
    blocks: List[Any]       # per-step host inputs, phase-continuous
    samples_per_step: int
    in_rate: float          # input samples/s that is real time
    oracle: Callable        # [host outs per step] -> [Check]
    scored: Callable        # host outs of one step -> arrays to compare


def _block_len(g: int, target: int = 240_000) -> int:
    return int(((target + g - 1) // g) * g)


def _planes(x: np.ndarray):
    return (np.ascontiguousarray(x.real, np.float32),
            np.ascontiguousarray(x.imag, np.float32))


def _cat(outs, pick):
    return np.concatenate([np.asarray(pick(o)) for o in outs], axis=-1)


def build_wfm8(seed: int = 0, n_blocks: int = 1) -> Cell:
    from sdrplusplusbrown_tpu.models.radio import Radio, DEMOD_WFM
    from sdrplusplusbrown_tpu.ops.spectrum import (
        SpectrumPath, calculate_vfo_signal_info)

    fs = 2_400_000.0
    C = 8
    radio = Radio(fs, DEMOD_WFM, pll_mode="normalize")
    spectrum = SpectrumPath(fs, fft_size=65536, fft_rate=20.0)
    T = _block_len(math.lcm(radio.in_multiple, spectrum.in_multiple))
    offsets = np.linspace(-1.0e6, 1.0e6, C)
    f_l = 500.0 + 200.0 * np.arange(C)
    f_r = 2300.0 + 200.0 * np.arange(C)
    n = np.arange(n_blocks * T)
    x = synth.band([synth.fm_stereo(n, fs, o, a, b)
                    for o, a, b in zip(offsets, f_l, f_r)], len(n),
                   seed=seed)
    # (xr, xi) float32 plane feed — the shared front end and the
    # spectrum path take either planes or complex64
    blocks = [_planes(x[i * T:(i + 1) * T]) for i in range(n_blocks)]

    def step(params, state, xw):
        (audio, spectra), state = radio.apply_shared(
            params, state, xw, spectrum=spectrum)
        return (audio, spectra), state

    def oracle(outs):
        audio = _cat(outs, lambda o: o[0])[..., 2000:]     # [C, 2, N]
        sep, lvl = [], []
        for c in range(C):
            l, r = audio[c, 0], audio[c, 1]
            pl = synth.tone_power(l, f_l[c], 48_000.0)
            pr = synth.tone_power(r, f_r[c], 48_000.0)
            lvl.append(min(pl, pr))
            sep.append(20 * np.log10(min(
                pl / max(synth.tone_power(l, f_r[c], 48_000.0), 1e-12),
                pr / max(synth.tone_power(r, f_l[c], 48_000.0), 1e-12))))
        line = np.asarray(outs[-1][1])[-1]
        snrs = [calculate_vfo_signal_info(line, o, 150e3, fs)[1]
                for o in offsets]
        return [at_least("min tone amplitude", min(lvl), 0.1),
                at_least("min stereo separation dB", min(sep), 12.0),
                at_least("min on-carrier spectrum SNR dB", min(snrs), 20.0)]

    return Cell("wfm8", step, radio.make_params_shared(offsets),
                radio.init_state_shared(C), blocks, T, fs, oracle,
                lambda o: [o[0], o[1]])


def _usb_at_centre(n, fs, centre, f_tone, bandwidth=2_800.0):
    """USB tone for a VFO whose offset is its passband centre: the
    suppressed carrier sits bandwidth/2 below (ops/demod.py SSBDemod)."""
    return synth.usb(n, fs, centre - bandwidth / 2.0, f_tone)


def build_multimode8(seed: int = 0, n_blocks: int = 1) -> Cell:
    from sdrplusplusbrown_tpu.models.radio_bank import RadioBank, VFOSpec
    from sdrplusplusbrown_tpu.models.radio import (DEMOD_NFM, DEMOD_AM,
                                                   DEMOD_USB)

    fs = 2_400_000.0
    plan = ([(DEMOD_NFM, -900e3 + 300e3 * i, 400.0 + 150.0 * i,
              synth.nfm) for i in range(4)]
            + [(DEMOD_AM, 300e3 + 200e3 * i, 600.0 + 300.0 * i, synth.am)
               for i in range(2)]
            + [(DEMOD_USB, 800e3 + 100e3 * i, 1000.0 + 500.0 * i,
                _usb_at_centre) for i in range(2)])
    vfos = [VFOSpec(f"v{i}", d, off) for i, (d, off, _, _) in
            enumerate(plan)]
    bank = RadioBank(fs, vfos)
    T = _block_len(bank.in_multiple)
    n = np.arange(n_blocks * T)
    x = synth.band([mod(n, fs, off, f) for _, off, f, mod in plan],
                   len(n), seed=seed)
    blocks = [x[i * T:(i + 1) * T] for i in range(n_blocks)]
    tones = {}
    for d, _, f, _ in plan:
        tones.setdefault(d, []).append(f)

    def step(params, state, xw):
        # mono audio out: the sink duplicates host-side
        outs, state = bank.apply(params, state, xw, mono_out=True)
        return (outs,), state

    def oracle(outs):
        snrs = []
        for d, fl in tones.items():
            a = _cat(outs, lambda o: o[0][d])[..., 2000:]
            snrs += [synth.tone_snr(a[c], f) for c, f in enumerate(fl)]
        return [at_least("min audio tone SNR dB", min(snrs), 20.0)]

    return Cell("multimode8", step, bank.make_params(), bank.init_state(),
                blocks, T, fs, oracle,
                lambda o: [o[0][d] for d in sorted(o[0])])


def build_channelizer64(seed: int = 0, n_blocks: int = 1) -> Cell:
    """BASELINE config 4: 10 MS/s wideband → 64 polyphase channels →
    1024-bin dB spectra per channel."""
    import jax
    from sdrplusplusbrown_tpu.ops.channelizer import PolyphaseChannelizer
    from sdrplusplusbrown_tpu.ops.spectrum import SpectrumFFT

    fs = 10_000_000.0
    M = 64
    ch = PolyphaseChannelizer(fs, M)
    fft = SpectrumFFT(1024)
    T = 1 << 21
    ch_rate = fs / M
    # (channel, residual offset in Hz) of each carrier
    live = [(1, 12e3), (5, -31e3), (17, 44e3), (40, 3e3), (63, -20e3)]
    n = np.arange(n_blocks * T)
    x = synth.band([synth.tone(n, fs, m * ch_rate + d) for m, d in live],
                   len(n), noise=0.01, seed=seed)
    blocks = [_planes(x[i * T:(i + 1) * T]) for i in range(n_blocks)]

    def step(params, state, xw):
        y, state = ch.apply(None, state, jax.lax.complex(*xw))
        spec, _ = fft.apply(None, None, y.reshape(M, -1, 1024))
        return (spec,), state

    def oracle(outs):
        spec = np.asarray(outs[-1][0]).mean(axis=1)          # [M, 1024]
        miss, rise = 0, []
        for m, d in live:
            want = int((d / ch_rate + 0.5) * 1024)
            got = int(np.argmax(spec[m]))
            miss = max(miss, abs(got - want))
            rise.append(spec[m].max() - np.median(spec[m]))
        return [at_most("max tone bin error", miss, 1),
                at_least("min tone over median dB", min(rise), 30.0)]

    return Cell("channelizer64", step, None, ch.init_state(()), blocks, T,
                fs, oracle, lambda o: [o[0]])


def build_scanner(C: int = 128, seed: int = 0, n_blocks: int = 1) -> Cell:
    """Wide-bank monitoring: C NFM channels on one 2.4 MS/s wideband
    through the 2×-oversampled PFB front end (the reference runs one
    RxVFO thread per channel, core/src/dsp/channel/rx_vfo.h:89-121).
    64 of the channels carry a tone; the rest hear the band's noise."""
    from sdrplusplusbrown_tpu.models.radio import Radio, DEMOD_NFM

    fs = 2_400_000.0
    radio = Radio(fs, DEMOD_NFM, squelch_enabled=True,
                  pll_mode="normalize")
    T = _block_len(radio.in_multiple)
    offs = np.linspace(-1.1e6, 1.1e6, C) + 917.0
    live = np.arange(0, C, C // 64)
    f_tone = 400.0 + 40.0 * np.arange(len(live))
    n = np.arange(n_blocks * T)
    x = synth.band([synth.nfm(n, fs, offs[c], f)
                    for c, f in zip(live, f_tone)], len(n), seed=seed)
    blocks = [_planes(x[i * T:(i + 1) * T]) for i in range(n_blocks)]

    def step(params, state, xw):
        # mono audio: the sink duplicates host-side
        audio, state = radio.apply_channelized(params, state, xw,
                                               mono_out=True)
        return (audio,), state

    def oracle(outs):
        a = _cat(outs, lambda o: o[0])[..., 2000:]
        snrs = [synth.tone_snr(a[c], f) for c, f in zip(live, f_tone)]
        return [at_least("min live-channel tone SNR dB", min(snrs), 20.0)]

    return Cell(f"scanner{C}", step, radio.make_params_channelized(offs),
                radio.init_state_channelized(C), blocks, T, fs, oracle,
                lambda o: [np.asarray(o[0])[live]])


BUILDERS = {
    "wfm8": build_wfm8,
    "multimode8": build_multimode8,
    "channelizer64": build_channelizer64,
    "scanner128": lambda **kw: build_scanner(128, **kw),
    "scanner256": lambda **kw: build_scanner(256, **kw),
}


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_info() -> dict:
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _wall(fn, *args) -> float:
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def measure(cell: Cell, K: int = 8, reps: int = 5) -> dict:
    """Per-step time from the K / 2K ``lax.scan`` slope (see module
    docstring); compile times are reported separately."""
    import jax

    def scan_of(n):
        def run(params, state, x):
            def body(st, _):
                outs, st = cell.step(params, st, x)
                return st, outs
            st, ys = jax.lax.scan(body, state, None, length=n)
            return ys, st
        return jax.jit(run)

    x = jax.device_put(cell.blocks[0])
    out = {"samples_per_step": cell.samples_per_step}
    t = {}
    for n in (K, 2 * K):
        t0 = time.perf_counter()
        comp = scan_of(n).lower(cell.params, cell.state, x).compile()
        out[f"compile_s_scan{n}"] = time.perf_counter() - t0
        _wall(comp, cell.params, cell.state, x)          # warm
        t[n] = min(_wall(comp, cell.params, cell.state, x)
                   for _ in range(reps))
        out[f"wall_s_scan{n}"] = t[n]
    per_step = (t[2 * K] - t[K]) / K
    out["step_s"] = per_step
    out["msps"] = cell.samples_per_step / per_step / 1e6
    out["x_realtime"] = out["msps"] * 1e6 / cell.in_rate
    return out


def main(argv=None):
    import jax
    from sdrplusplusbrown_tpu.ops import fir as fir_mod
    from sdrplusplusbrown_tpu.utils.compile_cache import enable_compile_cache

    args = sys.argv[1:] if argv is None else argv
    opts = dict(a[2:].split("=", 1) for a in args if a.startswith("--")
                and "=" in a)
    fir_mod.set_fir_backend(opts.get("fir", "auto"))
    seed = int(opts.get("seed", 0))

    dev = device_info()
    if dev["platform"] != "gpu":
        print(f"bench.py measures the GPU; JAX found {dev['platform']}",
              file=sys.stderr)
        return 2
    cache = enable_compile_cache()
    card = card_name_and_power_limit()
    print(f"# card: {card}; device: {json.dumps(dev)}; "
          f"fir: {fir_mod.get_fir_backend()}; cache: {cache}")

    details = {"device": dev, "card": card,
               "fir_backend": fir_mod.get_fir_backend(), "configs": {}}
    for name, build in BUILDERS.items():
        r = measure(build(seed=seed))
        details["configs"][name] = r
        print(f"# {name}: {r['step_s'] * 1e3:.3f} ms/step "
              f"{r['msps']:.1f} MS/s ({r['x_realtime']:.1f}x real time) "
              f"compile {r['compile_s_scan8']:.1f}s on {card}",
              flush=True)
    with open(opts.get("details", "bench_details.json"), "w") as f:
        json.dump(details, f, indent=1)
    print(json.dumps({"configs": {k: round(v["msps"], 1)
                                  for k, v in details["configs"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
