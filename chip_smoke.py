"""Smoke test on the GPU: drive the receiver's main paths once at full
width and check what comes out.

Phases, all in this one process (a second JAX process on the card would
fail for want of device memory):

  device  the first JAX device must be a GPU — there is no CPU fallback.
          Prints the card's name and power limit, its device kind, the
          JAX version and the compile-cache directory.
  served  the headless server (SDRApp + HttpDebugServer, as ``python -m
          sdrplusplusbrown_tpu`` starts them) on a seeded 2.4 MS/s WAV
          capture holding two WFM stereo stations and one NFM carrier,
          ``pump: manual``, 65536-bin spectrum.  One WFM and one NFM radio
          are tuned over HTTP, ~40 blocks are stepped through
          ``/pump/step``, and the recorder sinks' audio and ``/status``
          are held to the repo's oracles: waterfall SNR above 20 dB on the
          carrier and below 20 dB off it, stereo separation, the NFM
          tone, a finite ``rtFactor``.
  cells   each of bench.py's five builders at full width, 3 state-carrying
          steps on the card, compared with the same steps run on the CPU
          backend of this process in float32 under
          ``jax.default_matmul_precision("highest")`` through the conv FIR
          lowering (the plain reference): output SNR ≥ 50 dB on the steps after the warm-up
          step, plus each cell's signal oracles.
  multi   only with ``--devices 4``, and then the only phase after
          ``device``: parallel/wfm_time.ShardedWFMPipeline over a
          (time=2, ch=2) mesh of 4 cards, 8 WFM channels at 2.4 MS/s,
          compared with single-card ``Radio.apply`` on card 0.

A failing phase raises, so the script exits nonzero.  The last line of
standard output is ``{"ok": true, "device": {"platform": "gpu",
"kind": ..., "count": N}}``; everything else comes before it.

Usage:  python chip_smoke.py [--devices 4] [--seed N]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
import urllib.request

import numpy as np

import bench
from bench import Check, at_least, at_most
from sdrplusplusbrown_tpu.utils import synth

REF_SNR_DB = 50.0        # card output vs the float32 CPU reference
MULTI_SNR_DB = 40.0      # sharded vs single card (tests/test_parallel.py)
N_STEPS = 3


def _say(*parts):
    print(*parts, flush=True)


def _report(checks, phase: str) -> list:
    """Print each check; return the names of those that failed."""
    for c in checks:
        _say(f"  {phase}: {c.name} = {c.value:.4g} "
             f"(bound {c.bound:g}) {'ok' if c.ok else 'FAIL'}")
    return [f"{phase}: {c.name}" for c in checks if not c.ok]


def _require(checks, phase: str):
    bad = _report(checks, phase)
    if bad:
        raise AssertionError(f"failed {bad}")


# ---------------------------------------------------------------- device
def phase_device(n_devices: int) -> dict:
    import jax
    from sdrplusplusbrown_tpu.utils.compile_cache import enable_compile_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX found "
                         f"{devs[0].platform}); nothing was run")
    if len(devs) < n_devices:
        raise SystemExit(f"chip_smoke: {n_devices} GPUs needed, "
                         f"{len(devs)} found")
    cache = enable_compile_cache()
    for line in _nvidia_smi_lines():
        _say(f"card: {line}")
    _say(f"device_kind: {devs[0].device_kind}; jax {jax.__version__}; "
         f"devices: {len(devs)}; compile cache: {cache}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _nvidia_smi_lines():
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()


# ---------------------------------------------------------------- served
SERVED_FS = 2_400_000.0
WFM_A = (-600e3, 1000.0, 1700.0)      # offset, L tone, R tone
WFM_B = (400e3, 700.0, 2100.0)
NFM_C = (900e3, 1200.0)               # offset, tone
QUIET = -100e3                        # no carrier within ±150 kHz


def served_capture(path: str, seed: int, seconds: float = 2.0):
    n = np.arange(int(SERVED_FS * seconds))
    x = synth.band([synth.fm_stereo(n, SERVED_FS, *WFM_A),
                    synth.fm_stereo(n, SERVED_FS, *WFM_B),
                    synth.nfm(n, SERVED_FS, *NFM_C)], len(n), seed=seed)
    from sdrplusplusbrown_tpu.io.wav import write_wav
    write_wav(path, x, SERVED_FS, bits=32)


def served_oracles(wfm_lr: np.ndarray, nfm_lr: np.ndarray, snr_on: float,
                   snr_off: float, rt_factor: float, sr: float = 48_000.0):
    """The repo's oracles on what the sinks got ([2, N] L/R audio each)
    and on /status: waterfall SNR on/off carrier, stereo separation of
    station A (L tone only in L, R tone only in R), NFM tone SNR."""
    _, f_l, f_r = WFM_A
    l, r = wfm_lr
    sep = 20 * np.log10(min(
        synth.tone_power(l, f_l, sr)
        / max(synth.tone_power(l, f_r, sr), 1e-12),
        synth.tone_power(r, f_r, sr)
        / max(synth.tone_power(r, f_l, sr), 1e-12)))
    return [at_least("WFM on-carrier SNR dB", snr_on, 20.0),
            at_most("WFM off-carrier SNR dB", snr_off, 20.0),
            at_least("WFM L tone amplitude",
                     synth.tone_power(l, f_l, sr), 0.1),
            at_least("WFM stereo separation dB", sep, 12.0),
            at_least("NFM tone SNR dB", synth.tone_snr(nfm_lr[0], NFM_C[1],
                                                      sr), 20.0),
            Check("rtFactor finite", rt_factor, 0.0,
                  bool(math.isfinite(rt_factor)))]


def _http(base, path, obj=None, timeout=1800.0):
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        out = json.loads(r.read().decode())
    if "error" in out:
        raise AssertionError(f"{path}: {out['error']}")
    return out


def _recorded(root: str, stream: str) -> np.ndarray:
    from sdrplusplusbrown_tpu.io.wav import read_wav_iq
    rec = os.path.join(root, "recordings")
    names = sorted(f for f in os.listdir(rec) if f.startswith(
        f"sink_{stream}"))
    x, _ = read_wav_iq(os.path.join(rec, names[0]))
    return np.stack([x.real, x.imag])          # stereo WAV → [2, N]


def phase_served(seed: int, n_blocks: int = 40):
    from sdrplusplusbrown_tpu.app import SDRApp
    from sdrplusplusbrown_tpu.server.http_server import HttpDebugServer

    with tempfile.TemporaryDirectory() as tmp:
        cap = os.path.join(tmp, "baseband_100000000Hz_12-00-00_01-01-2026.wav")
        served_capture(cap, seed)
        root = os.path.join(tmp, "root")
        os.makedirs(root)
        with open(os.path.join(root, "config.json"), "w") as f:
            json.dump({"source": {"type": "file", "path": cap,
                                  "loop": True},
                       "pump": "manual", "fftSize": 65536, "fftRate": 20,
                       "modules": {
                           "WFM": {"type": "radio", "demod": "WFM",
                                   "offset": QUIET},
                           "NFM": {"type": "radio", "demod": "NFM",
                                   "offset": QUIET}}}, f)
        app = SDRApp(root)
        http = HttpDebugServer(app, port=0)
        http.start()
        app.start()
        base = f"http://127.0.0.1:{http.port}"
        # tune both radios over HTTP: demod by module command, offset by
        # the VFO route; their audio goes to the recorder sink
        for name, demod, off in (("WFM", "WFM", WFM_A[0]),
                                 ("NFM", "NFM", NFM_C[0])):
            _http(base, f"/module/{name}/command",
                  {"cmd": "set_demod", "args": demod})
            _http(base, f"/vfo/set_offset?name={name}&offset={off}")
            _http(base, "/sink/select", {"stream": name,
                                         "sink": "recorder"})
        t0 = time.perf_counter()
        r = _http(base, "/pump/step", {"blocks": n_blocks})
        wall = time.perf_counter() - t0
        if r["stepped"] != n_blocks:
            raise AssertionError(f"stepped {r['stepped']} of {n_blocks}")
        snr_on = _http(base, "/module/WFM/command",
                       {"cmd": "get_snr"})["snr"]
        rt = float(_http(base, "/status")["rtFactor"])
        _http(base, f"/vfo/set_offset?name=WFM&offset={QUIET}")
        _http(base, "/pump/step", {"blocks": 2})
        snr_off = _http(base, "/module/WFM/command",
                        {"cmd": "get_snr"})["snr"]
        app.shutdown()
        http.stop()
        per_block = r["blockLen"] * 48_000.0 / SERVED_FS
        n_on = int(n_blocks * per_block)
        skip = int(0.2 * 48_000)               # filter warm-up
        wfm = _recorded(root, "WFM")[:, skip:n_on]
        nfm = _recorded(root, "NFM")[:, skip:n_on]
    _say(f"served: {n_blocks} blocks of {r['blockLen']} samples in "
         f"{wall:.1f} s (compile included), rtFactor {rt}")
    _require(served_oracles(wfm, nfm, snr_on, snr_off, rt), "served")


# ---------------------------------------------------------------- cells
def run_cell(cell, device, precision=None, fir_backend=None) -> dict:
    """Compile ``cell.step`` for ``device`` and run it over the cell's
    blocks, carrying state.  Returns host outputs, compile and step wall
    times and the compiled step's memory analysis."""
    import contextlib
    import jax
    from sdrplusplusbrown_tpu.ops import fir

    ctx = (jax.default_matmul_precision(precision) if precision
           else contextlib.nullcontext())
    before = fir.get_fir_backend()
    with ctx:
        params, state, blocks = jax.device_put(
            (cell.params, cell.state, cell.blocks), device)
        fir.set_fir_backend(fir_backend or before)
        try:
            t0 = time.perf_counter()
            comp = jax.jit(cell.step).lower(params, state,
                                            blocks[0]).compile()
            compile_s = time.perf_counter() - t0
        finally:
            fir.set_fir_backend(before)
        outs, step_s = [], []
        for b in blocks:
            t0 = time.perf_counter()
            o, state = comp(params, state, b)
            jax.block_until_ready(o)
            step_s.append(time.perf_counter() - t0)
            outs.append(jax.tree.map(np.asarray, o))
    return {"outs": outs, "compile_s": compile_s, "step_s": step_s,
            "memory": comp.memory_analysis()}


def compare(cell, got: list, ref: list) -> list:
    """Output-vs-reference SNR (dB) of each array ``cell.scored`` picks,
    the worst over the steps after the first.  The first step starts
    from zeroed filter state: its warm-up samples carry no signal, and an
    FM discriminator fed a near-zero IF there returns ±π on the sign of a
    zero, which the two backends round differently."""
    per_step = [[synth.snr_db(r, g)
                 for g, r in zip(cell.scored(og), cell.scored(orf))]
                for og, orf in zip(got[1:], ref[1:])]
    return [min(col) for col in zip(*per_step)]


def _matmul_precision() -> str:
    import jax
    from sdrplusplusbrown_tpu.ops import fir
    p = jax.config.jax_default_matmul_precision
    return (f"{p or 'default (float32 dots may run in TF32)'}, "
            f"FIR route {fir.get_fir_backend()}")


def phase_cells(seed: int, card: str):
    import jax
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    failed = []
    for name, build in bench.BUILDERS.items():
        cell = build(seed=seed, n_blocks=N_STEPS)
        got = run_cell(cell, gpu)
        ref = run_cell(cell, cpu, precision="highest", fir_backend="conv")
        snrs = compare(cell, got["outs"], ref["outs"])
        steps = ", ".join(f"{t * 1e3:.2f}" for t in got["step_s"])
        each = ", ".join(f"{v:.1f}" for v in snrs)
        _say(f"cell {name}: output vs float32 CPU reference {min(snrs):.1f}"
             f" dB [per output: {each}] (tolerance ≥ {REF_SNR_DB:g} dB); "
             f"matmul precision {_matmul_precision()}; compile "
             f"{got['compile_s']:.1f} s; step wall ms [{steps}] on {card}")
        _say(f"cell {name}: memory_analysis {got['memory']}")
        failed += _report(
            [at_least(f"{name} SNR vs reference dB", min(snrs), REF_SNR_DB)]
            + cell.oracle(got["outs"]), f"cell {name}")
    if failed:
        raise AssertionError(f"failed {failed}")


# ---------------------------------------------------------------- multi
def multi_compare(devices, fs=2_400_000.0, C=8, t_target=120_000,
                  n_blocks=N_STEPS, seed=0):
    """ShardedWFMPipeline on a (time=2, ch=2) mesh of ``devices[:4]`` vs
    the single-device ``Radio.apply`` on ``devices[0]``.  Returns
    (SNR dB after the warm-up quarter, min stereo separation dB)."""
    import jax
    import jax.numpy as jnp
    from sdrplusplusbrown_tpu.models.radio import Radio, DEMOD_WFM
    from sdrplusplusbrown_tpu.parallel.multihost import make_mesh
    from sdrplusplusbrown_tpu.parallel.wfm_time import ShardedWFMPipeline

    mesh = make_mesh(2, 2, devices[:4])
    radio = Radio(fs, DEMOD_WFM, pll_mode="normalize")
    g = radio.in_multiple
    t_local = ((t_target + g - 1) // g) * g
    pipe = ShardedWFMPipeline(fs, mesh, C, t_local)
    T = pipe.t_global
    offsets = np.linspace(-0.4 * fs, 0.4 * fs, C)
    f_l = 500.0 + 200.0 * np.arange(C)
    f_r = 2300.0 + 200.0 * np.arange(C)
    n = np.arange(n_blocks * T)
    x = synth.band([synth.fm_stereo(n, fs, o, a, b)
                    for o, a, b in zip(offsets, f_l, f_r)], len(n),
                   seed=seed)

    params, carry = pipe.make_params(offsets), pipe.init_carry()
    sharded = []
    for i in range(n_blocks):
        y, carry = pipe.step(params, carry, jnp.asarray(x[i * T:(i + 1) * T]))
        sharded.append(np.asarray(y))
    y_shard = np.concatenate(sharded, axis=-1)

    step = jax.jit(lambda p, s, b: radio.apply(p, s, b))
    rp, rs = jax.device_put((radio.make_params(offsets),
                             radio.init_state((C,))), devices[0])
    ref = []
    for i in range(n_blocks):
        blk = jax.device_put(np.broadcast_to(x[i * T:(i + 1) * T],
                                             (C, T)), devices[0])
        y, rs = step(rp, rs, blk)
        ref.append(np.asarray(y))
    y_ref = np.concatenate(ref, axis=-1)

    skip = y_ref.shape[-1] // 4
    snr = synth.snr_db(y_ref[..., skip:], y_shard[..., skip:])
    sep = min(20 * np.log10(
        synth.tone_power(y_shard[c, 0, skip:], f_l[c], 48_000.0)
        / max(synth.tone_power(y_shard[c, 0, skip:], f_r[c], 48_000.0),
              1e-12)) for c in range(C))
    return snr, sep


def phase_multi(card: str):
    import jax
    t0 = time.perf_counter()
    snr, sep = multi_compare(jax.devices())
    _say(f"multi: ShardedWFMPipeline (time=2, ch=2) over 4 cards vs "
         f"Radio.apply on card 0: {snr:.1f} dB, stereo separation "
         f"{sep:.1f} dB, {time.perf_counter() - t0:.1f} s with compile "
         f"on {card}")
    _require([at_least("sharded vs single-card SNR dB", snr, MULTI_SNR_DB),
              at_least("sharded stereo separation dB", sep, 12.0)],
             "multi")


# ---------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # the reference runs need the CPU backend beside the GPU
    plat = os.environ.get("JAX_PLATFORMS")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"

    device = phase_device(args.devices)
    card = _nvidia_smi_lines()[0]
    if args.devices == 4:
        phase_multi(card)
    else:
        phase_served(args.seed)
        phase_cells(args.seed, card)
    _say(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
