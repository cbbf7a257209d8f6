"""Benchmark of the served receiver on the GPU: the pump of
``python -m sdrplusplusbrown_tpu``, in process, closed loop.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``benchmark/configs/<config>.json``: rates, spectrum, the radio modes
and the limits of the output check) and a traffic mix
(``benchmark/traffic/<traffic>.json``: the carriers of the capture, one
radio module tuned to each). The run:

1. set-up: synthesizes the capture from ``--seed``, writes it as a WAV
   under ``$TMPDIR``, builds ``SDRApp`` on it (``type: file``, looped,
   ``pump: manual``, no HTTP server) with one radio module per carrier,
   and pumps one full period of the capture, which compiles (or loads
   from ``<checkout>/.jax_cache``) every program the window runs;
2. window: calls ``SDRApp.pump_step(1)`` back to back for ``--seconds``:
   each call reads one pump block from the file source, runs the IQ
   front end and the 65536-bin spectrum, pushes the waterfall, runs every
   radio's jitted step and delivers its audio to its sink stream;
3. with ``--trace 1``, a further fixed number of blocks under the JAX
   profiler, with host spans ``frontend`` (call → the app's
   ``baseband_event``), ``radios`` (→ return) and ``harness``;
4. the output check (``check.py``) on a seeded sample of the window's
   blocks, against the float64 reference (``reference.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (radio-blocks of the window), ``metrics``
(the cell's end-to-end metrics, or its per-layer ones with ``--trace
1``; each read by ``benchmark/metrics/<name>.py``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: every number compared
with its limit. The same numbers are the last lines of standard error.

With no GPU, or fewer than the cell's chips, it exits 2 and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from benchmark import check, trace, traffic  # noqa: E402

#: the persistent compilation cache: inside the checkout, at a fixed path
CACHE_DIR = os.path.join(ROOT, ".jax_cache")
#: blocks run under the profiler in a ``--trace 1`` run
TRACE_BLOCKS = 24
#: one window block in this many (drawn from the seed) is kept for the
#: output check, and always the window's first
KEEP_ONE_IN = 24


def say(*parts):
    print(*parts, file=sys.stderr, flush=True)


class CardSampler(threading.Thread):
    """Reads the card's name, power limit and SM clock from nvidia-smi
    once a second beside the window; touches no JAX."""

    QUERY = "name,power.limit,clocks.sm"

    def __init__(self):
        super().__init__(daemon=True)
        self.rows, self.error = [], None
        self._stop_evt = threading.Event()

    def run(self):
        while True:
            try:
                out = subprocess.run(
                    ["nvidia-smi", f"--query-gpu={self.QUERY}",
                     "--format=csv,noheader,nounits"],
                    capture_output=True, text=True, timeout=10, check=True)
                self.rows.append(out.stdout.strip().splitlines()[0])
            except (OSError, subprocess.SubprocessError) as e:
                self.error = repr(e)
                return
            if self._stop_evt.wait(1.0):
                return

    def stop(self) -> str:
        self._stop_evt.set()
        if self.ident is not None:
            self.join(timeout=30)
        if not self.rows:
            return f"nvidia-smi: not read ({self.error})"
        name, limit, _ = self.rows[0].split(", ")
        clocks = []
        for row in self.rows:
            try:
                clocks.append(float(row.split(", ")[-1]))
            except ValueError:          # "[N/A]"
                pass
        clocks.sort()
        mid = clocks[len(clocks) // 2] if clocks else float("nan")
        return (f"card: {name}, power.limit {limit} W, clocks.sm MHz "
                f"min {min(clocks, default=float('nan')):g} median {mid:g} "
                f"max {max(clocks, default=float('nan')):g} over "
                f"{len(clocks)} of {len(self.rows)} readings")


class CompileCounter:
    """Counts XLA compilations and persistent-cache loads."""

    def __init__(self, jax):
        self.n = 0
        jax.monitoring.register_event_duration_secs_listener(self._dur)
        jax.monitoring.register_event_listener(self._evt)

    def _dur(self, name, _secs, **_kw):
        if name == "/jax/core/compile/backend_compile_duration":
            self.n += 1

    def _evt(self, name, **_kw):
        if name == "/jax/compilation_cache/cache_hits":
            self.n += 1


def require_devices(jax, chips: int, allow_cpu: bool):
    """The devices to run on; exits 2 with no GPU or too few chips."""
    devs = jax.devices()
    if devs[0].platform != "gpu" and not allow_cpu:
        say(f"benchmark: needs a GPU, JAX found {devs[0].platform}; "
            f"no result")
        raise SystemExit(2)
    if len(devs) < chips:
        say(f"benchmark: the cell needs {chips} chips, JAX found "
            f"{len(devs)}; no result")
        raise SystemExit(2)
    return devs


class ServedPump:
    """SDRApp on the capture, with the harness's hooks: host timestamps
    at the app's ``baseband_event``, and the outputs of kept blocks."""

    def __init__(self, root, wav, config, tr):
        from sdrplusplusbrown_tpu.app import SDRApp, RadioModuleInstance
        mods = {r.name: {"type": "radio", "demod": r.demod,
                         "offset": r.offset_hz, "bandwidth": r.bandwidth}
                for r in tr.radios}
        app_conf = {"source": {"type": "file", "path": wav, "loop": True},
                    "pump": "manual", "modules": mods,
                    **{k: config[k] for k in (
                        "fftSize", "fftRate", "fftWindow", "decimation",
                        "dcBlocking", "invertIQ")}}
        os.makedirs(root, exist_ok=True)
        with open(os.path.join(root, "config.json"), "w") as f:
            json.dump(app_conf, f)
        self.app = app = SDRApp(root)
        self.radios = [app.modules[r.name] for r in tr.radios]
        for m, r in zip(self.radios, tr.radios):
            mode = config["demods"][r.demod]
            if not isinstance(m, RadioModuleInstance) or (
                    m.radio.demod_name, m.radio.if_rate, m.radio.bandwidth,
                    m.radio.audio_samplerate, m.squelch_level) != (
                    r.demod, mode["if_rate"], r.bandwidth,
                    config["audio_samplerate"], config["squelch_level"]):
                raise SystemExit(f"radio {r.name} departs from the "
                                 f"configuration")
        self.keep = False
        self.kept: dict = {}
        self.t_bb = 0.0
        self.spans = None
        self.counts = np.zeros(len(self.radios), np.int64)
        app.baseband_event.bind(self._on_baseband)
        app.spectrum_event.bind(self._on_spectrum)
        for i, m in enumerate(self.radios):
            m.audio_event.bind(lambda blk, i=i: self._on_audio(i, blk))
        app.start()

    def _on_baseband(self, bb):
        self.t_bb = time.perf_counter()
        if self.spans is not None:
            self.spans.switch("radios")
        if self.keep:
            self.cur["bb"] = bb

    def _on_spectrum(self, line):
        if self.keep:
            self.cur["line"] = line

    def _on_audio(self, i, blk):
        self.counts[i] += blk.shape[-1]
        if self.keep:
            self.cur["audio"].setdefault(self.radios[i].name, []).append(blk)

    def step(self, k: int, keep: bool):
        """Pump block ``k``; → (start, baseband time, end)."""
        self.keep = keep
        if keep:
            self.cur = self.kept[k] = {"audio": {}}
        t0 = time.perf_counter()
        if self.app.pump_step(1) != 1:
            raise RuntimeError("the file source ended")
        t1 = time.perf_counter()
        if keep:
            self.cur["audio"] = {n: np.concatenate(b, axis=-1)
                                 for n, b in self.cur["audio"].items()}
        return t0, self.t_bb, t1

    def close(self):
        self.app.shutdown()


class Spans:
    """Host spans on the profiler's clock: one open at a time."""

    def __init__(self, jax):
        self._jax = jax
        self._cur = None

    def switch(self, name):
        self.close()
        self._cur = self._jax.profiler.TraceAnnotation(
            trace.SPAN_PREFIX + name)
        self._cur.__enter__()

    def close(self):
        if self._cur is not None:
            self._cur.__exit__(None, None, None)
            self._cur = None


def load_readers(bench: dict, cell: str, kind: str):
    """[(name, unit, reader module)] of the cell's ``kind`` metrics."""
    out = []
    for m in bench[kind]:
        if cell in m.get("workloads", [cell]):
            mod = importlib.import_module(f"benchmark.metrics.{m['name']}")
            out.append((m["name"], m["unit"], mod))
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def init_jax(chips: int, allow_cpu: bool, cache_dir: str = CACHE_DIR):
    """Import JAX with the persistent cache at ``cache_dir``; → (jax,
    devices, compile counter)."""
    os.environ["JAX_COMPILATION_CACHE_DIR"] = cache_dir
    import jax
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    # a plain directory of entries: no size limit, no eviction
    jax.config.update("jax_compilation_cache_max_size", -1)
    devs = require_devices(jax, chips, allow_cpu)
    return jax, devs, CompileCounter(jax)


def serve(jax, devs, compiles, config, tr, seed, seconds, traced=False,
          keep_one_in=KEEP_ONE_IN, app_hook=None, marks=None):
    """Set-up, window and (``traced``) the traced blocks on capture
    ``tr`` → (reader context, kept outputs, missing radio-blocks,
    attempted radio-blocks, peak device bytes)."""
    marks = marks or [("start", time.perf_counter() - T_START)]
    with tempfile.TemporaryDirectory(prefix="sdrbench-") as tmp:
        wav = os.path.join(tmp, "capture.wav")
        traffic.write_wav_f32(wav, tr.capture, tr.samplerate)
        pump = ServedPump(os.path.join(tmp, "app"), wav, config, tr)
        marks.append(("app", time.perf_counter() - T_START))
        try:
            if app_hook is not None:
                app_hook(pump.app)
            ctx, card, kept, missing, attempted = _drive(
                jax, pump, tr, config, seed, seconds, traced, keep_one_in,
                compiles, tmp, marks)
        finally:
            pump.close()
    say(card)
    ms = np.asarray(ctx["block_s"]) * 1e3
    say(f"window: {ctx['blocks']} blocks of {ctx['block_len']} samples in "
        f"{ctx['window_s']:.3f} s; block ms mean {ms.mean():.3f} median "
        f"{np.median(ms):.3f} p95 {np.percentile(ms, 95):.3f} max "
        f"{ms.max():.3f}; front end mean "
        f"{np.mean(ctx['frontend_s']) * 1e3:.3f}, radios mean "
        f"{np.mean(ctx['radios_s']) * 1e3:.3f}; compilations "
        f"{ctx['window_compiles']}; kept for the check {len(kept)}")
    memory = max((d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                 for d in devs)
    return ctx, kept, missing, attempted, memory


def main(argv=None, *, allow_cpu=False, spec_dir=HERE,
         bench_json=os.path.join(ROOT, "BENCHMARK.json"),
         cache_dir=CACHE_DIR, app_hook=None):
    """One run; returns the exit code. ``allow_cpu``, ``spec_dir``,
    ``bench_json``, ``cache_dir`` and ``app_hook`` (called with the
    built app before the warm-up) serve the CPU tests only."""
    args = parse(argv)
    bench = traffic.load_json(bench_json)
    cell, config, spec = traffic.load_cell(args.workload, spec_dir,
                                           bench_json)
    jax, devs, compiles = init_jax(int(cell["chips"]), allow_cpu, cache_dir)
    marks = [("start", 0.0), ("jax", time.perf_counter() - T_START)]
    readers = load_readers(bench, args.workload,
                           "per_layer" if args.trace else "end_to_end")
    tr = traffic.build(config, spec, args.seed)
    marks.append(("capture", time.perf_counter() - T_START))
    ctx, kept, missing, attempted, memory = serve(
        jax, devs, compiles, config, tr, args.seed, args.seconds,
        bool(args.trace), app_hook=app_hook, marks=marks)
    t_ref = time.perf_counter()
    ref = check.reference_outputs(tr, config, ctx["block_len"], kept)
    values = check.numbers(tr, config, kept, ref, missing)
    say(f"output check: reference and comparison took "
        f"{time.perf_counter() - t_ref:.3f} s")
    rows = check.judge(values, config.get("limits", {}))
    correct = all(ok for *_, ok in rows)

    metrics = {}
    for name, unit, mod in readers:
        v = mod.read(ctx)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": unit}
    d0 = devs[0]
    device = {"platform": d0.platform, "kind": d0.device_kind,
              "count": len(devs), "memory_peak_bytes": int(memory)}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(missing), "metrics": metrics, "device": device}
    red = ctx.get("trace")
    if red is not None:
        device["busy_s"] = red["busy_s"]
        device["window_s"] = red["window_s"]
        say("idle by host span (s): " + json.dumps(red["idle_by_span"]))
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in red["device_ops"]],
            "idle_gaps": [[n, s] for n, s in red["idle_gaps"]]}
    say(f"USB phase turned by the check, largest |rad|: "
        f"{values['_usb_phase_max_rad']:.3g}")
    result["checks"] = {}
    for name, v, kind, lim, ok in rows:
        say(f"check {name} = {v!r} ({kind} {lim!r}) "
            f"{'ok' if ok else 'FAIL'}")
        result["checks"][name] = {"value": v, kind: lim}
    print(json.dumps(result), flush=True)
    return 0


def _drive(jax, pump, tr, config, seed, seconds, traced, keep_one_in,
           compiles, tmp, marks):
    """Warm-up, window and (with ``--trace 1``) the traced blocks →
    (reader context, kept outputs, missing radio-blocks, attempted)."""
    sampler = CardSampler() if jax.devices()[0].platform == "gpu" else None
    # warm-up: one full period of the capture, at least two blocks, and
    # as long as the slowest radio needs to settle
    pump.step(0, False)
    marks.append(("first block", time.perf_counter() - T_START))
    block = pump.app.pump_block_len
    if len(tr.capture) % block:
        raise SystemExit(f"capture of {len(tr.capture)} samples is not a "
                         f"whole number of {block}-sample pump blocks")
    k = 1
    while k < max(len(tr.capture) // block, 2,
                  check.settle_blocks(tr.radios, tr.samplerate, block)):
        pump.step(k, False)
        k += 1
    setup_s = time.perf_counter() - T_START
    marks.append(("warm-up", setup_s))
    say("set-up, seconds in each phase: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])))
    if sampler is not None:
        sampler.start()
    try:
        ctx, missing = _window(pump, config, tr, block, k, seed,
                               seconds, keep_one_in, compiles)
        ctx["setup_s"] = setup_s
        if traced:
            ctx["trace"] = _traced(jax, pump, k + ctx["blocks"], tmp)
    finally:
        card = sampler.stop() if sampler is not None \
            else "card: not a GPU, nvidia-smi not read"
    return ctx, card, pump.kept, missing, ctx["blocks"] * len(pump.radios)


def _window(pump, config, tr, block, first, seed, seconds,
            keep_one_in, compiles):
    """Pump blocks back to back for ``seconds`` from block ``first``;
    → (reader context, missing radio-blocks)."""
    per_block = round(block * config["audio_samplerate"] / tr.samplerate)
    rng = np.random.default_rng([seed % (1 << 64), 1])
    t_block, t_front, t_radio = [], [], []
    missing = 0
    n_comp = compiles.n
    k = first
    prev = pump.counts.copy()
    w0 = time.perf_counter()
    while True:
        keep = k == first or rng.integers(keep_one_in) == 0
        t0, tb, t1 = pump.step(k, keep)
        missing += int(np.sum(pump.counts - prev != per_block))
        prev = pump.counts.copy()
        t_block.append(t1 - t0)
        t_front.append(tb - t0)
        t_radio.append(t1 - tb)
        k += 1
        if t1 - w0 >= seconds:
            break
    blocks = k - first
    return {"blocks": blocks, "block_len": block, "samples": blocks * block,
            "window_s": t1 - w0, "block_s": t_block, "frontend_s": t_front,
            "radios_s": t_radio, "window_compiles": compiles.n - n_comp,
            "trace": None}, missing


def _traced(jax, pump, k, tmp):
    log_dir = os.path.join(tmp, "trace")
    spans = Spans(jax)
    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0
    opts.enable_hlo_proto = False
    jax.profiler.start_trace(log_dir, profiler_options=opts)
    try:
        with jax.profiler.TraceAnnotation(trace.SPAN_PREFIX + "window"):
            pump.spans = spans
            for i in range(TRACE_BLOCKS):
                spans.switch("frontend")
                pump.step(k + i, False)
                spans.switch("harness")
            spans.close()
            pump.spans = None
    finally:
        jax.profiler.stop_trace()
    return trace.reduce(trace.find_xplane(log_dir), TRACE_BLOCKS)


if __name__ == "__main__":
    sys.exit(main())
