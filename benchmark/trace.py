"""Reduction of a JAX profiler trace to the benchmark's device numbers.

Reads the ``.xplane.pb`` that ``jax.profiler`` writes, with nothing but
``jax.profiler.ProfileData``:

* device planes: ``/device:GPU:<n>``; their operations are the events
  of the stream lines (``Stream #<n>(Compute,…)``, ``…(MemcpyD2H)``):
  kernels and copies;
* busy time: the union of those operations' intervals inside the traced
  window, per device, averaged over the devices;
* the traced window: the first to the last host span named
  ``<prefix>window`` (the harness wraps the traced blocks in one);
* idle gaps: the holes in the busy union inside the window, each
  attributed to the host span (``frontend``, ``radios``, ``harness``)
  that covers its midpoint.
"""

from __future__ import annotations

import bisect
import glob
import os
from collections import defaultdict
from typing import Dict, List, Tuple

SPAN_PREFIX = "bench:"


def find_xplane(log_dir: str) -> str:
    hits = sorted(glob.glob(os.path.join(log_dir, "plugins", "profile",
                                         "*", "*.xplane.pb")))
    if not hits:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    return hits[-1]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _clip(iv, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in iv if e > lo and s < hi]


def reduce(path: str, n_blocks: int) -> Dict:
    """→ {busy_s, window_s, n_ops, blocks, device_ops: [(name, s)],
    idle_gaps: [(span, s)], idle_by_span: {span: s}}; busy and idle are
    averaged over the device planes found."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(path)
    spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    devices = []
    for plane in pd.planes:
        if plane.name.startswith("/device:GPU"):
            devices.append(plane)
        elif plane.name.startswith("/host:"):
            for line in plane.lines:
                for ev in line.events:
                    if ev.name.startswith(SPAN_PREFIX):
                        spans[ev.name[len(SPAN_PREFIX):]].append(
                            (int(ev.start_ns), int(ev.end_ns)))
    if not devices:
        raise ValueError(f"{path}: no /device:GPU plane")
    if not spans.get("window"):
        raise ValueError(f"{path}: no {SPAN_PREFIX}window span")
    lo = min(s for s, _ in spans["window"])
    hi = max(e for _, e in spans["window"])
    host = sorted((s, e, name) for name, iv in spans.items()
                  if name != "window" for s, e in iv)
    starts = [s for s, _, _ in host]

    def owner(t):
        i = bisect.bisect_right(starts, t) - 1
        return host[i][2] if i >= 0 and t < host[i][1] else "harness"

    busy_ns, n_ops = 0, 0
    op_ns: Dict[str, int] = defaultdict(int)
    gaps: List[Tuple[str, int]] = []
    by_span: Dict[str, int] = defaultdict(int)
    for plane in devices:
        ivs = []
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                s, e = int(ev.start_ns), int(ev.end_ns)
                if e <= lo or s >= hi or e <= s:
                    continue
                ivs.append((s, e))
                n_ops += 1
                a, b = max(s, lo), min(e, hi)
                op_ns[ev.name] += b - a
        busy = _clip(_union(ivs), lo, hi)
        busy_ns += sum(e - s for s, e in busy)
        edges = [lo] + [t for iv in busy for t in iv] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            name = owner((a + b) // 2)
            gaps.append((name, b - a))
            by_span[name] += b - a
    nd = len(devices)
    gaps.sort(key=lambda g: -g[1])
    return {
        "busy_s": busy_ns / nd * 1e-9,
        "window_s": (hi - lo) * 1e-9,
        "n_ops": n_ops / nd,
        "blocks": n_blocks,
        "devices": nd,
        "device_ops": sorted(((k, v * 1e-9) for k, v in op_ns.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": [(name, ns * 1e-9) for name, ns in gaps[:10]],
        "idle_by_span": {k: v / nd * 1e-9 for k, v in
                         sorted(by_span.items(), key=lambda kv: -kv[1])},
    }
