"""The trace reduction on a trace recorded on an NVIDIA H100: two pump
blocks of the tiny test cell (one WFM and one USB radio)."""

import os

from benchmark import trace
from benchmark.metrics import (device_busy_ms, device_idle_share,
                               kernels_per_block)
from benchmark.tests.conftest import DATA

XPLANE = os.path.join(DATA, "tiny.xplane.pb")


def test_union_merges_overlaps():
    assert trace._union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]


def test_reduction_of_recorded_trace():
    red = trace.reduce(XPLANE, 2)
    assert red["devices"] == 1
    assert 0 < red["busy_s"] < red["window_s"]
    # busy time and the idle gaps tile the window
    idle = sum(red["idle_by_span"].values())
    assert abs(red["busy_s"] + idle - red["window_s"]) < 1e-6
    assert set(red["idle_by_span"]) <= {"frontend", "radios", "harness"}
    names = [n for n, _ in red["device_ops"]]
    assert "loop_dynamic_update_slice_fusion" in names   # the AGC scan
    assert any(n.startswith("Memcpy") for n in names)
    assert red["n_ops"] == 748


def test_readers_on_recorded_trace():
    ctx = {"trace": trace.reduce(XPLANE, 2)}
    share = device_idle_share.read(ctx)
    assert 0 < share < 100
    assert kernels_per_block.read(ctx) == 374
    busy = device_busy_ms.read(ctx)
    assert abs(busy * 2e-3 - ctx["trace"]["busy_s"]) < 1e-12
    assert device_idle_share.read({"trace": None}) is None
