"""The harness's control flow on the CPU at the tiny test cell."""

import json
import os
import subprocess
import sys

from benchmark.tests.conftest import DATA, ROOT


def test_run_prints_one_result_line(rehearse):
    rc, out, err = rehearse("--trace", "0")
    assert rc == 0, err[-3000:]
    result = json.loads(out[-1])
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    bench = json.load(open(os.path.join(DATA, "BENCHMARK.json")))
    assert set(result["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    assert result["device"]["platform"] == "cpu"
    # every number compared is also on the last lines of standard error
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") for line in tail)


def test_no_gpu_means_no_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", "fm_broadcast.vfo8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        timeout=300, cwd=ROOT)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "needs a GPU" in p.stderr
