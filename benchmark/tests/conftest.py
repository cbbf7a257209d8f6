import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
DATA = os.path.join(HERE, "data")


@pytest.fixture
def rehearse(tmp_path):
    """Run the harness on the CPU on the tiny test cell in a child
    process (``--seconds 1``); → (exit code, stdout lines, stderr)."""
    def go(*extra, fault=None):
        code = (
            "import sys; sys.path.insert(0, {root!r});"
            "from benchmark import run;"
            "from benchmark.tests import faults;"
            "sys.exit(run.main(['--workload', 'tiny', '--seed', "
            "'3000000017', '--seconds', '1', *{extra!r}], allow_cpu=True,"
            " spec_dir={data!r}, bench_json={bench!r}, cache_dir={cache!r},"
            " app_hook={hook}))").format(
                root=ROOT, extra=list(extra), data=DATA,
                bench=os.path.join(DATA, "BENCHMARK.json"),
                cache=str(tmp_path / "cache"),
                hook=f"faults.{fault}" if fault else "None")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, env=env, timeout=600, cwd=str(tmp_path))
        return p.returncode, p.stdout.strip().splitlines(), p.stderr
    return go
