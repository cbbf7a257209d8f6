"""The GPU entry points on the CPU: the compile-cache rule, bench.py's
cells and their oracles, chip_smoke's comparison and oracle functions at
small width, and both scripts refusing to measure without a GPU.  The
one test that needs the card is marked ``gpu`` and skips without one."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from sdrplusplusbrown_tpu.utils import compile_cache  # noqa: E402


# ---------------------------------------------------------------- cache
def test_cache_dir_follows_the_variable():
    env = {compile_cache.ENV_VAR: "/some/where"}
    assert compile_cache.cache_dir(env) == "/some/where"


@pytest.mark.parametrize("env", [{}, {compile_cache.ENV_VAR: ""}])
def test_cache_dir_defaults_to_the_checkout(env):
    assert compile_cache.cache_dir(env) == os.path.join(REPO, ".jax_cache")
    assert compile_cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")


@pytest.fixture
def cache_config():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_enable_sets_the_default_when_unset(cache_config):
    path = compile_cache.enable_compile_cache({})
    assert path == compile_cache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == path


def test_enable_leaves_jax_alone_when_set(cache_config):
    jax.config.update("jax_compilation_cache_dir", "/already/set")
    path = compile_cache.enable_compile_cache(
        {compile_cache.ENV_VAR: "/from/env"})
    assert path == "/from/env"
    assert jax.config.jax_compilation_cache_dir == "/already/set"


# ---------------------------------------------------------------- no GPU
def test_chip_smoke_refuses_the_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_the_cpu(capsys):
    assert bench.main([]) == 2
    assert "configs" not in capsys.readouterr().out


# ---------------------------------------------------------------- cells
@pytest.mark.parametrize("name", list(bench.BUILDERS))
def test_bench_cell_passes_its_oracles(name):
    """Each benchmark cell at full width, 3 state-carrying steps."""
    cell = bench.BUILDERS[name](seed=0, n_blocks=3)
    run = chip_smoke.run_cell(cell, jax.devices()[0])
    assert len(run["outs"]) == 3
    for check in cell.oracle(run["outs"]):
        assert check.ok, check


def _tiny_cell(taps_scale=1.0):
    from sdrplusplusbrown_tpu.ops.fir import FIR
    fir = FIR(np.hanning(33) * taps_scale, decim=2)
    x = np.exp(2j * np.pi * 0.01 * np.arange(3 * 512)).astype(np.complex64)

    def step(params, state, xb):
        y, state = fir.apply(None, state, xb)
        return (y,), state

    return bench.Cell("tiny", step, None, fir.init_state(),
                      [x[i * 512:(i + 1) * 512] for i in range(3)], 512,
                      1.0, lambda outs: [], lambda o: [o[0]])


def test_compare_reference_run_agrees():
    cpu = jax.devices("cpu")[0]
    cell = _tiny_cell()
    got = chip_smoke.run_cell(cell, cpu)
    ref = chip_smoke.run_cell(cell, cpu, precision="highest",
                              fir_backend="conv")
    snrs = chip_smoke.compare(cell, got["outs"], ref["outs"])
    assert len(snrs) == 1 and snrs[0] > 100.0
    assert got["compile_s"] > 0 and len(got["step_s"]) == 3


def test_compare_catches_a_wrong_output():
    cpu = jax.devices("cpu")[0]
    good = chip_smoke.run_cell(_tiny_cell(), cpu)
    bad = chip_smoke.run_cell(_tiny_cell(1.01), cpu)
    snr = chip_smoke.compare(_tiny_cell(), bad["outs"], good["outs"])[0]
    assert 35.0 < snr < chip_smoke.REF_SNR_DB


# ---------------------------------------------------------------- served
def _lr(f_l, f_r, n=48_000, sr=48_000.0):
    t = np.arange(n) / sr
    return np.stack([0.5 * np.sin(2 * np.pi * f_l * t),
                     0.5 * np.sin(2 * np.pi * f_r * t)])


def test_served_oracles_pass_on_clean_audio():
    _, f_l, f_r = chip_smoke.WFM_A
    nfm = _lr(chip_smoke.NFM_C[1], chip_smoke.NFM_C[1])
    checks = chip_smoke.served_oracles(_lr(f_l, f_r), nfm, 35.0, 3.0,
                                       0.01)
    assert all(c.ok for c in checks), checks


def test_served_oracles_fail_on_swapped_channels():
    _, f_l, f_r = chip_smoke.WFM_A
    nfm = _lr(chip_smoke.NFM_C[1], chip_smoke.NFM_C[1])
    checks = chip_smoke.served_oracles(_lr(f_r, f_l), nfm, 35.0, 25.0,
                                       float("nan"))
    failed = {c.name for c in checks if not c.ok}
    assert failed == {"WFM off-carrier SNR dB", "WFM L tone amplitude",
                      "WFM stereo separation dB", "rtFactor finite"}


def test_served_capture_round_trips(tmp_path):
    from sdrplusplusbrown_tpu.io.wav import read_wav_iq
    p = str(tmp_path / "baseband_100000000Hz_12-00-00_01-01-2026.wav")
    chip_smoke.served_capture(p, seed=1, seconds=0.05)
    x, fs = read_wav_iq(p)
    assert fs == chip_smoke.SERVED_FS and len(x) == 120_000
    # carriers sum to at most 1; the noise adds a few thousandths
    assert np.abs(x).max() < 1.02


# ---------------------------------------------------------------- multi
def test_multi_compare_on_four_cpu_devices():
    """The four-card phase at small width over four virtual CPU devices
    (tests/conftest.py provides eight)."""
    snr, sep = chip_smoke.multi_compare(jax.devices()[:4], C=4,
                                        t_target=12_000, n_blocks=2)
    assert snr > chip_smoke.MULTI_SNR_DB
    assert sep > 12.0


# ---------------------------------------------------------------- GPU
def _have_gpu() -> bool:
    smi = shutil.which("nvidia-smi")
    return bool(smi) and subprocess.run(
        [smi, "-L"], capture_output=True).returncode == 0


@pytest.mark.gpu
def test_chip_smoke_on_the_gpu():
    """The smoke test itself, in a child process free to take the card
    (this process is pinned to the CPU by tests/conftest.py)."""
    if not _have_gpu():
        pytest.skip("no NVIDIA GPU on this machine")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=env, capture_output=True, text=True,
                       timeout=1200)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
