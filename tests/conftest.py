"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh (no accelerator needed), mirroring how the
reference tests run fully in-process with file sources and null audio sinks
(reference: e2e/e2e_common.py base config, tests/test_runner.h).
Must set the env vars before jax initialises its backends.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

# jax may already be imported (a plugin or sitecustomize) before conftest
# runs, so the env var alone is not enough — override the live config
# before any backend is instantiated.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

assert jax.devices()[0].platform == "cpu"

# Build the native runtime library once per session when the toolchain
# is available, so tests/test_native.py exercises the real C++ paths
# instead of skipping (the .so is gitignored; ~2 s incremental build).
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_SO = os.path.join(_REPO, "native", "build",
                          "libsdrpp_tpu_native.so")
if not os.path.exists(_NATIVE_SO):
    import shutil
    import subprocess
    if shutil.which("cmake") and shutil.which("ninja"):
        try:
            subprocess.run(
                ["bash", os.path.join(_REPO, "scripts",
                                      "build_native.sh")],
                check=True, capture_output=True, timeout=300)
        except (subprocess.SubprocessError, OSError):
            pass          # tests fall back to their skip condition


@pytest.fixture
def rng():
    return np.random.default_rng(12345)

