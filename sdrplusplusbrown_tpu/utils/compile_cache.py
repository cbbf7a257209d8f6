"""Where the persistent XLA compilation cache lives.

The 65536-bin spectrum and the wide banks take long to compile, so every
entry point keeps compiled programs on disk.  One rule, shared by the
server (``__main__``), ``bench.py`` and ``chip_smoke.py``:

* ``JAX_COMPILATION_CACHE_DIR`` set — JAX reads it itself; nothing else
  is configured here.
* unset — ``<checkout>/.jax_cache``.  The path is fixed (no temporary
  directory, PID or timestamp), so a later run in the same checkout
  finds what an earlier one compiled.
"""

from __future__ import annotations

import os
from typing import Mapping

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def cache_dir(environ: Mapping[str, str] = os.environ) -> str:
    """The directory the cache uses under ``environ``."""
    return environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache(environ: Mapping[str, str] = os.environ) -> str:
    """Point JAX's persistent cache at :func:`cache_dir`; returns it."""
    import jax
    path = cache_dir(environ)
    if not environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
