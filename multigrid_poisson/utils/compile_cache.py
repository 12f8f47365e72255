"""Persistent XLA compilation cache location.

A cold run of a large schedule spends most of its set-up time compiling, so
the entry points (CLI, ``bench.py``, ``chip_smoke.py``) keep compiled
programs on disk. The cache key includes the directory, so it must be a
fixed path: ``JAX_COMPILATION_CACHE_DIR`` when the environment sets it (JAX
reads that variable itself, so nothing is set here), otherwise
``<repo>/.jax_cache``, which ``.gitignore`` lists.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
