"""Process set-up shared by the entry points.

:func:`apply_env_platform` makes an explicit ``JAX_PLATFORMS`` from the
user's environment win over any backend a site configuration registers.
:func:`enable_compile_cache` points JAX's persistent compilation cache at one
fixed directory, so every process started from the same checkout (the
server, the offline renderer, the benchmark, fleet workers) reuses what
another one compiled.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def apply_env_platform():
    want = os.environ.get("JAX_PLATFORMS")
    if want:
        import jax

        try:
            jax.config.update("jax_platforms", want)
        except Exception:
            pass


def enable_compile_cache() -> str:
    """Use ``JAX_COMPILATION_CACHE_DIR`` when it is set, and
    ``<checkout>/.jax_cache`` otherwise; returns the directory.

    The fallback is exported to the environment, where JAX reads it when
    it is imported and child processes (fleet workers) inherit it; a JAX
    that is already imported is told directly."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(CHECKOUT / ".jax_cache")
        os.environ["JAX_COMPILATION_CACHE_DIR"] = path
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
