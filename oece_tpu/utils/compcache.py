"""Persistent XLA compilation cache.

The blind-rotation scan and the per-level circuit programs cost seconds of
compile time per distinct padded batch shape.  The reference amortizes its
analogous setup cost by caching the compiled ``.out`` artifact on disk
(README.md:29-30); here the compiled *device program* itself is cached, so
a second run of bench.py / a TB skips the compile.

Placement: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
and nothing here overrides it.  Otherwise the cache lives at one fixed
directory inside the checkout (``.jax_cache``, git-ignored): the path is
part of the cache key, so a directory that moved would never hit.

Enabled by ``runtime.evaluator.Circuit``, ``harness.tb`` and ``bench.py``.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache")
)

_enabled = False


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get(ENV_VAR) or REPO_CACHE_DIR


def enable_compilation_cache() -> bool:
    """Idempotently turn on JAX's persistent compilation cache.

    Returns True when the cache is active.  Safe to call before or after
    backend initialization (the config knobs are read at compile time).
    """
    global _enabled
    if _enabled:
        return True
    import jax

    if jax.default_backend() == "cpu":
        # CPU compiles are fast and XLA:CPU AOT cache entries carry
        # machine-feature assumptions (SIGILL risk on mismatch) — skip.
        return False
    if not os.environ.get(ENV_VAR):
        os.makedirs(REPO_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    # cache every program that takes >=1s to compile (tiny eager helpers
    # stay uncached to keep the directory small)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _enabled = True
    return True
