"""Persistent XLA compilation cache.

The whole run is a handful of large jitted programs (the fori_loop
trainer, the top-1 scan).  JAX's persistent cache makes every later
process start warm — the analogue of the reference shipping prebuilt
binaries (its `make` step) rather than recompiling per run.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set
(JAX reads it itself, and this module sets no other path); otherwise
one fixed directory inside the checkout, ``<repo>/.jax_cache`` (listed
in ``.gitignore``).  The path is part of every cache key's lookup, so
it never depends on a temporary name, a process id or the time.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), ".jax_cache"
)


def enable_persistent_cache() -> None:
    """Idempotently turn on the on-disk compilation cache."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
