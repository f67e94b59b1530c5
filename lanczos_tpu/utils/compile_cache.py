"""Persistent XLA compilation cache.

The fused while_loop engines compile into a handful of large XLA programs.
JAX's persistent compilation cache serializes each compiled executable to
disk, so a later process loads it instead of compiling again.

Where the cache lives:

- if ``JAX_COMPILATION_CACHE_DIR`` is set, the cache uses that directory
  and no other;
- otherwise :func:`enable_compilation_cache` points the cache at one fixed
  directory inside the checkout, ``<repo>/.jax_cache`` (listed in
  ``.gitignore``).  The path is part of each entry's key, so it must not
  move between runs.

Opt-in: a library must not silently mutate global jax config, so only
entry points that want it (``bench.py``, ``chip_smoke.py``) call it.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), ".jax_cache"
)


def enable_compilation_cache() -> str:
    """Turn on jax's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set; otherwise the cache goes to
    :data:`REPO_CACHE_DIR`.  Idempotent; affects programs compiled from then
    on.  Every program is persisted, however short its compile.
    """
    import jax

    cache_dir = os.environ.get(ENV_VAR) or REPO_CACHE_DIR
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return cache_dir
