"""JAX's persistent compilation cache at one fixed place.

The engines compile one program per (config, input shape), and a cold
compile of the flagship step takes seconds to tens of seconds.  Every entry
point (``cli/serve.py``, ``cli/backfill.py``, ``bench.py``,
``chip_smoke.py``, ``tools/*``) calls :func:`enable_compile_cache` so a
second run of the same shapes loads the compiled programs from disk.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing is set in
  code.
* unset: the cache goes to ``.jax_cache/`` at the checkout root (listed in
  ``.gitignore``).  The path is fixed on purpose: a temporary or
  per-process directory would never be found again by the next run.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its one directory.

    Returns the directory in use.  Safe to call more than once.
    """
    import jax

    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
