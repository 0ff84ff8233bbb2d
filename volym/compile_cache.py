"""Where JAX keeps its persistent compilation cache.

Every entry point (``cli.main``, the viewer, ``bench.py``,
``chip_smoke.py``) calls :func:`enable` before its first compile, so a
second run of the same program on the same machine loads its executables
instead of compiling them again.  ``JAX_COMPILATION_CACHE_DIR`` wins when
it is set; otherwise the cache lives at a fixed ``<repo>/.jax_cache``
(listed in ``.gitignore``).  The path is part of the cache key, so it is
never derived from a temporary name, a pid or the time.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def cache_dir(env=os.environ) -> str:
    """The cache directory: ``$JAX_COMPILATION_CACHE_DIR`` or the repo's."""
    return env.get(ENV) or str(DEFAULT_DIR)


def enable(env=os.environ) -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`;
    returns the directory."""
    import jax

    path = cache_dir(env)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
