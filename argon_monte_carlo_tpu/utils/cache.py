"""The persistent XLA compilation cache, in one place.

Every entry point (``cli.main``, ``bench.py``, ``chip_smoke.py``, the
kept scripts and the test harness) calls ``enable_compile_cache()``
before its first compile.  If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
already reads it and this module sets nothing.  Otherwise the cache
lives at one fixed, git-ignored path inside the checkout
(``<repo>/.jax_cache``).  The path is part of what makes a later run hit
the cache, so it never depends on the home directory, the temp
directory, a process id or a timestamp.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir() -> str:
    """The directory the compilation cache uses in this process."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX at ``compile_cache_dir()``; returns that directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
