"""Persistent XLA compile cache location, shared by every entry point.

The fixpoint graphs are compile-heavy, so the CLI, the benchmark, the chip
smoke test, the scripts and the test suite all keep compiled executables
across runs in ONE place: ``JAX_COMPILATION_CACHE_DIR`` when the environment
sets it (and then no other directory), else a fixed ``.jax_cache/`` at the
checkout root.  The path is part of the cache key, so it must not move
between runs.  Call ``enable_compile_cache`` before JAX is imported.
"""

from __future__ import annotations

import os

__all__ = ["DEFAULT_CACHE_DIR", "compile_cache_dir", "enable_compile_cache"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``compile_cache_dir()`` (via
    the environment JAX reads when it is imported) and return the path."""
    path = compile_cache_dir()
    os.environ["JAX_COMPILATION_CACHE_DIR"] = path
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
    return path
