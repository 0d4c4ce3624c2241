"""JAX's persistent compilation cache, kept in one place.

The cache lives where `JAX_COMPILATION_CACHE_DIR` says when that variable
is set, and otherwise in `.jax_cache/` at the root of the checkout.  The
path is part of what makes a cache hit, so it is fixed: never built from
a temporary name, a process id or the time.
"""
from __future__ import annotations

import os
import pathlib

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    return os.environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable_compile_cache() -> str:
    """Points JAX's persistent cache at `cache_dir()`, caching every
    executable however quick its compile; returns the directory."""
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
