"""Persistent XLA compilation cache, enabled by the CLI, bench and driver
entry points.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no other
directory is set here. Otherwise the cache lives at a fixed path inside the
checkout, `<repo>/.jax_cache` (listed in .gitignore): the path is part of
the cache's key, so a directory that moves never hits."""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent compile cache uses."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
