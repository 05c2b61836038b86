"""Where JAX keeps compiled programs between processes.

Every plan shape is its own XLA program, so a cold process spends much of
its start compiling. JAX's persistent compilation cache keeps those
programs on disk; its key includes the directory, so the directory must
not move between runs.
"""
from __future__ import annotations

import os

import jax

# <checkout>/.jax_cache (listed in .gitignore)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def configure_compile_cache() -> str:
    """Use JAX_COMPILATION_CACHE_DIR when the environment sets it (JAX
    reads it itself; no path is set here), else the fixed directory
    DEFAULT_DIR inside the checkout. Programs are cached whatever their
    compile time, unless JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS says
    otherwise. Returns the directory in use."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    if "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS" not in os.environ:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
