"""Process-wide JAX runtime setup helpers.

The fused frame step is a large program; every entry point (apps, bench,
chip_smoke.py, driver hooks) shares one persistent compilation cache so only
the first run after a code change pays the compile.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

import jax

# A fixed path inside the checkout: the cache key includes the directory, so a
# directory that moves between runs never hits.
REPO_CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")


def compilation_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else `<checkout>/.jax_cache`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at `compilation_cache_dir()`.

    When `JAX_COMPILATION_CACHE_DIR` is set JAX reads it itself and no other
    directory is set here.  Returns the directory in use.
    """
    cache_dir = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir


def full_f32_matmuls(fn):
    """Trace `fn` with every float32 contraction at full float32 precision.

    On the GPU a DEFAULT-precision f32 matmul may run in TF32 (about three
    decimal digits), which would round the one-hot "gathers" of poses, map
    points and pixels.  Contractions with explicit bf16 operands (the
    `ba_assembly_precision: bf16` option) keep their precision.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
