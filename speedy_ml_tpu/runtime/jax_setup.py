"""Process-level JAX setup shared by every entry point.

- `enable_compile_cache`: the one place that turns on JAX's persistent
  compilation cache.  `$JAX_COMPILATION_CACHE_DIR` wins when it is set;
  otherwise the cache lives at `<checkout>/.jax_cache` (git-ignored).
  The path is part of the cache key, so it is fixed, never per-run.
- `host_device`: the in-process CPU device used for host-side table
  construction and training prep, or None when the CPU platform is not
  loaded (e.g. `JAX_PLATFORMS=cuda`); callers then use the default
  device.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path

import jax

CHECKOUT = Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = CHECKOUT / ".jax_cache"


def compile_cache_dir() -> str:
    """Where the persistent compilation cache lives for this process."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        DEFAULT_CACHE_DIR)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache for programs that take at
    least 2 s to compile; returns its directory."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return path


def host_device():
    """The in-process CPU device, or None if the CPU platform is absent."""
    try:
        return jax.devices("cpu")[0]
    except RuntimeError:
        return None


def on_host():
    """Context placing new arrays on the CPU device (no-op without one)."""
    dev = host_device()
    return contextlib.nullcontext() if dev is None else jax.default_device(dev)
