"""Persistent (on-disk) cache of the port's compiled kernels: cold starts
stop paying nvcc.

The port of `repro/core/cache.py`.  What the port compiles that outlives a
process is the hand-written kernels' shared libraries: `kernels/_build.py`
runs nvcc once per CUDA source into a build directory and loads the library
from there in every later process.  Its default directory is
`repro_torch/kernels/build/` inside the checkout; enabling this cache
re-roots it at a directory of the caller's choosing, which a fresh checkout,
a container or another host can share.  CUDA graphs and the in-memory
program caches (`montecarlo`'s and the sweep engine's, keyed on the grid
signature) die with the process, as the reference's in-memory caches do,
and PyTorch's eager ops need no compile.

Key convention: a library's file name carries a hash of its source, the
nvcc flags and the output of ``nvcc --version``
(`kernels/_build.py::library_path`), so

* the same sources in a fresh process -> every library found, nvcc not run,
* an edited source -> a miss for that source only, compiled once, then
  found by every later process,
* another toolkit -> misses: one directory is safe to share between hosts
  with different toolkits, and stale entries are never hit.

Opt-in, never default: tests and `chip_smoke.py` measure the build from a
clean checkout unless they explicitly warm a directory.

Usage::

    from repro_torch.core import cache
    cache.enable_persistent_cache("/var/cache/repro-kernels")   # or
    cache.maybe_enable_from_env()   # REPRO_COMPILATION_CACHE_DIR

    # CLI: python -m repro_torch.launch.train --cache-dir /var/cache/repro-kernels
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from repro_torch.kernels import _build

__all__ = [
    "enable_persistent_cache",
    "disable_persistent_cache",
    "persistent_cache_dir",
    "cache_entries",
    "maybe_enable_from_env",
    "ENV_VAR",
]

# Environment opt-in consumed by maybe_enable_from_env() (the train CLI
# calls it, and subprocess tests use it to enable caching without code
# changes).
ENV_VAR = "REPRO_COMPILATION_CACHE_DIR"


def enable_persistent_cache(cache_dir: str) -> str:
    """Build and load the kernels' libraries under ``cache_dir``.

    Creates the directory if needed.  Idempotent; returns the (absolute)
    cache directory."""
    cache_dir = os.path.abspath(cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    _build.BUILD_DIR = Path(cache_dir)
    return cache_dir


def disable_persistent_cache() -> None:
    """Back to the checkout's own build directory (libraries already loaded
    stay loaded)."""
    _build.BUILD_DIR = _build.DEFAULT_BUILD_DIR


def persistent_cache_dir() -> Optional[str]:
    """The active cache directory, or None when the default build directory
    is in use."""
    return None if _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR else str(_build.BUILD_DIR)


def cache_entries(cache_dir: Optional[str] = None) -> int:
    """Number of persisted entries (files) under ``cache_dir`` (default: the
    active directory).  The entry *delta* across a run is the observable
    compile count: a fully-warmed process adds exactly 0, an edited source
    adds exactly its one library."""
    if cache_dir is None:
        cache_dir = persistent_cache_dir()
    if cache_dir is None or not os.path.isdir(cache_dir):
        return 0
    n = 0
    for _, _, files in os.walk(cache_dir):
        n += len(files)
    return n


def maybe_enable_from_env() -> Optional[str]:
    """Enable the cache iff ``REPRO_COMPILATION_CACHE_DIR`` is set (and
    non-empty); returns the directory or None.  The launcher calls this so
    deployments opt in via environment without touching code."""
    cache_dir = os.environ.get(ENV_VAR, "")
    if not cache_dir:
        return None
    return enable_persistent_cache(cache_dir)
