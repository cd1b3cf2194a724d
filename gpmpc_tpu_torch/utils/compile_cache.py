"""The port's compilation cache (counterpart of
``gpmpc_tpu/utils/compile_cache.py``).

The JAX package points XLA's persistent compilation cache at a directory.
The port's compiled artefacts are the kernel libraries that
``ops/kernels/_build.py`` builds with nvcc: each is named by a hash of the
sources and the flags, so an unchanged source is loaded from the directory
and never rebuilt, and a directory kept between runs is that cache.

Usage: call :func:`enable_compilation_cache` before the first kernel
launch (the first launch builds and loads the libraries from the build
directory of that moment; a later call raises).
"""

from __future__ import annotations

import os
from pathlib import Path

from ..ops.kernels import _build

_DEFAULT_DIR = str(_build.BUILD_DIR)


def _prune_lru(cache_dir: str, max_bytes: int) -> None:
    """Remove the least recently used files of ``cache_dir`` (oldest access
    first) until the files there hold at most ``max_bytes``: every edit of a
    kernel source adds a library, so a long sweep grows the directory
    without bound otherwise."""
    entries = []
    total = 0
    for name in os.listdir(cache_dir):
        p = os.path.join(cache_dir, name)
        try:
            st = os.stat(p)
        except OSError:
            continue
        if os.path.isfile(p):
            entries.append((st.st_atime, st.st_size, p))
            total += st.st_size
    if total <= max_bytes:
        return
    for _, size, p in sorted(entries):
        try:
            os.remove(p)
        except OSError:
            continue
        total -= size
        if total <= max_bytes:
            break


def enable_compilation_cache(path: str | None = None) -> str:
    """Point the kernel build directory at ``path`` (default: the
    ``GPMPC_JAX_CACHE`` environment variable, else the repository's
    ``build/``), create it, and evict least-recently-used files beyond the
    budget (``GPMPC_JAX_CACHE_MAX_GB``, default 8), the JAX function's two
    settings. Returns the absolute directory. Raises if a kernel library
    was already loaded from another directory."""
    cache_dir = os.path.abspath(path or os.environ.get("GPMPC_JAX_CACHE", _DEFAULT_DIR))
    if _build._loaded and Path(cache_dir) != _build.BUILD_DIR:
        raise RuntimeError(
            f"enable_compilation_cache({cache_dir!r}) after the first kernel launch, which "
            f"loaded its libraries from {_build.BUILD_DIR}: call it before any launch")
    os.makedirs(cache_dir, exist_ok=True)
    max_gb = float(os.environ.get("GPMPC_JAX_CACHE_MAX_GB", "8"))
    _prune_lru(cache_dir, int(max_gb * 2**30))
    _build.BUILD_DIR = Path(cache_dir)
    return cache_dir
