"""Build the port's CUDA sources into shared libraries and load them.

Route: ``nvcc`` by hand into a ``.so`` with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries go to
``build/`` at the repository root (``utils/compile_cache.py`` moves the
directory), named by a hash of the sources and the flags, so an edited
source is rebuilt and an unchanged one is reused.
Nothing is compiled at import time: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    # every source of the directory, since one may include another
    text = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cu")))
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (proc, tmp, so) or None if built."""
    src, so = _target(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, tmp, so


def _finish(name: str, job) -> None:
    proc, tmp, so = job
    out, _ = proc.communicate()
    so.with_suffix(".log").write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named sources, all nvcc processes started together."""
    names = list(names)
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    return {n: _target(n)[1] for n in names}


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) for
    the current build of ``name``, or '' if it was not built in this tree."""
    log = _target(name)[1].with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            so = build([name])[name]
            lib = ctypes.CDLL(str(so))
            _loaded[name] = lib
        return lib
