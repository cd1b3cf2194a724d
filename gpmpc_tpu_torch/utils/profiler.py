"""Profiling and control-loop benchmarking (counterpart of
``gpmpc_tpu/utils/profiler.py``): the ``Timer`` context manager, the
``Profiler`` with named-section accumulation and a percentage report, the
``profile_function`` decorator, ``LoopTiming`` with its 50/100 Hz
predicates, ``ControlLoopBenchmark`` with warm-up exclusion and
percentile-based verdicts, and ``MemoryProfiler``'s byte accounting.

CUDA runs asynchronously, so a wall time must wait for the work it times:
every timed section synchronizes the devices of the tensors handed to it
(``torch.cuda.synchronize`` for a CUDA tensor; nothing for a CPU one), and
:func:`trace` wraps a region in ``torch.profiler`` for kernel-level
inspection.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch


def _leaves(tree):
    """The tensors of a nested structure (tensors, sequences, mappings,
    named tuples, dataclasses)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def block_until_ready(tree):
    """Wait for the work producing the tensors of ``tree``: synchronize every
    CUDA device they lie on. Returns ``tree``."""
    for dev in {t.device for t in _leaves(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return tree


@dataclass
class LoopTiming:
    """Per-iteration section breakdown."""

    gp_ms: float = 0.0
    mpc_ms: float = 0.0
    safety_ms: float = 0.0
    dynamics_ms: float = 0.0
    overhead_ms: float = 0.0

    @property
    def total_ms(self) -> float:
        return self.gp_ms + self.mpc_ms + self.safety_ms + self.dynamics_ms + self.overhead_ms

    @property
    def achieves_50hz(self) -> bool:
        return self.total_ms < 20.0

    @property
    def achieves_100hz(self) -> bool:
        return self.total_ms < 10.0


class Timer:
    """Context manager measuring wall time in ms, waiting for ``result``'s
    tensors before it stops."""

    def __init__(self, name: str = "", result=None):
        self.name = name
        self._result = result
        self.elapsed_ms = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._result is not None:
            block_until_ready(self._result)
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        return False


class Profiler:
    """Named-section accumulation with stats and a percentage report."""

    def __init__(self):
        self._sections: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def section(self, name: str, result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if result is not None:
                block_until_ready(result)
            self._sections[name].append((time.perf_counter() - t0) * 1e3)

    def add(self, name: str, elapsed_ms: float) -> None:
        self._sections[name].append(elapsed_ms)

    def stats(self, name: str) -> dict:
        v = np.asarray(self._sections[name])
        return {
            "n": len(v), "mean_ms": float(v.mean()), "std_ms": float(v.std()),
            "min_ms": float(v.min()), "max_ms": float(v.max()),
            "p95_ms": float(np.percentile(v, 95)),
        }

    def report(self) -> str:
        total = sum(sum(v) for v in self._sections.values())
        lines = [f"{'section':24s} {'n':>5s} {'mean':>9s} {'p95':>9s} {'%':>6s}"]
        for name, v in sorted(self._sections.items()):
            s = self.stats(name)
            pct = 100.0 * sum(v) / max(total, 1e-9)
            lines.append(
                f"{name:24s} {s['n']:5d} {s['mean_ms']:8.2f}m {s['p95_ms']:8.2f}m {pct:5.1f}%")
        return "\n".join(lines)

    def reset(self) -> None:
        self._sections.clear()


def profile_function(profiler: Profiler, name: Optional[str] = None) -> Callable:
    """Decorator accumulating a function's wall time (its outputs waited
    for) into ``profiler``."""

    def deco(fn):
        sec = name or fn.__name__

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            block_until_ready(out)
            profiler.add(sec, (time.perf_counter() - t0) * 1e3)
            return out

        return wrapped

    return deco


@dataclass
class BenchmarkResults:
    """Loop timings after ``warmup`` with percentile-based 50/100 Hz
    verdicts."""

    timings: list = field(default_factory=list)
    warmup: int = 3

    def add(self, t: LoopTiming) -> None:
        self.timings.append(t)

    @property
    def _totals(self) -> np.ndarray:
        return np.asarray([t.total_ms for t in self.timings[self.warmup:]] or [0.0])

    def get_percentile(self, p: float) -> float:
        return float(np.percentile(self._totals, p))

    @property
    def meets_50hz(self) -> bool:
        return self.get_percentile(95) < 20.0

    @property
    def meets_100hz(self) -> bool:
        return self.get_percentile(95) < 10.0

    def summary(self) -> dict:
        v = self._totals
        return {
            "n": len(v), "mean_ms": float(v.mean()), "p50_ms": self.get_percentile(50),
            "p95_ms": self.get_percentile(95), "max_ms": float(v.max()),
            "meets_50hz": self.meets_50hz, "meets_100hz": self.meets_100hz,
        }


class ControlLoopBenchmark:
    """Times the GP/MPC/safety/dynamics phases of each control step, the
    first ``warmup`` steps excluded; ``finish_step`` closes a step."""

    def __init__(self, warmup: int = 3):
        self.results = BenchmarkResults(warmup=warmup)
        self._current: Optional[LoopTiming] = None

    def start_step(self) -> None:
        self._current = LoopTiming()

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if result is not None:
                block_until_ready(result)
            ms = (time.perf_counter() - t0) * 1e3
            setattr(self._current, f"{name}_ms", getattr(self._current, f"{name}_ms") + ms)

    def finish_step(self) -> None:
        self.results.add(self._current)
        self._current = None


class MemoryProfiler:
    """Byte accounting of the tensors of nested structures."""

    @staticmethod
    def nbytes(tree) -> int:
        return sum(t.numel() * t.element_size() for t in _leaves(tree))

    @staticmethod
    def report(named_trees: Dict[str, object]) -> str:
        lines = []
        for name, tree in named_trees.items():
            mb = MemoryProfiler.nbytes(tree) / 1e6
            lines.append(f"{name:30s} {mb:10.3f} MB")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Wrap a region in ``torch.profiler`` (CPU and, where present, CUDA
    activity) and write a Chrome trace under ``log_dir``."""
    import os

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _timed(fn: Callable, n_repeats: int) -> np.ndarray:
    block_until_ready(fn())  # warm-up (the first call builds kernels)
    times = []
    for _ in range(n_repeats):
        t0 = time.perf_counter()
        block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return np.asarray(times)


def benchmark_gp_prediction(predict_fn: Callable, X, n_repeats: int = 20) -> dict:
    """Wall times of ``predict_fn(X)`` with the 5 ms verdict."""
    v = _timed(lambda: predict_fn(X), n_repeats)
    p95 = float(np.percentile(v, 95))
    return {"mean_ms": float(v.mean()), "p95_ms": p95, "meets_5ms": p95 < 5.0}


def benchmark_mpc_solve(solve_fn: Callable, args, n_repeats: int = 10) -> dict:
    """Wall times of ``solve_fn(*args)`` with the 50/100 Hz verdicts."""
    v = _timed(lambda: solve_fn(*args), n_repeats)
    p95 = float(np.percentile(v, 95))
    return {"mean_ms": float(v.mean()), "p95_ms": p95, "meets_50hz": p95 < 20.0,
            "meets_100hz": p95 < 10.0}
