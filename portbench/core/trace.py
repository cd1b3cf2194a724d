"""The traced run: a torch.profiler window over a fixed stretch of a cell's
units (cycles, campaign steps, builds or queries), the chunk launches inside
it, and the reduction of its events to what the per-layer readers take.

The profiler is on only in runs with ``--trace 1``, and only between the
unit boundaries the traffic names, with the device synchronized at both
ends; the launches are recorded by a wrapper round the chunk wrapper's entry
that keeps a reference to each launch's A and counts its nonzeros once the
window has closed, so that the window holds no work of the benchmark's own.
The memory that the window holds for this (and the allocator's cache grown
before it) is the benchmark's, not the program's: the run's peak is read
before the window opens and again from when it has closed.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

# record_function ranges of the program: on the device they are ranges over
# its ops, not ops
SPAN_PREFIXES = ("gpmpc.", "rti.", "admm.", "online.", "fleet.", "lmpc.", "safety.", "scvx.",
                 "campaign.")

Interval = Tuple[str, float, float]  # (name, start µs, end µs)
RESERVE_BYTES = 24 << 30


@dataclass
class TraceData:
    window_s: float
    units: int
    trajectories: int
    device_name: str
    device: List[Interval]  # kernels, copies and memsets
    host: List[Interval]  # host ops and spans
    launches: List[dict]  # one per chunk launch: B, n, m, iters, nnz
    host_clock: dict = field(default_factory=dict)  # the window's own timings

    def span_seconds(self, *names: str) -> float:
        return sum(e - s for name, s, e in self.host if name in names) / 1e6

    def busy_seconds(self) -> float:
        return sum(e - s for s, e in union(self.device)) / 1e6


@dataclass
class Tracer:
    enabled: bool
    skip: int = 0
    units: int = 1
    device: Optional[torch.device] = None
    done_units: int = 0
    traced_units: int = 0
    trajectories: int = 0
    active: bool = False
    data: Optional[TraceData] = None
    _prof: object = None
    _t0: float = 0.0
    _launches: list = field(default_factory=list)
    _peak_outside: int = 0  # the program's peak before the window opened

    def peak_bytes(self) -> int:
        """The device memory peak of the run, the traced window left out."""
        return max(self._peak_outside, torch.cuda.max_memory_allocated(self.device))

    def before_unit(self) -> None:
        if self.enabled and self._prof is None and self.done_units == self.skip:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
                self._peak_outside = torch.cuda.max_memory_allocated(self.device)
                # the launches' A stay referenced until the window closes: grow
                # the allocator's cache first, so that the program's own
                # allocations in the window find cached blocks, not cudaMalloc
                free, _ = torch.cuda.mem_get_info(self.device)
                block = torch.empty(int(min(RESERVE_BYTES, free // 2)), dtype=torch.uint8,
                                    device=self.device)
                del block
                torch.cuda.synchronize(self.device)
            self._prof = profile(activities=acts)
            self._prof.start()
            self._t0 = time.perf_counter()
            self.active = True

    def after_unit(self, trajectories: int = 0) -> None:
        self.done_units += 1
        if self.active:
            self.traced_units += 1
            self.trajectories += trajectories
            if self.traced_units >= self.units:
                self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window = time.perf_counter() - self._t0
        self._prof.stop()
        self.active = False
        dev_ops, host = [], []
        for evt in self._prof.events():
            iv = (evt.name, float(evt.time_range.start), float(evt.time_range.end))
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                if not evt.name.startswith(SPAN_PREFIXES):
                    dev_ops.append(iv)
            elif evt.device_type == torch.autograd.DeviceType.CPU:
                host.append(iv)
        launches = self.launch_records()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        self.data = TraceData(window_s=window, units=self.traced_units,
                              trajectories=self.trajectories, device_name=name,
                              device=dev_ops, host=host, launches=launches)
        self._prof = None

    def launch_records(self) -> List[dict]:
        """The recorded launches with A's nonzeros counted; clears them."""
        counted: dict = {}  # a solve's chunks share one A
        out = [dict(rec, nnz=counted.setdefault(id(A), int(torch.count_nonzero(A))))
               for rec, A in self._launches]
        self._launches.clear()
        return out

    def hook_chunk(self) -> None:
        """Record every chunk launch made while the window is open."""
        from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

        inner = K.admm_chunk

        def recorded(Minv, A, q, l, u, rho, x, z, y, iters, *args, **kw):
            if self.active:
                B, m, n = A.shape
                self._launches.append(({"B": B, "n": n, "m": m, "iters": int(iters)}, A))
            return inner(Minv, A, q, l, u, rho, x, z, y, iters, *args, **kw)

        K.admm_chunk = recorded


def union(intervals: List[Interval]) -> List[Tuple[float, float]]:
    """The union of the intervals, as sorted disjoint (start, end) pairs."""
    out: List[Tuple[float, float]] = []
    for _, s, e in sorted(intervals, key=lambda iv: iv[1]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def top_device_ops(data: TraceData, k: int = 10) -> list:
    """[[name, seconds], ...]: the device ops that took most time, by name."""
    tot: dict = {}
    for name, s, e in data.device:
        key = name[:120]
        tot[key] = tot.get(key, 0.0) + (e - s) / 1e6
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(data: TraceData, k: int = 10, longest: int = 400) -> list:
    """[[what the host was doing, seconds], ...]: the device's idle gaps,
    the ``longest`` of them named by the innermost span (else host op) open
    at their middle, summed by that name."""
    busy = union(data.device)
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2) for a, b in zip(busy, busy[1:])
                   if b[0] > a[1]), reverse=True)[:longest]
    spans = sorted((iv for iv in data.host if iv[0].startswith(SPAN_PREFIXES)),
                   key=lambda iv: iv[1])
    ops = sorted((iv for iv in data.host if not iv[0].startswith(SPAN_PREFIXES)),
                 key=lambda iv: iv[1])

    def innermost(evts, starts, t):
        best = None
        i = bisect.bisect_right(starts, t)
        for name, s, e in reversed(evts[max(0, i - 256):i]):
            if e >= t and (best is None or e - s < best[2] - best[1]):
                best = (name, s, e)
        return best

    span_starts = [iv[1] for iv in spans]
    op_starts = [iv[1] for iv in ops]
    tot: dict = {}
    for dur, mid in gaps:
        sp = innermost(spans, span_starts, mid)
        op = innermost(ops, op_starts, mid)
        label = (sp[0] if sp else "no span") + " / " + (op[0][:60] if op else "no op")
        tot[label] = tot.get(label, 0.0) + dur / 1e6
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]
