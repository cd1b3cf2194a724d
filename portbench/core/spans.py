"""The program's spans in a traced window: which span a host event ran
inside, and each span's self time.

On the host thread the spans nest (a ``with`` block inside another), so the
spans open at any instant form one chain, and the innermost of them is the
span that issued what happens then. A span's self time is its duration less
the part of it that its child spans cover.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .trace import SPAN_PREFIXES, Interval, TraceData

# CUDA runtime (and driver) calls that enqueue a device op: a kernel, a copy
# or a memset
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")
# calls that make the host wait for the device; a synchronous ``cudaMemcpy``
# waits too, its asynchronous form does not
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def program_spans(data: TraceData) -> List[Interval]:
    """The program's host spans, outer before inner where two start alike."""
    return sorted((iv for iv in data.host if iv[0].startswith(SPAN_PREFIXES)),
                  key=lambda iv: (iv[1], -iv[2]))


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCH_CALLS)


def sync_calls(data: TraceData) -> List[Interval]:
    """The window's host-to-device waits, in order, without those that close
    it: the tracer's ``torch.cuda.synchronize`` and the profiler's own on
    stopping, the ``cudaDeviceSynchronize`` calls after its last launch."""
    last = max((s for name, s, _ in data.host if is_launch(name)), default=float("-inf"))
    return sorted((iv for iv in data.host if iv[0] in SYNC_CALLS
                   and not (iv[0] == "cudaDeviceSynchronize" and iv[1] > last)),
                  key=lambda iv: iv[1])


def by_innermost(data: TraceData, events: List[Interval],
                 spans: Optional[List[Interval]] = None) -> Dict[Optional[str], int]:
    """How many of ``events`` start inside each span, by the innermost span
    open at their start (None: outside every span). ``spans`` (nested,
    sorted as :func:`program_spans` sorts) defaults to the program's."""
    spans = program_spans(data) if spans is None else spans
    out: Dict[Optional[str], int] = {}
    stack: List[Interval] = []
    i = 0
    for _, t, _ in sorted(events, key=lambda iv: iv[1]):
        while i < len(spans) and spans[i][1] <= t:
            while stack and stack[-1][2] < spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        key = stack[-1][0] if stack else None
        out[key] = out.get(key, 0) + 1
    return out


def self_seconds(data: TraceData, keep: Callable[[str], bool]) -> Dict[str, float]:
    """Self seconds by span name, for the spans whose name ``keep`` takes."""
    spans = program_spans(data)
    child = [0.0] * len(spans)
    stack: List[int] = []
    for j, (_, s, e) in enumerate(spans):
        while stack and spans[stack[-1]][2] < e:
            stack.pop()
        if stack:
            child[stack[-1]] += e - s
        stack.append(j)
    out: Dict[str, float] = {}
    for (name, s, e), c in zip(spans, child):
        if keep(name):
            out[name] = out.get(name, 0.0) + (e - s - c) / 1e6
    return out
