"""CUDA-graph segments recorded from one run of a function and replayed in
order.

A function of many microsecond-scale kernels spends its time in the host's
launch calls. :class:`SegmentedGraph` records one run of it as a short
sequence of CUDA graphs, all in one memory pool, and replays that sequence
on the current stream. The recording breaks

- where a program span (``utils.profiler.span``) opens or closes, so that a
  replay launches each segment inside the spans it was recorded in and a
  trace still shows the stages; a segment that captured no work is dropped;
- at every :func:`eager_call`: that call stays a call of its own on every
  replay, between the segment before it and the one after it, writing into
  output buffers made at the recording (the ADMM chunk kernel's wrapper,
  whose counters then count every launch).

A launch counter that the recorded work bumps through :func:`tally` is
bumped at every replay, where the recorded kernel runs, and not at the
recording.

A replay reads its inputs where the recording read them and writes its
results where the recording wrote them: a caller copies its inputs into the
buffers the recorded function read before :meth:`SegmentedGraph.replay`, and
copies the results out after it. The recording itself runs no work on the
device: what the recorded function returns holds results only after a
replay. Recording runs the function once on the capture stream first, so
that the libraries' per-stream workspaces exist before the capture.
"""

from __future__ import annotations

import gc
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from . import profiler

_STREAMS: dict = {}  # device → the side stream every recording captures on
# torch's warning at the end of a capture that recorded no work
_EMPTY = "The CUDA Graph is empty"


def recording() -> Optional["SegmentedGraph"]:
    """The recording in progress on this thread, if any."""
    return getattr(profiler.RECORDING, "graph", None)


def eager_call(fn: Callable, like: Sequence[torch.Tensor]):
    """``fn(out)`` with ``out`` None outside a recording (``fn`` then makes
    its own outputs). Inside one: buffers shaped as ``like`` are made, the
    call ``fn(buffers)`` becomes a step of its own between two segments,
    and the buffers are returned; each replay makes the call again."""
    graph = recording()
    if graph is None:
        return fn(None)
    out = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in like)
    graph._eager(lambda: fn(out))
    return out


def tally(fn: Callable[[], None]) -> None:
    """A host-side count of work that a recording captures (a launch
    counter): made now outside a recording, and at every replay inside one,
    where the recorded work runs."""
    graph = recording()
    if graph is None:
        fn()
    else:
        graph._tallies.append(fn)


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    s = _STREAMS.get(device)
    if s is None:
        s = _STREAMS[device] = torch.cuda.Stream(device)
    return s


class _Cut:
    """A span while a recording runs: the segment ends where it opens and
    where it closes."""

    def __init__(self, graph: "SegmentedGraph", name: str):
        self.graph, self.name = graph, name

    def __enter__(self):
        self.graph._end()
        self.graph._open.append(self.name)
        self.graph._begin()

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.graph._end()
            self.graph._open.pop()
            self.graph._begin()
        else:
            self.graph._open.pop()
        return False


class SegmentedGraph:
    """One recording: ``steps`` in order, each the names of the spans open
    where it was recorded and either a CUDA graph or an eager call."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.steps: List[Tuple[Tuple[str, ...], object]] = []
        self._pool = torch.cuda.graph_pool_handle()
        self._open: List[str] = []
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._label: Tuple[str, ...] = ()
        self._empty: list = []  # segments that captured nothing, held with the pool
        self._calls: list = []
        self._tallies: list = []  # counts made at every replay (tally)

    def record(self, fn: Callable):
        """Record ``fn()`` (run once on the capture stream first) and return
        what it returned; its tensors hold results after each replay."""
        if recording() is not None:
            raise RuntimeError("a CUDA-graph recording is already running on this thread")
        current = torch.cuda.current_stream(self.device)
        stream = _side_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            fn()
        # a CUDA graph that the collector frees during a capture makes a call
        # the capture forbids: collect now, and not while recording
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        profiler.RECORDING.graph = self
        self._tallies.clear()
        try:
            with torch.cuda.stream(stream):  # a capture ends on the stream it began on
                try:
                    self._begin()
                    out = fn()
                    self._end()
                except BaseException:
                    self._abort()
                    raise
        finally:
            profiler.RECORDING.graph = None
            if collecting:
                gc.enable()
        current.wait_stream(stream)
        self._calls = [s.replay if isinstance(s, torch.cuda.CUDAGraph) else s
                       for _, s in self.steps]
        return out

    def replay(self) -> None:
        """Launch every step on the current stream, in order, each inside the
        spans it was recorded in while a profiler runs."""
        for count in self._tallies:
            count()
        if not profiler.profiling():
            for call in self._calls:
                call()
            return
        opened: list = []  # (name, its span) from the outermost
        try:
            for (names, _), call in zip(self.steps, self._calls):
                k = 0
                while k < min(len(opened), len(names)) and opened[k][0] == names[k]:
                    k += 1
                while len(opened) > k:
                    opened.pop()[1].__exit__(None, None, None)
                for name in names[k:]:
                    ctx = profiler.span(name)
                    ctx.__enter__()
                    opened.append((name, ctx))
                call()
        finally:
            while opened:
                opened.pop()[1].__exit__(None, None, None)

    # -- recording -----------------------------------------------------------

    def cut(self, name: str) -> _Cut:
        """The span ``name`` while this recording runs (``profiler.span``)."""
        return _Cut(self, name)

    def _begin(self) -> None:
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=self._pool, capture_error_mode="thread_local")
        self._graph, self._label = g, tuple(self._open)

    def _end(self) -> None:
        g, self._graph = self._graph, None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            g.capture_end()
        empty = False
        for w in caught:
            if _EMPTY in str(w.message):
                empty = True
            else:
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
        if empty:
            self._empty.append(g)
        else:
            self.steps.append((self._label, g))

    def _eager(self, call: Callable) -> None:
        self._end()
        self.steps.append((tuple(self._open), call))
        self._begin()

    def _abort(self) -> None:
        g, self._graph = self._graph, None
        if g is not None:
            try:
                g.capture_end()
            except Exception:
                pass  # the capture was invalidated: the error that did it is raised
