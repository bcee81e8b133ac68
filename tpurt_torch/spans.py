"""Stage spans and the host-read count inside ``Renderer.render_frame``.

Tracing is on exactly while a torch profiler records: a frame asks
``torch.autograd._profiler_enabled()`` once, at its start
(``Spans.frame``). Off, ``span`` returns one shared null context and
``host_read`` is a plain copy to the host: no ``record_function``, no
event, no clock read.

On, a span (``span("tpurt.<stage>")``)

- opens ``torch.profiler.record_function`` under its name, so that it sits
  on the profiler's timeline with the device operations, on one clock;
- times the device's timeline from its start to its end with a
  ``Stopwatch``: two CUDA events on the current stream, taken from the
  Renderer's pool (the host clock on the CPU, where the work has finished
  when a call returns);
- reads the host clock at its start and its end.

A span knows its parent and the frame it belongs to. A frame's spans are
folded into its Renderer's ``Spans`` once their events have completed,
which needs no sync of its own: at the end of the next traced frame,
whose host read followed them on the stream, or when the totals are
read.

The frame's host syncs go through two helpers, which count each into the
traced frame's record: ``host_read``, every read of a device value, and
``to_device``, every copy of host data onto the card (torch copies
pageable memory synchronously, so the host waits for the stream there
too). A traced frame also records whether its stages replayed CUDA graphs
(``graph_frame``), whether its rebuild replayed its CUDA graph
(``rebuild_graph_frame``) and whether the resolve kernel wrote its
outputs (``resolve_frame``), and the device counters a stage hands it
(``count``): they stay on the device until the frame's next host read
carries them (``host_read``), so counting adds no sync.

While a frame's stages are captured into CUDA graphs (``capturing``,
``graphs.py``), ``span`` hands each stage to the capture and ``count``
each counter, and tracing is off, so no event is recorded into a graph.
"""

from __future__ import annotations

import contextlib
import time
from contextvars import ContextVar
from typing import Dict, List, Optional

import numpy as np
import torch

# The traced frame whose spans ``span`` records, None with tracing off.
_FRAME: ContextVar[Optional["_Frame"]] = ContextVar("tpurt_frame",
                                                    default=None)
# The capture of a frame's stages into CUDA graphs, while it runs.
_CAPTURE: ContextVar[Optional[object]] = ContextVar("tpurt_capture",
                                                    default=None)
_NULL = contextlib.nullcontext()
# The per-span sums ``Spans.totals`` reports, in this order.
_KEYS = ("device_ms", "self_ms", "host_ms", "entries")


class Stopwatch:
    """Milliseconds of the work between entering and leaving it: CUDA
    events on the card (read later, without a sync of its own), the host
    clock on the CPU, where the work has finished when it returns.
    ``pool``: a list of CUDA events to take its two from, else new ones."""

    def __init__(self, device: torch.device, pool: Optional[list] = None):
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._start = _event(pool)
            self._end = _event(pool)

    def __enter__(self) -> "Stopwatch":
        if self._cuda:
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._cuda:
            self._end.record()
        else:
            self._t1 = time.perf_counter()

    def done(self) -> bool:
        """Whether the device has passed the end (no wait)."""
        return not self._cuda or self._end.query()

    def ms(self) -> float:
        """Waits for the end first."""
        if self._cuda:
            self._end.synchronize()
        return self.elapsed()

    def elapsed(self) -> float:
        """Once ``done()``."""
        if self._cuda:
            return self._start.elapsed_time(self._end)
        return (self._t1 - self._t0) * 1e3

    def events(self) -> list:
        return [self._start, self._end] if self._cuda else []


def _event(pool: Optional[list]) -> "torch.cuda.Event":
    return pool.pop() if pool else torch.cuda.Event(enable_timing=True)


class _Span:
    """One entry of a stage in a traced frame."""

    __slots__ = ("frame", "name", "parent", "watch", "host_ms", "child_dev",
                 "_t0", "_rf")

    def __init__(self, frame: "_Frame", name: str):
        self.frame = frame
        self.name = name
        self.child_dev = 0.0

    def __enter__(self) -> Stopwatch:
        f = self.frame
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.parent = f.open[-1] if f.open else None
        f.open.append(self)
        self._t0 = time.perf_counter()
        self.watch = Stopwatch(f.owner.device, f.owner.pool)
        return self.watch.__enter__()

    def __exit__(self, *exc) -> None:
        self.watch.__exit__(*exc)
        self.host_ms = (time.perf_counter() - self._t0) * 1e3
        f = self.frame
        f.open.pop()
        f.done.append(self)
        self._rf.__exit__(*exc)


def span(name: str, device: Optional[torch.device] = None):
    """The stage ``name`` of the traced frame, a context that yields its
    Stopwatch; with tracing off the shared null context, or, where
    ``device`` is given, a bare Stopwatch on it, which its caller reads
    whether or not the frame is traced. While a capture runs
    (``capturing``) it is the capture's context for the stage instead."""
    capture = _CAPTURE.get()
    if capture is not None and device is None:
        return capture.stage(name)
    frame = _FRAME.get()
    if frame is None:
        return _NULL if device is None else Stopwatch(device)
    return _Span(frame, name)


def count(name: str, value) -> None:
    """Add the device integer ``value`` (one element) to the traced
    frame's counter ``name``; with tracing off nothing happens. ``value``
    may be a function that makes it, called only in a traced frame, so an
    untraced one launches nothing for the count. The value stays on the
    device until the frame's next host read carries it. While a capture
    runs, the capture takes the counter (``capture.count``), so that a
    traced replay counts it."""
    capture = _CAPTURE.get()
    if capture is not None:
        capture.count(name, value)
        return
    frame = _FRAME.get()
    if frame is not None:
        frame.pending_counts.append(
            (name, value() if callable(value) else value))


def drop_counts() -> None:
    """Forget what the traced frame has counted so far, read or not: a
    frame that is rendered again counts its last attempt alone."""
    frame = _FRAME.get()
    if frame is not None:
        frame.counts.clear()
        frame.pending_counts.clear()


def host_read(t: torch.Tensor) -> torch.Tensor:
    """The integer tensor ``t`` copied to the host: the frame's one way to
    read a device value, counted as a host sync on every device. The
    traced frame's pending device counters (``count``) ride in the same
    copy and are summed into its record."""
    frame = _FRAME.get()
    if frame is None:
        return t.cpu()
    frame.syncs += 1
    pending = frame.pending_counts
    if not pending:
        return t.cpu()
    out = torch.cat([t.reshape(-1), *(v.reshape(1).to(t.dtype)
                                      for _, v in pending)]).cpu()
    n = t.numel()
    for (name, _), v in zip(pending, out[n:].tolist()):
        frame.counts[name] = frame.counts.get(name, 0) + v
    pending.clear()
    return out[:n].reshape(t.shape)


def to_device(x, device) -> torch.Tensor:
    """Host data ``x`` (an array, a sequence or a number) as a float32
    tensor on ``device``; onto a card a host sync, counted."""
    out = torch.as_tensor(np.asarray(x, np.float32), device=device)
    frame = _FRAME.get()
    if frame is not None and out.device.type != "cpu":
        frame.syncs += 1
    return out


@contextlib.contextmanager
def capturing(capture):
    """Run the block with ``capture`` taking the stage spans
    (``capture.stage(name)`` -> a context) and the counters
    (``capture.count(name, value)``), and tracing off."""
    t_capture = _CAPTURE.set(capture)
    t_frame = _FRAME.set(None)
    try:
        yield
    finally:
        _FRAME.reset(t_frame)
        _CAPTURE.reset(t_capture)


def graph_frame() -> None:
    """Record in the traced frame, if any, that its stages replayed CUDA
    graphs."""
    frame = _FRAME.get()
    if frame is not None:
        frame.graph = True


def rebuild_graph_frame() -> None:
    """Record in the traced frame, if any, that its rebuild replayed its
    CUDA graph."""
    frame = _FRAME.get()
    if frame is not None:
        frame.rebuild_graph = True


def resolve_frame() -> None:
    """Record in the traced frame, if any, that the resolve kernel
    (``kernels/resolve.py``) wrote its outputs."""
    frame = _FRAME.get()
    if frame is not None:
        frame.resolve = True


class _Frame:
    """A traced frame's record while it renders: its spans, innermost
    open last, and its host syncs. As a context it makes itself the frame
    ``span`` records into and opens ``tpurt.frame``."""

    def __init__(self, owner: "Spans", index: int):
        self.owner = owner
        self.index = index
        self.open: List[_Span] = []
        self.done: List[_Span] = []
        self.syncs = 0
        self.graph = False
        self.rebuild_graph = False
        self.resolve = False
        self.pending_counts: list = []   # (name, device value) not yet read
        self.counts: Dict[str, int] = {}

    def __enter__(self) -> "_Frame":
        self._token = _FRAME.set(self)
        self._whole = _Span(self, "tpurt.frame")
        self._whole.__enter__()
        return self

    def __exit__(self, exc_type, *exc) -> None:
        whole, self._whole = self._whole, None
        whole.__exit__(exc_type, *exc)
        _FRAME.reset(self._token)
        self.owner.fold_ready()     # the earlier frames, outside any span
        if exc_type is None:        # a frame that raised is not counted
            self.owner.pending.append(self)


class Spans:
    """A Renderer's traced frames (``Renderer.spans``): how many, their
    host syncs, how many replayed their stages as CUDA graphs, how many
    replayed their rebuild as one, how many the resolve kernel wrote, the
    sums of their counters (``count``), and per span name the sums over
    them of its device ms (the device's timeline from start to end, idle
    included), self ms (that less the part its child spans cover), host
    ms and entries."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool: list = []        # CUDA events to reuse
        self.pending: List[_Frame] = []
        self._frames = 0
        self._syncs = 0
        self._graph_frames = 0
        self._rebuild_graph_frames = 0
        self._resolve_frames = 0
        self._counts: Dict[str, int] = {}
        self._totals: Dict[str, List[float]] = {}

    def frame(self, index: int):
        """The context of frame ``index``: traced while a torch profiler
        records, else the null context."""
        if not torch.autograd._profiler_enabled():
            return _NULL
        return _Frame(self, index)

    def fold_ready(self) -> None:
        """Fold the pending frames whose last event has completed."""
        while self.pending and self.pending[0].done[-1].watch.done():
            self._fold(self.pending.pop(0))

    def _settle(self) -> None:
        if self.pending:
            self.pending[-1].done[-1].watch.ms()     # waits for the last
            self.fold_ready()

    def _fold(self, frame: _Frame) -> None:
        for s in frame.done:        # children close before their parent
            dev = s.watch.elapsed()
            t = self._totals.setdefault(s.name, [0.0] * len(_KEYS))
            t[0] += dev
            t[1] += dev - s.child_dev
            t[2] += s.host_ms
            t[3] += 1
            if s.parent is not None:
                s.parent.child_dev += dev
            self.pool += s.watch.events()
        self._frames += 1
        self._syncs += frame.syncs
        self._graph_frames += frame.graph
        self._rebuild_graph_frames += frame.rebuild_graph
        self._resolve_frames += frame.resolve
        for name, v in frame.counts.items():
            self._counts[name] = self._counts.get(name, 0) + v
        frame.done.clear()          # no cycle left for the collector

    @property
    def frames(self) -> int:
        self._settle()
        return self._frames

    @property
    def syncs(self) -> int:
        self._settle()
        return self._syncs

    @property
    def graph_frames(self) -> int:
        self._settle()
        return self._graph_frames

    @property
    def rebuild_graph_frames(self) -> int:
        self._settle()
        return self._rebuild_graph_frames

    @property
    def resolve_frames(self) -> int:
        self._settle()
        return self._resolve_frames

    @property
    def counts(self) -> Dict[str, int]:
        """{counter name: its sum over the traced frames}."""
        self._settle()
        return dict(self._counts)

    @property
    def totals(self) -> Dict[str, Dict[str, float]]:
        """{span name: {device_ms, self_ms, host_ms, entries}}, summed over
        the traced frames."""
        self._settle()
        return {k: dict(zip(_KEYS, v)) for k, v in self._totals.items()}

    def per_frame(self, name: str, key: str = "self_ms") -> Optional[float]:
        """A span's ``key`` over the traced frames, or None where no traced
        frame recorded it."""
        t = self.totals.get(name)
        return None if t is None else t[key] / self._frames
