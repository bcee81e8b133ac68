"""CUDA graphs of the static frame's stages and of the per-frame rebuild.

A static frame on the card enqueues the same few hundred launches on the
same buffers every frame; only the values in the frame's block of
constants (``frame_block.py``) change, and every launch reads them
through their fixed addresses (the raster binning too: its camera
constants are words of the block). So the frames of one capture key
(``capture_key``) run in three steps:

1. the first runs eagerly: it loads the kernels and warms the allocator;
2. the second runs its code once under capture (``spans.capturing``:
   the spans record nothing then), all in one memory pool: each stage
   span (``STAGES``) becomes one CUDA graph, in the order they ran; a
   stage opened inside another ends the outer one's graph, becomes a
   graph of its own, and the rest of the outer stage a new one, so that
   each graph lies inside exactly the spans it ran in; then it replays
   them, as every later frame does;
3. a replay opens the spans as the eager frame nests them and runs each
   graph inside its innermost one, then copies every output out of the
   pool into a fresh tensor within the last stage, ``tpurt.composite``: a
   frame's outputs stay valid after the next frame.

A whole stage may enqueue nothing (where the resolve kernel writes the
shadows and the image inside ``tpurt.gbuffer``, ``tpurt.shadow`` and
``tpurt.composite`` launch nothing): its graph is empty, and its replay
launches nothing inside its span. A part of a stage that a nested stage
split off and that enqueued nothing is dropped. Which frames take the
graphs is a function of what the frame observes (``takes_graph``). The
launch counters of the walk, build, raster and resolve kernels
(``.launches``) count a replay's launches as the eager frame does, and a
traced replay whose graphs hold the resolve kernel records it
(``spans.resolve_frame``). A counter a stage hands the frame
(``spans.count``) is kept by the capture: a device value as it is, to be
rewritten by every replay; a function that makes it, as a graph of its
own that only a traced replay runs, so an untraced one launches nothing
for it. A traced replay hands each to the frame's host read, as the
eager frame does.

The per-frame rebuild (``mode="rebuild"``) takes the same three steps as
one graph per capture key (``rebuild_key``, ``RebuildGraph``): everything
from the pose buffers to the wide-node count, captured whole, its inner
spans recording nothing. Its outputs (the tree, the accel, its table and
the count) stay in the graph's pool, and each replay writes them in
place, so the frame that follows reads them on the same stream.
"""

from __future__ import annotations

import contextlib
import functools
import warnings
from typing import Any, Callable, Dict, List, Optional

import torch

from .spans import capturing, count, resolve_frame, span

STAGES = ("tpurt.order", "tpurt.rays", "tpurt.walk", "tpurt.gbuffer",
          "tpurt.gbuffer.bin", "tpurt.gbuffer.raster", "tpurt.shadow",
          "tpurt.composite")
# What PyTorch warns where a capture enqueued nothing.
_EMPTY = "The CUDA Graph is empty"


def takes_graph(mode: str, device) -> bool:
    """Does a frame replay its stages as CUDA graphs? The static mode on
    the card, on any route and either G-buffer: every route takes each
    per-frame value from the block, and a raster frame that outgrew its
    binning's capacity is rendered again under a new config, so a new
    key. The rebuild's accel is new every frame and its count read is a
    host read; the CPU has no graphs: those frames run eagerly."""
    return mode == "static" and torch.device(device).type == "cuda"


def rebuild_takes_graph(mode: str, device) -> bool:
    """Does the per-frame rebuild replay as a CUDA graph? Rebuild mode on
    the card, on every rebuild route: each is a chain of fixed shapes
    (the triangle count, the leaf size, the sub-leaf splits and the pad)
    that reads no device value on the host. The CPU has no graphs."""
    return mode == "rebuild" and torch.device(device).type == "cuda"


def capture_key(route: str, config, lights, device, *objects) -> tuple:
    """What a frame's graphs bake in: the route, the config, the lights'
    count and kinds and the device by value, and ``objects`` (the accel,
    its tables, the mesh) by identity. A new camera or new light values
    leave it as it is."""
    return (route, config, tuple(light.kind for light in lights),
            torch.device(device), tuple(id(o) for o in objects))


def rebuild_key(nw_pad: int, route: tuple, device, *objects) -> tuple:
    """What a rebuild's graph bakes in: the pad, the rebuild's route (the
    accel's width, the collapse, the tables, ``top_sah``, the sub-leaf
    splits, the leaf size, whether the normals follow the pose) and the
    device by value, and ``objects`` (the mesh and its pose buffers) by
    identity."""
    return (nw_pad, route, torch.device(device),
            tuple(id(o) for o in objects))


def _launch_counts() -> Dict[Callable, int]:
    """Every hand-written kernel's launch counter, as it stands."""
    from .kernels.build import BUILD_KERNELS
    from .kernels.raster import RASTER_KERNELS
    from .kernels.resolve import frame_resolve_cuda
    from .kernels.traverse import CUDA_KERNELS
    return {fn: fn.launches
            for fn in (*CUDA_KERNELS, *BUILD_KERNELS, *RASTER_KERNELS,
                       frame_resolve_cuda)}


def _take_captured(before: Dict[Callable, int]) -> Dict[Callable, int]:
    """The launches a capture counted since ``before``, taken off the
    counters: the capture launched nothing, and its replays count them."""
    moved = {fn: fn.launches - n for fn, n in before.items()
             if fn.launches != n}
    for fn, n in moved.items():
        fn.launches -= n
    return moved


def _count_replay(launches: Dict[Callable, int]) -> None:
    for fn, n in launches.items():
        fn.launches += n


def _replayed(graph, value: torch.Tensor) -> torch.Tensor:
    graph.replay()
    return value


class _Capture:
    """One frame's stages under capture, as the steps of their replay
    (``steps``): ``("open", name)`` and ``("close", name)`` of each stage
    span, ``("graph", graph)`` of each whole stage and of each part of
    one, between them, that enqueued work, and ``("count", name, graph
    or None, value)`` of each counter. Every graph goes into ``pool``."""

    def __init__(self, pool):
        self.pool = pool
        self.steps: List[tuple] = []
        self._open: List[str] = []       # the stages open, innermost last
        self._part = None                # the graph being captured
        self._whole = False              # it began where its stage opened

    def stage(self, name: str):
        if name not in STAGES:
            return contextlib.nullcontext()
        return self._stage(name)

    @contextlib.contextmanager
    def _stage(self, name: str):
        self._end_part()
        self.steps.append(("open", name))
        self._open.append(name)
        self._begin_part(whole=True)
        try:
            yield None
        finally:
            self._end_part(keep_empty=self._whole)
            self._open.pop()
        self.steps.append(("close", name))
        self._begin_part()

    def count(self, name: str, value) -> None:
        """Keep the counter ``name``: a device value as it is (its stage's
        graph rewrites it), a function that makes it as a graph of its
        own between the parts of its stage."""
        if not callable(value):
            self.steps.append(("count", name, None, value))
            return
        self._end_part()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            value = value()
        self.steps.append(("count", name, graph, value))
        self._begin_part()

    def _begin_part(self, whole: bool = False) -> None:
        """Start capturing the rest of the innermost open stage, if any."""
        if not self._open:
            return
        graph = torch.cuda.CUDAGraph()
        ctx = torch.cuda.graph(graph, pool=self.pool)
        ctx.__enter__()
        self._part, self._whole = (graph, ctx), whole

    def _end_part(self, keep_empty: bool = False) -> None:
        """End the graph being captured, if any; keep it where it enqueued
        work or ``keep_empty`` says so."""
        if self._part is None:
            return
        (graph, ctx), self._part = self._part, None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ctx.__exit__(None, None, None)
        empty = False
        for w in caught:
            if str(w.message).startswith(_EMPTY):
                empty = True
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        if keep_empty or not empty:
            self.steps.append(("graph", graph))


class FrameGraphs:
    """The graphs of one capture key. ``objects``: what the key holds by
    identity, kept alive with the graphs that read it."""

    def __init__(self, key: tuple, objects: tuple):
        self.key = key
        self._objects = objects
        self.warm = False
        self.steps: List[tuple] = []
        self.out: Dict[str, torch.Tensor] = {}
        self._launches: Dict[Callable, int] = {}
        self._resolves = False

    @property
    def captured(self) -> bool:
        return bool(self.steps)

    def capture(self, frame: Callable[[], Dict[str, torch.Tensor]]) -> None:
        """Capture ``frame()``'s stages; its outputs stay in the pool."""
        from .kernels.resolve import frame_resolve_cuda
        before = _launch_counts()
        cap = _Capture(torch.cuda.graph_pool_handle())
        with capturing(cap):
            out = frame()
        self._launches = _take_captured(before)
        self._resolves = frame_resolve_cuda in self._launches
        if cap.steps[-1:] != [("close", "tpurt.composite")]:
            raise RuntimeError("a captured frame must end in its "
                               "tpurt.composite stage")
        self.steps, self.out = cap.steps, out

    def replay(self) -> Dict[str, torch.Tensor]:
        """Replay every graph in its spans -> fresh copies of the
        outputs, made in the last span."""
        _count_replay(self._launches)
        if self._resolves:
            resolve_frame()
        opened = []
        for step in self.steps[:-1]:
            kind = step[0]
            if kind == "open":
                opened.append(span(step[1]))
                opened[-1].__enter__()
            elif kind == "close":
                opened.pop().__exit__(None, None, None)
            elif kind == "graph":
                step[1].replay()
            else:
                _, name, graph, value = step
                count(name, value if graph is None
                      else functools.partial(_replayed, graph, value))
        out = {k: v.clone() for k, v in self.out.items()}
        opened.pop().__exit__(None, None, None)
        return out


class _Whole:
    """A capture into one graph: no stage span opens a graph of its own,
    and none records; no counter counts."""

    @staticmethod
    def stage(name: str):
        return contextlib.nullcontext()

    @staticmethod
    def count(name: str, value) -> None:
        pass


class RebuildGraph:
    """The per-frame rebuild of one capture key as one CUDA graph.
    ``objects``: what the key holds by identity, kept alive with the
    graph that reads it."""

    def __init__(self, key: tuple, objects: tuple):
        self.key = key
        self._objects = objects
        self.warm = False
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.out: Any = None
        self._launches: Dict[Callable, int] = {}

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def capture(self, rebuild: Callable[[], Any]) -> None:
        """Capture ``rebuild()`` into a graph of its own pool; its outputs
        stay in the pool."""
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        with capturing(_Whole()):
            with torch.cuda.graph(graph,
                                  pool=torch.cuda.graph_pool_handle()):
                out = rebuild()
        self._launches = _take_captured(before)
        self.graph, self.out = graph, out

    def replay(self) -> Any:
        """Replay the rebuild -> its outputs, written in place."""
        _count_replay(self._launches)
        self.graph.replay()
        return self.out
