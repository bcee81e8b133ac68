"""CUDA graphs of the static frame's stages and of the per-frame rebuild.

A static frame on the card enqueues the same few hundred launches on the
same buffers every frame; only the values in the frame's block of
constants (``frame_block.py``) change, and every launch reads them
through their fixed addresses. So the frames of one capture key
(``capture_key``) run in three steps:

1. the first runs eagerly: it loads the kernels and warms the allocator;
2. the second runs its code once under capture: each stage span
   (``STAGES``) becomes one CUDA graph, all in one memory pool, in the
   order they ran (``spans.capturing``: the spans record nothing then);
   then it replays them, as every later frame does;
3. a replay runs each graph inside its own span, as the eager code runs,
   then copies every output out of the pool into a fresh tensor within
   the last stage, ``tpurt.composite``: a frame's outputs stay valid
   after the next frame.

A stage may enqueue nothing (where the resolve kernel writes the shadows
and the image inside ``tpurt.gbuffer``, ``tpurt.shadow`` and
``tpurt.composite`` launch nothing): its graph is empty, and its replay
launches nothing inside its span. Which frames take the graphs is a
function of what the frame observes (``takes_graph``). The launch
counters of the walk, build and resolve kernels (``.launches``) count a
replay's launches as the eager frame does, and a traced replay whose
graphs hold the resolve kernel records it (``spans.resolve_frame``).

The per-frame rebuild (``mode="rebuild"``) takes the same three steps as
one graph per capture key (``rebuild_key``, ``RebuildGraph``): everything
from the pose buffers to the wide-node count, captured whole, its inner
spans recording nothing. Its outputs (the tree, the accel, its table and
the count) stay in the graph's pool, and each replay writes them in
place, so the frame that follows reads them on the same stream.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .spans import capturing, resolve_frame, span

STAGES = ("tpurt.order", "tpurt.rays", "tpurt.walk", "tpurt.gbuffer",
          "tpurt.shadow", "tpurt.composite")


def takes_graph(mode: str, gbuffer: str, device) -> bool:
    """Does a frame replay its stages as CUDA graphs? The static mode's
    ray-cast G-buffer on the card, on any route: every route takes each
    per-frame value from the block. The rebuild's accel is new every
    frame and its count read is a host read; the raster G-buffer may
    render a frame again with a bigger binning capacity; the CPU has no
    graphs: those frames run eagerly."""
    return (mode == "static" and gbuffer == "ray"
            and torch.device(device).type == "cuda")


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
    from .kernels.resolve import frame_resolve_cuda
    from .kernels.traverse import CUDA_KERNELS
    return {fn: fn.launches
            for fn in (*CUDA_KERNELS, *BUILD_KERNELS, frame_resolve_cuda)}


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


class _Capture:
    """One frame's stages under capture: each outermost stage span is
    captured into a graph of its own in ``pool``."""

    def __init__(self, pool):
        self.pool = pool
        self.stages: List[Tuple[str, "torch.cuda.CUDAGraph"]] = []
        self._open = False

    def stage(self, name: str):
        if self._open or name not in STAGES:
            return contextlib.nullcontext()
        return self._graph(name)

    @contextlib.contextmanager
    def _graph(self, name: str):
        graph = torch.cuda.CUDAGraph()
        self._open = True
        try:
            with warnings.catch_warnings():
                # A stage that enqueues nothing captures an empty graph.
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                with torch.cuda.graph(graph, pool=self.pool):
                    yield None
        finally:
            self._open = False
        self.stages.append((name, graph))


class FrameGraphs:
    """The graphs of one capture key. ``objects``: what the key holds by
    identity, kept alive with the graphs that read it."""

    def __init__(self, key: tuple, objects: tuple):
        self.key = key
        self._objects = objects
        self.warm = False
        self.stages: List[Tuple[str, "torch.cuda.CUDAGraph"]] = []
        self.out: Dict[str, torch.Tensor] = {}
        self._launches: Dict[Callable, int] = {}
        self._resolves = False

    @property
    def captured(self) -> bool:
        return bool(self.stages)

    def capture(self, frame: Callable[[], Dict[str, torch.Tensor]]) -> None:
        """Capture ``frame()``'s stages; its outputs stay in the pool."""
        from .kernels.resolve import frame_resolve_cuda
        before = _launch_counts()
        cap = _Capture(torch.cuda.graph_pool_handle())
        with capturing(cap):
            out = frame()
        self._launches = _take_captured(before)
        self._resolves = frame_resolve_cuda in self._launches
        if not cap.stages or cap.stages[-1][0] != "tpurt.composite":
            raise RuntimeError("a captured frame must end in its "
                               "tpurt.composite stage")
        self.stages, self.out = cap.stages, out

    def replay(self) -> Dict[str, torch.Tensor]:
        """Replay every stage in its span -> fresh copies of the
        outputs."""
        _count_replay(self._launches)
        if self._resolves:
            resolve_frame()
        *head, (last, graph) = self.stages
        for name, g in head:
            with span(name):
                g.replay()
        with span(last):
            graph.replay()
            return {k: v.clone() for k, v in self.out.items()}


class _Whole:
    """A capture into one graph: no stage span opens a graph of its own,
    and none records."""

    @staticmethod
    def stage(name: str):
        return contextlib.nullcontext()


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
