"""The benchmark's eight readers of the program's spans and host-sync
count (``bench_torch/metrics/<name>/read.py``), through a traced run of
the harness on the CPU at its tests' tiny size: each reads a finite
number, and the host syncs a frame are the frame's reads (the walk flags,
and in the animated rebuild the wide-node count). The reader of the
share of frames that replayed CUDA graphs reads 0 on the CPU, and its
cases on a stand-in record."""

import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
from test_torch_native import ensure_native_libraries  # noqa: E402

from bench_torch import harness  # noqa: E402

ensure_native_libraries()

TINY = dict(tris_target=3000, width=64, height=36, check_pixels=384,
            warmup_frames=1, trace_frames=2)
SEED = 2 ** 31 + 12345
METRICS = ("order_ms", "rays_ms", "walk_ms", "gbuffer_ms", "shadow_ms",
           "composite_ms", "host_wait_ms", "host_syncs_per_frame")


@pytest.mark.parametrize("workload,syncs", [
    ("hall_static.sun_1080p", 1), ("hall_rebuild.sun_1080p_animated", 2)])
def test_traced_run_reads_the_spans(workload, syncs):
    res = harness.run(workload, SEED, 0.3, True, t_start=time.perf_counter(),
                      device="cpu", overrides=TINY)
    assert res["correct"] and res["failed"] == 0
    m = res["metrics"]
    for name in METRICS:
        assert math.isfinite(m[name]["value"]), name
        assert m[name]["value"] >= 0, name
    assert m["walk_ms"]["value"] > 0 and m["gbuffer_ms"]["value"] > 0
    assert m["host_syncs_per_frame"] == {"value": syncs, "unit": "syncs"}
    # The CPU's frames run eagerly: no stage replays a CUDA graph.
    assert m["graph_frame_share"] == {"value": 0.0, "unit": "%"}


@pytest.mark.parametrize("graph_frames,frames,share", [
    (3, 3, 100.0), (1, 4, 25.0), (0, 2, 0.0), (0, 0, None), (None, 3, None)])
def test_graph_frame_share_reader(graph_frames, frames, share):
    """The share of traced frames that replayed their stages; None where
    no frame was traced, or where the program keeps no such record (a
    tree before the graphs)."""
    spans = SimpleNamespace(frames=frames)
    if graph_frames is not None:
        spans.graph_frames = graph_frames
    ctx = SimpleNamespace(cell=SimpleNamespace(
        renderer=SimpleNamespace(spans=spans)))
    assert harness._load_reader(str(ROOT / "bench_torch"),
                                "graph_frame_share")(ctx) == share
