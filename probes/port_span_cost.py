"""What the frame's stage spans cost while a profiler records.

    python3 probes/port_span_cost.py <cell> [<cell> ...] --seed <n>

For each cell of BENCHMARK.json: the harness's scene, Renderer and
warm-up, then windows of the cell's traced frame count under
torch.profiler (CPU and CUDA), in turns with the spans on (as
``Renderer.render_frame`` traces itself) and off (the frame's tracing
check answered "off"): on, off, off, on, repeated. Prints one JSON line
a cell with each window's host ms a frame. Needs a card.
"""

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_torch import harness  # noqa: E402


def window(c, n: int) -> float:
    """Host ms a frame of n frames under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            with record_function("bench.frame"):
                c.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("cells", nargs="+")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rounds", type=int, default=3)
    a = p.parse_args()
    torch.set_num_threads(1)
    for name in a.cells:
        cell = harness.find_cell(name)
        harness.load_libraries(cell.config)
        c = harness.Cell(cell, a.seed, "cuda", {})
        for _ in range(cell.traffic["warmup_frames"]):
            c.step()
        n = cell.traffic["trace_frames"]
        spans = c.renderer.spans
        ms = {"on": [], "off": []}
        for _ in range(a.rounds):
            for side in ("on", "off", "off", "on"):
                if side == "off":
                    spans.frame = lambda index: contextlib.nullcontext()
                else:
                    spans.__dict__.pop("frame", None)
                ms[side].append(window(c, n))
        spans.__dict__.pop("frame", None)
        med = {k: statistics.median(v) for k, v in ms.items()}
        print(json.dumps(dict(cell=name, seed=a.seed, frames=n, ms=ms,
                              median=med,
                              cost_ms=med["on"] - med["off"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
