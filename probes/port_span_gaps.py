"""Where a benchmark cell's traced frames go, by the program's stage spans.

    python3 probes/port_span_gaps.py <cell> [<cell> ...] --seed <n>

For each cell of BENCHMARK.json: the harness's scene, Renderer and
warm-up, then the cell's traced frames under torch.profiler (CPU and
CUDA), as ``bench_torch/run.py --trace 1`` runs them. Prints one JSON
line a cell: the traced window's host ms a frame, the device's busy ms a
frame, ``Renderer.spans`` a frame (device-timeline, self and host ms and
entries per span), the host syncs a frame, and the longest idle gaps of
the device, each named by the innermost ``tpurt.*`` span and the
innermost host operation around the launch that ended it. Needs a card.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_torch import harness  # noqa: E402
from bench_torch.profile import (DEVICE_CATS, HOST_CATS, LAUNCH_CATS,  # noqa: E402,E501
                                 _spans)

GAPS = 5


def _innermost(spans, ts):
    best = None
    for e in spans:
        if e["ts"] <= ts <= e["ts"] + e["dur"]:
            if best is None or e["dur"] < best["dur"]:
                best = e
    return best["name"] if best else None


def traced(cell, seed: int) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function
    c = harness.Cell(cell, seed, "cuda", {})
    for _ in range(cell.traffic["warmup_frames"]):
        c.step()
    torch.cuda.synchronize()
    n = cell.traffic["trace_frames"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            with record_function("bench.frame"):
                c.step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    dev_ops = sorted(_spans(events, DEVICE_CATS), key=lambda e: e["ts"])
    host = _spans(events, HOST_CATS)
    stages = [e for e in host if e["name"].startswith("tpurt.")]
    launch_ts = {e["args"]["correlation"]: e["ts"]
                 for e in _spans(events, LAUNCH_CATS)
                 if "correlation" in e.get("args", {})}
    busy, end, gaps = 0.0, None, []
    for e in dev_ops:
        s, t = e["ts"], e["ts"] + e["dur"]
        if end is None or s > end:
            if end is not None:
                gaps.append((s - end, e))
            busy += e["dur"]
            end = t
        elif t > end:
            busy += t - end
            end = t
    gaps.sort(key=lambda g: -g[0])
    named = []
    for length, e in gaps[:GAPS]:
        ts = launch_ts.get(e.get("args", {}).get("correlation"), e["ts"])
        named.append(dict(ms=length / 1e3, stage=_innermost(stages, ts),
                          op=_innermost(host, ts)))
    sp = c.renderer.spans
    return dict(cell=cell.name, seed=seed, frames=n,
                window_ms_a_frame=window_s * 1e3 / n,
                busy_ms_a_frame=busy / 1e3 / n,
                spans={k: {kk: vv / sp.frames for kk, vv in v.items()}
                       for k, v in sp.totals.items()},
                host_syncs_per_frame=sp.syncs / sp.frames,
                idle_gaps=named)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("cells", nargs="+")
    p.add_argument("--seed", type=int, required=True)
    a = p.parse_args()
    torch.set_num_threads(1)
    for name in a.cells:
        cell = harness.find_cell(name)
        harness.load_libraries(cell.config)
        print(json.dumps(traced(cell, a.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
