"""The first frames of one benchmark cell, a frame at a time: host ms, the
raster pair capacity and how often it grew, the pairs binned, and the
device's peak memory; then the traced live shadow rays against the valid
pixels. A first look at a cell before its runs.

    python3 probes/port_cell_frames.py --workload hall_raster.multi3_2160p \\
        --seed 1 --frames 6
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench_torch import harness
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--frames", type=int, default=6)
    a = p.parse_args()
    torch.set_num_threads(1)
    cell = harness.find_cell(a.workload)
    harness.load_libraries(cell.config)
    c = harness.Cell(cell, a.seed, "cuda", {})
    r = c.renderer
    print(f"setup {c.phases}, cap {r.config.raster_cap_pairs}", flush=True)
    for i in range(a.frames):
        t0 = time.perf_counter()
        out = c.step()
        torch.cuda.synchronize()
        print(f"frame {i}: {(time.perf_counter() - t0) * 1e3:.3f} ms, "
              f"cap {r.config.raster_cap_pairs}, growths "
              f"{r.stats['raster_cap_growths']}, valid "
              f"{int(out['valid'].sum())}, peak "
              f"{torch.cuda.max_memory_allocated()}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out = c.step()
        torch.cuda.synchronize()
    print(f"traced: counts {r.spans.counts}, syncs {r.spans.syncs}, valid "
          f"{int(out['valid'].sum())} x {len(c.lights)} lights", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
