"""Read the numbers that set a cell's correctness limits, on the card.

    python3 bench_torch/calibrate.py --workload <name> --seconds 2 \\
        --seeds 11 12 13 ... [--control 3]

In one process, for each seed: the cell as a run drives it (its scene,
Renderer, warm-up and a short window at the cell's own load), then its
numbers against the reference: the lower readings. For the first
``--control`` seeds the control, the reference computed in bfloat16, is
put in the program's place on the same frames and pixels: its numbers are
the upper readings, and the run's ``correct`` is then the control's, as
the run's own comparison decides it (it has to read false). One JSON line
per seed; the benchmark's runs never run this.
"""

import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv) -> int:
    import argparse

    import torch

    from bench_torch.harness import run
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for i, seed in enumerate(a.seeds):
        res = run(a.workload, seed, a.seconds, False,
                  t_start=time.perf_counter(), control=i < a.control)
        info = res["_info"]
        print(json.dumps({
            "workload": a.workload, "seed": seed,
            "judged": "control" if info["control"] else "program",
            "correct": res["correct"], "frames": res["attempted"],
            "failed": res["failed"], "program": info["program"],
            "control": info["control"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
