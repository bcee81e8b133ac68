"""Run one benchmark cell once on one NVIDIA card and print its result.

    python3 bench_torch/run.py --workload <name> --seed <n> \\
        --seconds <window> --trace <0|1>

The cells are listed in BENCHMARK.json at the repository root. Exits with
2, and prints no result, where no CUDA device (or too few) is found.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

if __name__ == "__main__":
    from bench_torch.harness import main
    sys.exit(main(sys.argv[1:], T_START))
