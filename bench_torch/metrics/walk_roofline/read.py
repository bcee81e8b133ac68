"""walk_roofline: the least time of one frame's walk work (the benchmark's
count, ``bench_torch/workcount.py``) over the walk kernels' device time
per frame in the traced window, in %.

The walk kernels are picked from the trace by the name patterns of every
file in ``kernels/`` beside this reader: one regular expression per line,
``#`` starts a comment. A kernel added or renamed later gets a file of
its own there."""

import glob
import os
import re

from bench_torch.workcount import frame_work


def patterns(here):
    out = []
    for path in sorted(glob.glob(os.path.join(here, "kernels", "*"))):
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    out.append(re.compile(line))
    return out


def read(ctx):
    pats = patterns(os.path.dirname(os.path.abspath(__file__)))
    walk_s = sum(s for name, s in ctx.trace.kernels
                 if any(p.search(name) for p in pats))
    if walk_s <= 0:
        return None
    work = frame_work(ctx.cell, ctx.last_frame_index)
    if work is None:
        return None
    return 100.0 * work["bound_ms"] / (walk_s * 1e3 / ctx.trace.frames)
