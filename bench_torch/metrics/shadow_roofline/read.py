"""shadow_roofline: the least time of one frame's unfused shadow walks
(the benchmark's count, ``bench_torch/shadowcount.py``: the any-hit walks
of every unfused light's shadow rays, without the closest walk that
finds their origins) over the device time per frame, in the traced
window, of the kernels of ``tpurt_torch/kernels/csrc/shadow_rays.cu``,
picked from the trace by name; in %. None where the trace holds none of
them or no light is unfused."""

import re

from bench_torch.shadowcount import frame_shadow_work

KERNELS = re.compile(r"\bshadow_rays_kernel\b|\bany_psoft_kernel\b")


def read(ctx):
    shadow_s = sum(s for name, s in ctx.trace.kernels if KERNELS.search(name))
    if shadow_s <= 0:
        return None
    work = frame_shadow_work(ctx.cell, ctx.last_frame_index)
    if work is None:
        return None
    return 100.0 * work["bound_ms"] / (shadow_s * 1e3 / ctx.trace.frames)
