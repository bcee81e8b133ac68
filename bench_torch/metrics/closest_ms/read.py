"""closest_ms: the device ms a traced frame of the G-buffer's closest-hit
attribute walk (mode CLOSEST of ``fused_shadows_kernel``, picked from the
trace by name, ``bench_torch/closestcount.py``): the unfused frame's
G-buffer walk alone, apart from its shadow pass's walks, which the span
``tpurt.walk`` holds too; None where the trace holds no such launch."""

from bench_torch.closestcount import closest_seconds


def read(ctx):
    closest_s = closest_seconds(ctx.trace)
    if closest_s <= 0:
        return None
    return closest_s * 1e3 / ctx.trace.frames
