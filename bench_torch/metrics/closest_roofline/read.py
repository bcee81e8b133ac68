"""closest_roofline: the least time of one frame's closest-hit G-buffer
walk (the benchmark's count, ``bench_torch/closestcount.py``: every
camera ray's closest hit, its attribute channels written) over the device
time per frame, in the traced window, of the closest-hit attribute walk's
launches (``closest_ms``), in %; None where the trace holds none of them
or the accel is not the one the count walks."""

from bench_torch.closestcount import closest_seconds, frame_closest_work


def read(ctx):
    closest_s = closest_seconds(ctx.trace)
    if closest_s <= 0:
        return None
    work = frame_closest_work(ctx.cell)
    if work is None:
        return None
    return 100.0 * work["bound_ms"] / (closest_s * 1e3 / ctx.trace.frames)
