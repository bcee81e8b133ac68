"""launches_per_frame: the device kernels that ran in the traced window,
from the profiler's trace, over its frames."""


def read(ctx):
    if not ctx.trace.launches:
        return None
    return ctx.trace.launches / ctx.trace.frames
