"""device_idle_share: the share of the traced window's host time (its
frames under the profiler, synchronised at the end, the profiler's
overhead included) in which no operation ran on the card, in %."""


def read(ctx):
    t = ctx.trace
    if t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
