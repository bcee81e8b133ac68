"""accel_setup_ms: the accel's set-up as the Renderer times it, the sum of
the set-up entries of ``Renderer.stats`` read after construction (host
SBVH build and copy, or the rebuild's full-box build and wide count; the
8-wide collapse; the attribute rows), in ms."""


def read(ctx):
    values = list(ctx.setup_stats.values())
    return sum(values) if values else None
