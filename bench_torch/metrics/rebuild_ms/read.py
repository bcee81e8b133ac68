"""rebuild_ms: the per-frame rebuild, ``Renderer.stats["build_ms"]`` (CUDA
events around the rebuild) read after every frame of the traced window,
their mean, in ms."""


def read(ctx):
    if not ctx.build_ms:
        return None
    return sum(ctx.build_ms) / len(ctx.build_ms)
