"""walk_ms: the G-buffer's walk (ray packing, the fused or
closest-hit kernel, unpacking), the span ``tpurt.walk`` of
``Renderer.render_frame``: its self ms on the device's timeline (from the
device reaching the span's start to reaching its end, idle included) a
traced frame, from ``Renderer.spans``; None where no traced frame
recorded it."""


def read(ctx):
    spans = getattr(ctx.cell.renderer, "spans", None)
    return None if spans is None else spans.per_frame("tpurt.walk")
