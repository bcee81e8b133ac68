"""shadow_ms: the fused walk's visibility conversion and
every unfused shadow pass, the span ``tpurt.shadow`` of
``Renderer.render_frame``: its self ms on the device's timeline (from the
device reaching the span's start to reaching its end, idle included) a
traced frame, from ``Renderer.spans``; None where no traced frame
recorded it."""


def read(ctx):
    spans = getattr(ctx.cell.renderer, "spans", None)
    return None if spans is None else spans.per_frame("tpurt.shadow")
