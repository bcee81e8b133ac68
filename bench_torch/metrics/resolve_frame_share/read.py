"""resolve_frame_share: the traced frames whose outputs the resolve kernel
wrote (``Renderer.spans.resolve_frames``), over the traced frames, in %;
None where no frame was traced or the program keeps no such record."""


def read(ctx):
    spans = getattr(ctx.cell.renderer, "spans", None)
    if spans is None or not spans.frames:
        return None
    resolved = getattr(spans, "resolve_frames", None)
    return None if resolved is None else 100.0 * resolved / spans.frames
