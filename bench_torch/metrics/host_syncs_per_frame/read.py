"""host_syncs_per_frame: the host syncs of a traced frame, the program's
count (``Renderer.spans.syncs``: every read of a device value and every
copy of host data onto the card, where the host waits for the stream),
over the traced frames; None where no frame was traced."""


def read(ctx):
    spans = getattr(ctx.cell.renderer, "spans", None)
    if spans is None or not spans.frames:
        return None
    return spans.syncs / spans.frames
