"""host_wait_ms: the host's ms a traced frame blocked in the frame's
host reads (the spans ``tpurt.read``, the walk flags, and
``tpurt.rebuild.count_read``, the rebuild's wide-node count), from
``Renderer.spans``: the time the frame's work waited for the card. None
where no traced frame recorded them."""

READS = ("tpurt.read", "tpurt.rebuild.count_read")


def read(ctx):
    spans = getattr(ctx.cell.renderer, "spans", None)
    if spans is None:
        return None
    ms = [spans.per_frame(name, "host_ms") for name in READS]
    ms = [m for m in ms if m is not None]
    return sum(ms) if ms else None
