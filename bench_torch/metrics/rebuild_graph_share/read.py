"""rebuild_graph_share: the traced frames whose rebuild replayed its CUDA
graph (``Renderer.spans.rebuild_graph_frames``), over the traced frames,
in %; None where no frame was traced or the program keeps no such
record."""


def read(ctx):
    spans = getattr(ctx.cell.renderer, "spans", None)
    if spans is None or not spans.frames:
        return None
    replayed = getattr(spans, "rebuild_graph_frames", None)
    return None if replayed is None else 100.0 * replayed / spans.frames
