"""graph_frame_share: the traced frames whose stages replayed CUDA graphs
(``Renderer.spans.graph_frames``), over the traced frames, in %; None
where no frame was traced or the program keeps no such record."""


def read(ctx):
    spans = getattr(ctx.cell.renderer, "spans", None)
    if spans is None or not spans.frames:
        return None
    graph = getattr(spans, "graph_frames", None)
    return None if graph is None else 100.0 * graph / spans.frames
