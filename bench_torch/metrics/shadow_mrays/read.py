"""shadow_mrays: the live shadow rays the unfused shadow pass traced a
traced frame (the program's counter ``shadow_rays``: each ray batch's
rays with a cap above 0, each in-kernel sampler's valid pixels x spp,
carried by the frame's host read; ``Renderer.spans.counts``), in
millions; None where no frame was traced, no light took the unfused pass
or the program keeps no such counter."""


def read(ctx):
    spans = getattr(ctx.cell.renderer, "spans", None)
    counts = getattr(spans, "counts", None)
    if counts is None or "shadow_rays" not in counts or not spans.frames:
        return None
    return counts["shadow_rays"] / spans.frames / 1e6
