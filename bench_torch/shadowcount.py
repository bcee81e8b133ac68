"""The least time a frame's unfused shadow pass could take on the card:
the any-hit walks of the shadow rays of every light that the frame's
unfused pass traces, counted by ``workcount.py``'s plain walk, and the
card's peaks.

The shadow rays start where ``workcount``'s plain closest walk finds each
pixel's hit, as ``workcount.frame_work`` starts them, and take its
directions and caps; a light's rays are one batch (a sun cone's spp
samples, one batch each). The closest walk's own pops and tests are
counted apart (``closest``) and left out of the bound: the unfused pass
does not find the hits (a raster frame rasterizes them). Operations:
``workcount``'s 8 a pop, 25 a slab test of a non-empty child, 56 a
triangle test, an any-hit walk stopping at its first occluder. Bytes: the
accel (nodes and leaf triangles) read once, and each live shadow ray's
origin, direction and cap (28 B) read and its answer (4 B) written once.
A ray is live where its cap is above 0, as the program's counter
``shadow_rays`` counts it. The peaks are ``workcount``'s.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import reference as ref
from . import workcount as wc

RAY_BYTES = 28 + 4


def unfused_light_indices(renderer) -> range:
    """The lights the Renderer's frames give the unfused shadow pass, as
    ``tpurt_torch.app.render_frame_fn`` routes them: every light where
    the frame reads no hit table (the raster G-buffer), else those the
    fused route leaves over."""
    from tpurt_torch.app import frame_route, unfused_lights
    r = renderer
    tabs = r.attr_tables is not None or r.shade_table is not None
    route = frame_route(r.config, r.lights, r.accel) if tabs else "unfused"
    return unfused_lights(route, len(r.lights))


def frame_shadow_work(cell, frame_index: int,
                      lights: Optional[Sequence[int]] = None
                      ) -> Optional[dict]:
    """The counted work and least time of one frame's unfused shadow
    walks -> {pops, slab_tests, anyhit_tris, rays, closest (the closest
    walk's pops, slab_tests, closest_tris, not in the bound), ops, bytes,
    bound_ms}; None where no light is unfused (``lights``: their indices,
    by default ``unfused_light_indices``), the accel is not the 8-wide
    row layout the walk reads, or a walk outgrows its stack."""
    r = cell.renderer
    if lights is None:
        lights = unfused_light_indices(r)
    acc = r.accel
    nodes, tris = getattr(acc, "nodes", None), getattr(acc, "tris", None)
    k = getattr(acc, "leaf_size", None)
    if not lights or nodes is None or tris is None or k is None \
            or nodes.dim() != 2 or nodes.shape[1] != 128 or tris.dim() != 2:
        return None
    view, dev = cell.view, nodes.device
    w, h = view["width"], view["height"]
    idx = torch.arange(w * h, device=dev)
    y, x = idx // w, idx % w
    v = torch.as_tensor(r.mesh.vertices, device=dev)
    box = (v.amin(0), v.amax(0))
    fseed = ref.frame_seed(cell.seed, frame_index)
    stats, closest = {}, {}
    rays = 0
    try:
        for c0 in range(0, w * h, wc.CHUNK):
            ys, xs = y[c0:c0 + wc.CHUNK], x[c0:c0 + wc.CHUNK]
            o, d = ref.camera_rays(cell.camera, w, h, ys, xs, torch.float32)
            o = o.contiguous()
            t, hit, gn = wc.closest(nodes, tris, k, o, d, closest)
            so = wc._biased_origins(o, d, t, gn, view["shadow_bias"])
            for li in lights:
                for sd in wc._shadow_dirs(cell.lights[li], li, view["spp"],
                                          fseed, ys, xs, w, dev):
                    tmax = ref._exit_cap(hit, so, torch.clamp(
                        1.0 / sd, -ref.BIG, ref.BIG), box, ref.BIG)
                    rays += int((tmax > 0.0).sum())
                    wc.occluded(nodes, tris, k, so, sd, tmax, stats)
    except wc.Overflow:
        return None
    ops = (stats.get("pops", 0) * wc.OPS_PER_POP
           + stats.get("slab_tests", 0) * wc.OPS_PER_SLAB
           + stats.get("anyhit_tris", 0) * wc.OPS_PER_TRI)
    nbytes = sum(a.numel() * a.element_size() for a in (nodes, tris))
    nbytes += rays * RAY_BYTES
    bound_s = max(ops / wc.FP32_PEAK, nbytes / wc.HBM_RATE)
    return dict(stats, rays=rays, closest=closest, ops=ops, bytes=nbytes,
                bound_ms=bound_s * 1e3)
