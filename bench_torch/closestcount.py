"""The least time a frame's closest-hit G-buffer walk could take on the
card: the closest hits of every camera ray, counted by ``workcount.py``'s
plain walk, and the card's peaks; and the device time of the walk's
kernel in a traced window.

The walk is ``workcount.closest``'s, nearest-first, from the camera rays
that ``workcount.frame_work`` starts from, so its pops, slab tests and
triangle tests are the closest part of that count. Operations:
``workcount``'s 8 a pop, 25 a slab test of a non-empty child, 56 a
triangle test. Bytes: the accel (nodes, leaf triangles, attribute rows)
read once, each camera ray's origin and direction (24 B) read and each
pixel's attribute channels (15 float32 channels, 60 B) written once. The
peaks are ``workcount``'s. It counts the work the G-buffer needs, not
what a kernel does beyond it.

The kernel is the closest-hit attribute walk, mode CLOSEST (5) of
``tpurt_torch/kernels/csrc/fused_shadows.cu`` with attribute rows (1) or
textured attribute rows (2), picked from the trace by name.
"""

from __future__ import annotations

import re
from typing import Optional

import torch

from . import reference as ref
from . import workcount as wc

RAY_BYTES = 24
PIXEL_BYTES = 15 * 4
KERNELS = re.compile(r"\bfused_shadows_kernel<5, ?[12]>")


def closest_seconds(trace) -> float:
    """The device seconds of the traced window's closest-hit attribute
    walks."""
    return sum(s for name, s in trace.kernels if KERNELS.search(name))


def frame_closest_work(cell) -> Optional[dict]:
    """The counted work and least time of one frame's closest-hit walk of
    every camera ray -> {pops, slab_tests, closest_tris, rays, ops, bytes,
    bound_ms}; None where the Renderer's accel is not the 8-wide row
    layout the walk reads, or a walk outgrows its stack."""
    r = cell.renderer
    acc = r.accel
    nodes, tris = getattr(acc, "nodes", None), getattr(acc, "tris", None)
    k = getattr(acc, "leaf_size", None)
    if nodes is None or tris is None or k is None or nodes.dim() != 2 \
            or nodes.shape[1] != 128 or tris.dim() != 2:
        return None
    view, dev = cell.view, nodes.device
    w, h = view["width"], view["height"]
    idx = torch.arange(w * h, device=dev)
    y, x = idx // w, idx % w
    stats = {}
    try:
        for c0 in range(0, w * h, wc.CHUNK):
            ys, xs = y[c0:c0 + wc.CHUNK], x[c0:c0 + wc.CHUNK]
            o, d = ref.camera_rays(cell.camera, w, h, ys, xs, torch.float32)
            wc.closest(nodes, tris, k, o.contiguous(), d, stats)
    except wc.Overflow:
        return None
    ops = (stats.get("pops", 0) * wc.OPS_PER_POP
           + stats.get("slab_tests", 0) * wc.OPS_PER_SLAB
           + stats.get("closest_tris", 0) * wc.OPS_PER_TRI)
    tables = [t for t in (r.attr_tables or ()) if t is not None]
    nbytes = sum(t.numel() * t.element_size() for t in (nodes, tris, *tables))
    nbytes += w * h * (RAY_BYTES + PIXEL_BYTES)
    bound_s = max(ops / wc.FP32_PEAK, nbytes / wc.HBM_RATE)
    return dict(stats, rays=w * h, ops=ops, bytes=nbytes,
                bound_ms=bound_s * 1e3)
