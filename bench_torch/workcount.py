"""The least time a frame's walks could take on the card: the work its
rays need, counted by the benchmark's own plain walk over the accel the
frame walked, and the card's peaks.

The arithmetic is ``chip_smoke.py`` ``bound``'s: 8 float32 operations per
node popped (its empty-slot compares), 25 per slab test of a non-empty
child box, 56 per triangle test; an any-hit walk stops at its first
occluder. Bytes: the accel (nodes, leaf triangles, attribute rows) read
once, each camera ray's origin and direction, each pixel's hit (t, id,
barycentrics) and each light's result written once. The float32 peak is
the rate without fused multiply-adds' doubling, so the bound is up to 2x
low and a share of it reads conservatively.

The walk is the plain version of ``tpurt_torch/kernels/traverse.py``
(``_slab8``, ``_closest_walk``, ``_anyhit_walk``), with one change: the
closest walk takes each popped node's children nearest first for its own
ray (leaves tested in that order, the cap tightening between them, then
the inner children pushed so that the nearest pops next), which the
program's camera-ordered walk can at best match. So the count reads the
same whatever kernel walks the tree, and bounds it from below.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import reference as ref

OPS_PER_POP = 8
OPS_PER_SLAB = 25
OPS_PER_TRI = 56
FP32_PEAK = 67e12       # H100 SXM, float32 outside the tensor cores
HBM_RATE = 3.35e12      # H100 SXM, bytes/s
STACK = 128             # 7 x depth + 1 entries hold a wide tree 18 deep
CHUNK = 1 << 21         # rays per walk
BIG = ref.BIG


class Overflow(Exception):
    pass


def _slab(rec, o, inv, cap):
    """Entry distance and hit of each ray's 8 child boxes (empty slots
    never hit)."""
    lo = hi = None
    for a in range(3):
        t0 = (rec[:, :, a] - o[:, a, None]) * inv[:, a, None]
        t1 = (rec[:, :, a + 3] - o[:, a, None]) * inv[:, a, None]
        lo_a, hi_a = torch.minimum(t0, t1), torch.maximum(t0, t1)
        if a == 0:
            lo, hi = lo_a, hi_a
        elif a == 1:
            lo, hi = torch.maximum(lo, lo_a), torch.minimum(hi, hi_a)
        else:
            lo = torch.maximum(lo, torch.clamp(lo_a, min=0.0))
            hi = torch.minimum(hi, torch.minimum(hi_a, cap[:, None]))
    return lo, (lo <= hi) & (rec[:, :, 0] <= rec[:, :, 3])


class _Stack:
    def __init__(self, n, dev):
        self.s = torch.zeros((n, STACK), dtype=torch.int64, device=dev)
        self.sp = torch.ones(n, dtype=torch.int64, device=dev)

    def pop(self, rows):
        self.sp[rows] -= 1
        return self.s[rows, self.sp[rows]]

    def push(self, rows, refs):
        if rows.numel() == 0:
            return
        if bool((self.sp[rows] >= STACK).any()):
            raise Overflow
        self.s[rows, self.sp[rows]] = refs
        self.sp[rows] += 1


def _leaf_fields(tris, leaf, k):
    row = tris[leaf][:, :9 * k].reshape(-1, k, 9)
    return [row[:, :, f] for f in range(9)]


def _count(stats, key, n):
    stats[key] = stats.get(key, 0) + int(n)


def closest(nodes, tris, k, o, d, stats):
    """Nearest-first closest hit -> (t, hit, unnormalised normal)."""
    n, dev = o.shape[0], o.device
    inv = torch.clamp(1.0 / d, -BIG, BIG)
    best_t = torch.full((n,), BIG, device=dev)
    gn = torch.zeros((n, 3), device=dev)
    st = _Stack(n, dev)
    while True:
        rows = torch.nonzero(st.sp > 0)[:, 0]
        if rows.numel() == 0:
            break
        rec = nodes[st.pop(rows)].reshape(-1, 8, 16)
        _count(stats, "pops", rows.numel())
        _count(stats, "slab_tests", (rec[:, :, 0] <= rec[:, :, 3]).sum())
        enter, hit = _slab(rec, o[rows], inv[rows], best_t[rows])
        refs = rec[:, :, 6].to(torch.int64)
        order = torch.argsort(torch.where(hit, enter, float("inf")), dim=1)
        for c in range(8):
            slot = order[:, c:c + 1]
            e = enter.gather(1, slot)[:, 0]
            ref_c = refs.gather(1, slot)[:, 0]
            m = hit.gather(1, slot)[:, 0] & (ref_c < 0) \
                & (e <= best_t[rows])
            if not bool(m.any()):
                continue
            r = rows[m]
            leaf = -ref_c[m] - 1
            tri = _leaf_fields(tris, leaf, k)
            _count(stats, "closest_tris", r.numel() * k)
            cand, _, _ = ref.closest_t(tri, [o[r, a] for a in range(3)],
                                       [d[r, a] for a in range(3)])
            j = torch.argmin(cand, dim=1, keepdim=True)
            tj = cand.gather(1, j)[:, 0]
            better = tj < best_t[r]
            r, j = r[better], j[better]
            best_t[r] = tj[better]
            e1 = torch.stack([x[better].gather(1, j)[:, 0] for x in tri[3:6]],
                             -1)
            e2 = torch.stack([x[better].gather(1, j)[:, 0] for x in tri[6:9]],
                             -1)
            gn[r] = ref._cross(e1, e2)
        for c in range(7, -1, -1):
            slot = order[:, c:c + 1]
            ref_c = refs.gather(1, slot)[:, 0]
            m = hit.gather(1, slot)[:, 0] & (ref_c >= 0) \
                & (enter.gather(1, slot)[:, 0] <= best_t[rows])
            st.push(rows[m], ref_c[m])
    return best_t, best_t < BIG, gn


def occluded(nodes, tris, k, so, sd, tmax, stats):
    """Any-hit walk in the accel's slot order, as the program's."""
    n, dev = so.shape[0], so.device
    inv = torch.clamp(1.0 / sd, -BIG, BIG)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    st = _Stack(n, dev)
    st.sp[tmax <= 0.0] = 0
    while True:
        rows = torch.nonzero((st.sp > 0) & ~occ)[:, 0]
        if rows.numel() == 0:
            break
        rec = nodes[st.pop(rows)].reshape(-1, 8, 16)
        _count(stats, "pops", rows.numel())
        _count(stats, "slab_tests", (rec[:, :, 0] <= rec[:, :, 3]).sum())
        _, hit = _slab(rec, so[rows], inv[rows], tmax[rows])
        refs = rec[:, :, 6].to(torch.int64)
        done = torch.zeros(rows.shape[0], dtype=torch.bool, device=dev)
        for c in range(8):
            m = hit[:, c] & (refs[:, c] < 0) & ~done
            if bool(m.any()):
                r = rows[m]
                tri = _leaf_fields(tris, -refs[m, c] - 1, k)
                ok = ref.occluders(tri, [so[r, a] for a in range(3)],
                                   [sd[r, a] for a in range(3)], tmax[r])
                h = ok.any(dim=1)
                first = ok.to(torch.int32).argmax(dim=1) + 1
                _count(stats, "anyhit_tris", torch.where(h, first, k).sum())
                occ[r] = h
                done[m] = h
            p = hit[:, c] & (refs[:, c] >= 0) & ~done
            st.push(rows[p], refs[p, c])
    return occ


def frame_work(cell, frame_index: int) -> Optional[dict]:
    """The counted work and least time of one frame's walks: its camera
    rays' closest hits, then each light's shadow rays (a sun cone's spp
    samples from the frame's stream) -> {pops, slab_tests, closest_tris,
    anyhit_tris, ops, bytes, bound_ms}; None where the Renderer's accel
    is not the 8-wide row layout this walk reads, or a walk outgrows its
    stack."""
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
    v = torch.as_tensor(r.mesh.vertices, device=dev)
    box = (v.amin(0), v.amax(0))
    fseed = ref.frame_seed(cell.seed, frame_index)
    stats = {}
    try:
        for c0 in range(0, w * h, CHUNK):
            ys, xs = y[c0:c0 + CHUNK], x[c0:c0 + CHUNK]
            o, d = ref.camera_rays(cell.camera, w, h, ys, xs, torch.float32)
            o = o.contiguous()
            t, hit, gn = closest(nodes, tris, k, o, d, stats)
            so = _biased_origins(o, d, t, gn, view["shadow_bias"])
            for li, light in enumerate(cell.lights):
                for sd in _shadow_dirs(light, li, view["spp"], fseed, ys, xs,
                                       w, dev):
                    tmax = ref._exit_cap(hit, so, torch.clamp(
                        1.0 / sd, -BIG, BIG), box, BIG)
                    occluded(nodes, tris, k, so, sd, tmax, stats)
    except Overflow:
        return None
    ops = (stats.get("pops", 0) * OPS_PER_POP
           + stats.get("slab_tests", 0) * OPS_PER_SLAB
           + (stats.get("closest_tris", 0) + stats.get("anyhit_tris", 0))
           * OPS_PER_TRI)
    tables = [t for t in (r.attr_tables or ()) if t is not None]
    nbytes = sum(t.numel() * t.element_size() for t in (nodes, tris, *tables))
    nbytes += w * h * (24 + 16 + 4 * len(cell.lights))
    bound_s = max(ops / FP32_PEAK, nbytes / HBM_RATE)
    return dict(stats, ops=ops, bytes=nbytes, bound_ms=bound_s * 1e3)


def _biased_origins(o, d, t, gn, bias):
    rn = 1.0 / torch.sqrt(torch.clamp((gn * gn).sum(-1), min=1e-30))
    flip = torch.where((gn * d).sum(-1) > 0.0, -1.0, 1.0)
    tt = torch.where(t < BIG, t, 0.0)
    return o + tt[:, None] * d + gn * (bias * rn * flip)[:, None]


def _shadow_dirs(light, li, spp, fseed, y, x, w, dev):
    """The shadow directions of one light for the pixels (y, x): one for a
    directional light, ``spp`` cone samples for a sun."""
    axis = torch.as_tensor(light.direction, device=dev)
    if light.kind != 2:
        yield axis.expand(y.shape[0], 3)
        return
    cone_cos = float(np.cos(np.float32(light.angular_radius)))
    b0, b1 = ref.onb3(axis)
    ray_index = ref.packed_index(y, x, w)
    for s in range(spp):
        u1, u2 = ref.uniforms(fseed, li, ray_index, s)
        cos_t = 1.0 - u1 * (1.0 - cone_cos)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        sphi, cphi = ref.sincos_2pi(u2)
        sd = axis * cos_t[:, None] + b0 * (sin_t * cphi)[:, None] \
            + b1 * (sin_t * sphi)[:, None]
        yield sd / torch.sqrt(torch.clamp((sd * sd).sum(-1), min=1e-20))[
            :, None]
