"""The fused closest-hit + shadow traversals over the 8-wide BVH
(counterparts of ``tpurt/kernels/traverse.py``):

- ``trace_closest_shadow`` -> ``_closest_shadow_kernel_w8_b``: light 0's
  hard shadow;
- ``trace_closest_multi_shadow`` -> ``_closest_multi_shadow_kernel_w8_b``:
  one hard shadow per light, an i32 occlusion bitmask;
- ``trace_closest_soft_shadow`` -> ``_closest_soft_shadow_kernel_w8_b``:
  spp cone samples toward an area (sun) light, counts in [0, spp];
- ``trace_closest_point_soft_shadow`` ->
  ``_closest_psoft_shadow_kernel_w8_b``: spp jittered-disk samples on a
  point light, counts;
- ``trace_closest_soft_multi_shadow`` ->
  ``_closest_soft_multi_shadow_kernel_w8_b``: soft light 0 (cone or disk)
  -> counts, hard directional extras -> bitmask.

All five are modes of one CUDA kernel template (``csrc/fused_shadows.cu``).
Each function has three pieces that share one contract on the packed ray
block:

- ``*_cuda``: the hand-written CUDA kernel in its mode, one thread per
  ray. It takes CUDA tensors only and launches or raises; ``.launches``
  counts its launches.
- ``*_reference``: the same function in plain PyTorch, a vectorised
  per-ray stack walk. The wrapper takes it only for CPU tensors.
- ``trace_*``: the wrapper the frame calls. It packs the rays, picks one
  of the two by the tensors' device, and decodes the attribute channels.

All walks return ``counts`` i32[2]: pushes dropped because the per-ray
stack was full, and walks cut at the iteration cap, summed over phase 1
and every shadow walk. A correct frame leaves both at zero;
``check_walk_counts`` raises otherwise. The soft samplers draw from the
counter-based generator of ``sampling.py``.

The layouts at the kernel boundary are the JAX package's: nodes
f32[Nw,128], leaf rows f32[L,128], attribute rows f32[nblk,128], rays
f32[PB,10,8,128] (o, d, clamped 1/d, t_max), the float32 scalar blocks of
the JAX wrappers, outputs f32[PB,15,8,128] attribute channels and
i32[PB,8,128] occlusion, mask or counts.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..bvh.wide import WideBVH
from .sampling import (lane_axis_onb, onb3, rsqrt, sample_uniforms,
                       sincos_2pi)

TILE = 32          # 32x32 pixel tile -> one (8, 128) packet
_BIG = 3.4e38
ATTR_CH = 15
LANES = 8 * 128
# Per-ray stack entries compiled into the CUDA kernel (csrc STACK_CAPACITY).
# An 8-wide tree of D internal levels needs at most 7*D + 1.
STACK_CAPACITY = 256


def iter_cap(num_wide: int) -> int:
    """Walk iteration cap: every node is pushed at most once, so a walk
    that reaches it is corrupted (the JAX package's 2*num_wide+64)."""
    return 2 * num_wide + 64


def stack_bound(depth: int) -> int:
    return 7 * depth + 1


def check_stack_bound(depth: int, capacity: int = STACK_CAPACITY) -> None:
    """Raise when a wide tree of ``depth`` levels could overflow a per-ray
    stack of ``capacity`` entries."""
    if stack_bound(depth) > capacity:
        raise ValueError(
            f"wide BVH depth {depth} needs a per-ray stack of "
            f"{stack_bound(depth)} entries; the kernel has {capacity}")


def check_walk_counts(counts: torch.Tensor) -> None:
    """Raise unless both walk counters (stack overflows, walks cut at the
    iteration cap) are zero."""
    overflow, capped = (int(x) for x in counts.tolist())
    if overflow or capped:
        raise RuntimeError(
            f"traversal incomplete: {overflow} stack overflows, "
            f"{capped} walks cut at the iteration cap")


# ---------------------------------------------------------------------------
# Packet layout: image <-> (P, 8, 128) tiles
# ---------------------------------------------------------------------------

def _tile_shape(h: int, w: int) -> Tuple[int, int]:
    return -(-h // TILE), -(-w // TILE)


def to_packets(a: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """f32[H, W] -> f32[P, 8, 128]: 32x32 pixel tiles, row-major in-tile."""
    h, w = a.shape
    ht, wt = _tile_shape(h, w)
    ap = F.pad(a, (0, wt * TILE - w, 0, ht * TILE - h), value=fill)
    t = ap.reshape(ht, TILE, wt, TILE).permute(0, 2, 1, 3)
    return t.reshape(ht * wt, 8, 128)


def from_packets(p: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of to_packets."""
    ht, wt = _tile_shape(h, w)
    t = p.reshape(ht, wt, TILE, TILE).permute(0, 2, 1, 3)
    return t.reshape(ht * TILE, wt * TILE)[:h, :w]


def _ray_packets(origins, dirs, t_max):
    """(H, W, 3) rays -> seven (P, 8, 128) component tensors."""
    if origins.ndim != 3:
        raise NotImplementedError("flat ray sets are not ported; pass (H, W, 3)")
    h, w = origins.shape[:2]
    comps = [to_packets(origins[..., c]) for c in range(3)]
    comps += [to_packets(dirs[..., c], fill=1.0) for c in range(3)]
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=origins.device)
    tm = to_packets(tm.expand(h, w), fill=-1.0)
    return comps, tm, ("img", h, w)


def _unpack(res, meta):
    _, h, w = meta
    return from_packets(res, h, w)


def _ray_packets_packed(origins, dirs, t_max, batch: int):
    """Rays -> ONE packed f32[PB, 10, 8, 128] tensor (PB = P padded to a
    multiple of ``batch``; padding packets have t_max = -1, inactive).
    Components: o.xyz, d.xyz, clamped 1/d.xyz, t_max."""
    comps, tm, meta = _ray_packets(origins, dirs, t_max)
    invs = [torch.clamp(1.0 / c, -_BIG, _BIG) for c in comps[3:6]]
    rays = torch.stack(comps + invs + [tm], dim=1)     # (P, 10, 8, 128)
    p = rays.shape[0]
    pb = -(-p // batch) * batch
    if pb != p:
        pad = torch.zeros((pb - p, 10, 8, 128), dtype=rays.dtype,
                          device=rays.device)
        pad[:, 9] = -1.0
        rays = torch.cat([rays, pad])
    return rays.contiguous(), p, meta


def _attr_channels(out, p, meta) -> Dict[str, torch.Tensor]:
    """(PB, ATTR_CH, 8, 128) output -> image-shaped channel dict; the
    packed oct normal pairs are unpacked here."""
    from ..passes.shading import unpack_oct12
    ch = [_unpack(out[:p, c], meta) for c in range(ATTR_CH)]
    sidx = ch[1].to(torch.int32)
    valid = sidx >= 0
    oct_ = torch.cat([unpack_oct12(ch[9]), unpack_oct12(ch[10]),
                      unpack_oct12(ch[11])], dim=-1)
    return {
        "t": torch.where(valid, ch[0], float("inf")),
        "sidx": torch.where(valid, sidx, -1),
        "u": ch[2], "v": ch[3],
        "uv": torch.stack([ch[4], ch[5]], dim=-1),
        "kd": ch[6],
        "layer": torch.where(valid, ch[7], -1.0),
        "tri_id": torch.where(valid, ch[8].to(torch.int32), -1),
        "oct": oct_,
        "gn": torch.stack(ch[12:15], dim=-1),
    }


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------

def _slab8(rec, o, inv, t_min, cap):
    """Per-ray test of the 8 child boxes of each popped row: rec
    f32[n, 8, 16], o/inv tuples of f32[n] -> bool[n, 8]. Empty slots have
    inverted boxes that the slab test alone accepts, so it also demands
    bmin.x <= bmax.x."""
    lo = None
    hi = None
    for a in range(3):
        t0 = (rec[:, :, a] - o[a][:, None]) * inv[a][:, None]
        t1 = (rec[:, :, a + 3] - o[a][:, None]) * inv[a][:, None]
        lo_a, hi_a = torch.minimum(t0, t1), torch.maximum(t0, t1)
        if a == 0:
            lo, hi = lo_a, hi_a
        elif a == 1:
            lo, hi = torch.maximum(lo, lo_a), torch.minimum(hi, hi_a)
        else:
            enter = torch.maximum(lo, torch.clamp(lo_a, min=t_min))
            exit_ = torch.minimum(hi, torch.minimum(hi_a, cap[:, None]))
    return (enter <= exit_) & (rec[:, :, 0] <= rec[:, :, 3])


def _leaf_tris(tris, leaf, k):
    row = tris[leaf][:, :9 * k].reshape(-1, k, 9)
    return [row[:, :, f] for f in range(9)]


def _mt_terms(tri, o, d):
    """Shared Möller–Trumbore products for n rays x k triangles, in the
    kernel's order of operations (no fused multiply-add)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    nu = tx * px + ty * py + tz * pz
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    nv = dx * qx + dy * qy + dz * qz
    nt = e2x * qx + e2y * qy + e2z * qz
    return det, nu, nv, nt


def _leaf_closest_t(tri, o, d):
    """(t, u, v) per candidate, t = BIG on a miss (division by det)."""
    det, nu, nv, nt = _mt_terms(tri, o, d)
    ok = det.abs() >= 1e-9
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    u = nu * inv_det
    v = nv * inv_det
    t = nt * inv_det
    ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return torch.where(ok, t, _BIG), u, v


def _leaf_occluders(tri, o, d, t_min, tmax):
    """Division-free occlusion test of n rays x k triangles -> bool[n, k],
    True where the triangle occludes."""
    det, nu, nv, nt = _mt_terms(tri, o, d)
    sgn = torch.where(det < 0.0, -1.0, 1.0)
    adet = det * sgn
    nu = nu * sgn
    nv = nv * sgn
    nt = nt * sgn
    tm = tmax[:, None]
    ok = ((adet >= 1e-9) & (nu >= 0.0) & (nv >= 0.0) & (nu + nv <= adet)
          & (nt > t_min * adet) & (nt < tm * adet))
    return ok


class _Walk:
    """Per-ray stacks for a vectorised walk of n rays."""

    def __init__(self, n, stack_size, device):
        self.stack = torch.zeros((n, stack_size), dtype=torch.int32,
                                 device=device)
        self.sp = torch.ones(n, dtype=torch.int32, device=device)
        self.it = torch.zeros(n, dtype=torch.int32, device=device)
        self.size = stack_size
        self.overflow = torch.zeros((), dtype=torch.int32, device=device)

    def pop(self, rows):
        self.sp[rows] -= 1
        return self.stack[rows, self.sp[rows].long()].long()

    def push(self, rows, refs):
        spr = self.sp[rows]
        ok = spr < self.size
        self.overflow += (~ok).sum().to(torch.int32)
        rows, spr, refs = rows[ok], spr[ok], refs[ok]
        self.stack[rows, spr.long()] = refs
        self.sp[rows] += 1


def _count(stats, key, n) -> None:
    """Add ``n`` (a tensor or int) to ``stats[key]`` when stats are kept.
    The plain walks count the work the kernels' bound is computed from, as
    the kernels do it: "pops" (node rows popped, each with 8 empty-slot
    compares), "slab_tests" (the non-empty child boxes of those rows, the
    only ones the kernels slab-test), "closest_tris" (k per leaf the
    closest walk visits: it tests every triangle) and "anyhit_tris" (per
    leaf an any-hit walk visits, the triangles up to and including the
    first that occludes, where the kernels stop). "anyhit_leaf_tris"
    counts k per leaf the any-hit walks visit, an upper bound kept to
    show what the early exit saves."""
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


def _count_pops(stats, rec) -> None:
    if stats is not None:
        _count(stats, "pops", rec.shape[0])
        _count(stats, "slab_tests", (rec[:, :, 0] <= rec[:, :, 3]).sum())


def _closest_walk(nodes, tris, at0, at1, k, o, d, inv, tmax, t_min,
                  max_iters, stack_size, stats=None):
    n = tmax.shape[0]
    dev = tmax.device
    active0 = tmax > t_min
    best_t = torch.where(active0, tmax, -_BIG)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    # u, v, kd, tid, oct0..2, gn.xyz (uv/layer stay 0 untextured)
    attr = torch.zeros((n, 10), dtype=torch.float32, device=dev)
    w = _Walk(n, stack_size, dev)
    while True:
        rows = torch.nonzero((w.sp > 0) & (w.it < max_iters))[:, 0]
        if rows.numel() == 0:
            break
        rec = nodes[w.pop(rows)].reshape(-1, 8, 16)
        _count_pops(stats, rec)
        cap = torch.where(active0[rows], best_t[rows], -_BIG)
        ro = tuple(c[rows] for c in o)
        hit = _slab8(rec, ro, tuple(c[rows] for c in inv), t_min, cap)
        refs = rec[:, :, 6].to(torch.int32)
        for c in range(8):
            leaf_m = hit[:, c] & (refs[:, c] < 0)
            if bool(leaf_m.any()):
                _count(stats, "closest_tris", leaf_m.sum() * k)
                r = rows[leaf_m]
                leaf = torch.clamp(-refs[leaf_m, c] - 1, min=0).long()
                tri = _leaf_tris(tris, leaf, k)
                t, u, v = _leaf_closest_t(tri, tuple(x[r] for x in o),
                                          tuple(x[r] for x in d))
                cand = torch.where(t > t_min, t, float("inf"))
                j = torch.argmin(cand, dim=1)      # first minimum
                tj = cand.gather(1, j[:, None])[:, 0]
                better = (tj < best_t[r]) & active0[r]
                r, j, leaf = r[better], j[better], leaf[better]
                tri = [x[better] for x in tri]
                sel = j[:, None]
                best_t[r] = tj[better]
                best_i[r] = (leaf * k + j).to(torch.int32)
                ar = at0[leaf] if k <= 8 else torch.cat(
                    [at0[leaf], at1[leaf]], dim=1)
                a = ar[:, :16 * k].reshape(-1, k, 16).gather(
                    1, sel[:, :, None].expand(-1, 1, 16))[:, 0]
                e1x, e1y, e1z, e2x, e2y, e2z = (
                    x.gather(1, sel)[:, 0] for x in tri[3:9])
                attr[r] = torch.stack([
                    u[better].gather(1, sel)[:, 0],
                    v[better].gather(1, sel)[:, 0],
                    a[:, 3], a[:, 11], a[:, 0], a[:, 1], a[:, 2],
                    e1y * e2z - e1z * e2y,
                    e1z * e2x - e1x * e2z,
                    e1x * e2y - e1y * e2x], dim=1)
            push_m = hit[:, c] & (refs[:, c] >= 0)
            if bool(push_m.any()):
                w.push(rows[push_m], refs[push_m, c])
        w.it[rows] += 1
    capped = ((w.sp > 0).sum()).to(torch.int32)
    return best_t, best_i, attr, w.overflow, capped


def _anyhit_walk(nodes, tris, k, o, d, inv, tmax, t_min, max_iters,
                 stack_size, stats=None):
    n = tmax.shape[0]
    dev = tmax.device
    active0 = tmax > t_min
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    w = _Walk(n, stack_size, dev)
    while True:
        rows = torch.nonzero((w.sp > 0) & (w.it < max_iters) & ~occ)[:, 0]
        if rows.numel() == 0:
            break
        rec = nodes[w.pop(rows)].reshape(-1, 8, 16)
        _count_pops(stats, rec)
        cap = torch.where(active0[rows], tmax[rows], -_BIG)
        hit = _slab8(rec, tuple(c[rows] for c in o),
                     tuple(c[rows] for c in inv), t_min, cap)
        refs = rec[:, :, 6].to(torch.int32)
        done = torch.zeros(rows.shape[0], dtype=torch.bool, device=dev)
        for c in range(8):
            leaf_m = hit[:, c] & (refs[:, c] < 0) & ~done
            if bool(leaf_m.any()):
                r = rows[leaf_m]
                leaf = torch.clamp(-refs[leaf_m, c] - 1, min=0).long()
                ok = _leaf_occluders(_leaf_tris(tris, leaf, k),
                                     tuple(x[r] for x in o),
                                     tuple(x[r] for x in d), t_min, tmax[r])
                h = ok.any(dim=1)
                if stats is not None:
                    first = ok.to(torch.int32).argmax(dim=1) + 1
                    _count(stats, "anyhit_tris",
                           torch.where(h, first, k).sum())
                    _count(stats, "anyhit_leaf_tris", leaf_m.sum() * k)
                occ[r] = h
                done[leaf_m] = h
            push_m = hit[:, c] & (refs[:, c] >= 0) & ~done
            if bool(push_m.any()):
                w.push(rows[push_m], refs[push_m, c])
        w.it[rows] += 1
    capped = ((w.sp > 0) & ~occ).sum().to(torch.int32)
    return occ, w.overflow, capped


# Phase 2 ray construction. Every function evaluates in the CUDA kernels'
# order of operations (csrc/walk.cuh), so the two agree bit for bit.

def _inv3(sd):
    return tuple(torch.clamp(1.0 / x, -_BIG, _BIG) for x in sd)


def _biased_origin(bias, o, d, best_t, gn):
    """Hit point pushed by the bias along the unit geometric normal turned
    toward the viewer (``_biased_hit_origin``)."""
    nx, ny, nz = gn
    ox, oy, oz = o
    dx, dy, dz = d
    rn = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                      min=1e-30))
    flip = torch.where(nx * dx + ny * dy + nz * dz > 0.0, -1.0, 1.0)
    off = bias * rn * flip
    return (ox + best_t * dx + nx * off, oy + best_t * dy + ny * off,
            oz + best_t * dz + nz * off)


def _scene_exit_cap(hitm, so, sinv, rmin, rmax):
    """Root-box exit x 1.0001 (``_scene_exit_cap``); -BIG off the hit set."""
    ex = None
    for a in range(3):
        t0 = (rmin[a] - so[a]) * sinv[a]
        t1 = (rmax[a] - so[a]) * sinv[a]
        m = torch.maximum(t0, t1)
        ex = m if ex is None else torch.minimum(ex, m)
    return torch.where(hitm, torch.clamp(ex, min=0.0) * 1.0001, -_BIG)


def _toward(e, hitm):
    """Unit direction along the per-ray vector e, its clamped inverse and
    t capped at |e| x (1 - 1e-4): a point light or a disk sample."""
    d2 = torch.clamp(e[0] * e[0] + e[1] * e[1] + e[2] * e[2], min=1e-24)
    drn = 1.0 / torch.sqrt(d2)
    sd = tuple(x * drn for x in e)
    return sd, _inv3(sd), torch.where(hitm, d2 * drn * (1.0 - 1e-4), -_BIG)


def _point_ray(lp, so, hitm):
    return _toward((lp[0] - so[0], lp[1] - so[1], lp[2] - so[2]), hitm)


def _dir_ray(ld, linv, rmin, rmax, so, hitm):
    n = so[0].shape[0]
    sd = tuple(ld[a].expand(n) for a in range(3))
    sinv = tuple(linv[a].expand(n) for a in range(3))
    return sd, sinv, _scene_exit_cap(hitm, so, sinv, rmin, rmax)


def _cone_ray(u1, u2, axis, t0, t1, cone_cos, rmin, rmax, so, hitm):
    """One uniform direction in the cone around ``axis``, t capped at the
    root-box exit (the soft kernels' per-sample recipe)."""
    cos_t = 1.0 - u1 * (1.0 - cone_cos)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    sphi, cphi = sincos_2pi(u2)
    sc = sin_t * cphi
    ss = sin_t * sphi
    sd = tuple(axis[a] * cos_t + t0[a] * sc + t1[a] * ss for a in range(3))
    srn = rsqrt(torch.clamp(sd[0] * sd[0] + sd[1] * sd[1] + sd[2] * sd[2],
                            min=1e-20))
    sd = tuple(x * srn for x in sd)
    sinv = _inv3(sd)
    return sd, sinv, _scene_exit_cap(hitm, so, sinv, rmin, rmax)


def _disk_ray(u1, u2, e0, basis, radius, hitm):
    """Toward a jittered point of the light's disk: r = sqrt(u1) x radius,
    phi from u2, in the per-ray basis around the axis to the centre."""
    t0x, t0y, t0z, t1x, t1y, t1z = basis
    r = torch.sqrt(u1) * radius
    sphi, cphi = sincos_2pi(u2)
    rc = r * cphi
    rs = r * sphi
    return _toward((e0[0] + t0x * rc + t1x * rs,
                    e0[1] + t0y * rc + t1y * rs,
                    e0[2] + t0z * rc + t1z * rs), hitm)


class _Phase1:
    """The shared phase 1 of every fused plain version: the attribute-
    tracked closest walk over the packed rays, its 15 output channels,
    and the walk counters that phase 2 adds to."""

    def __init__(self, rays, nodes, tris, at0, at1, k, t_min, max_iters,
                 stack_size, stats):
        pb = rays.shape[0]
        comp = rays.reshape(pb, 10, LANES).permute(1, 0, 2).reshape(10, -1)
        self.o = (comp[0], comp[1], comp[2])
        self.d = (comp[3], comp[4], comp[5])
        inv, tmax = (comp[6], comp[7], comp[8]), comp[9]
        self.args = (nodes, tris, k)
        self.walk_kw = dict(max_iters=max_iters, stack_size=stack_size,
                            stats=stats)
        best_t, best_i, attr, ovf, cap = _closest_walk(
            nodes, tris, at0, at1, k, self.o, self.d, inv, tmax, t_min,
            max_iters, stack_size, stats)
        n = tmax.shape[0]
        zero = torch.zeros(n, dtype=torch.float32, device=tmax.device)
        chans = [torch.where(best_i >= 0, best_t, _BIG),
                 best_i.to(torch.float32), attr[:, 0], attr[:, 1], zero,
                 zero, attr[:, 2], zero, attr[:, 3], attr[:, 4], attr[:, 5],
                 attr[:, 6], attr[:, 7], attr[:, 8], attr[:, 9]]
        self.out = torch.stack(chans).reshape(ATTR_CH, pb, 8, 128).permute(
            1, 0, 2, 3).contiguous()
        self.pb = pb
        self.n = n
        self.best_t = best_t
        self.hitm = best_i >= 0
        self.gn = (attr[:, 7], attr[:, 8], attr[:, 9])
        self.ovf, self.cap = ovf, cap

    def origin(self, bias):
        return _biased_origin(bias, self.o, self.d, self.best_t, self.gn)

    def occluded(self, so, ray) -> torch.Tensor:
        """One any-hit walk from the biased origins; adds to the counters."""
        sd, sinv, stmax = ray
        nodes, tris, k = self.args
        occ, ovf, cap = _anyhit_walk(nodes, tris, k, so, sd, sinv, stmax,
                                     0.0, **self.walk_kw)
        self.ovf = self.ovf + ovf
        self.cap = self.cap + cap
        return occ

    def image(self, x: torch.Tensor) -> torch.Tensor:
        """Per-ray i32 values -> the kernels' (PB, 8, 128) output block."""
        return x.to(torch.int32).reshape(self.pb, 8, 128)

    def counts(self) -> torch.Tensor:
        return torch.stack([self.ovf, self.cap]).to(torch.int32)


def closest_shadow_reference(rays, nodes, tris, at0, at1, scal, *,
                             leaf_size: int, point: bool, t_min: float,
                             max_iters: int, stack_size: int, stats=None):
    """Plain PyTorch version of the fused kernel, on any device.

    rays f32[PB,10,8,128] -> (out f32[PB,15,8,128], occ i32[PB,8,128],
    counts i32[2]). Each ray walks its own stack [N, stack_size]; the loop
    runs until every stack is empty. Children of a popped node are tested
    against the cap at pop time and handled in slot order (leaf tests in
    place, internal children pushed), as the kernel does. ``stats``: an
    optional dict that receives the node pops and triangle tests."""
    ph = _Phase1(rays, nodes, tris, at0, at1, leaf_size, t_min, max_iters,
                 stack_size, stats)
    if point:
        so = ph.origin(scal[3])
        ray = _point_ray(scal[0:3], so, ph.hitm)
    else:
        so = ph.origin(scal[6])
        ray = _dir_ray(scal[0:3], scal[3:6], scal[7:10], scal[10:13], so,
                       ph.hitm)
    occ = ph.occluded(so, ray)
    return ph.out, ph.image(occ), ph.counts()


MAX_MASK_LIGHTS = 31   # bits of the i32 occlusion mask


def _check_mask_lights(n: int) -> None:
    if not 1 <= n <= MAX_MASK_LIGHTS:
        raise ValueError(f"{n} lights in an occlusion mask; it holds 1.."
                         f"{MAX_MASK_LIGHTS}")


def _multi_scal_len(points) -> int:
    return 7 + sum(3 if p else 6 for p in points)


def closest_multi_shadow_reference(rays, nodes, tris, at0, at1, scal, *,
                                   leaf_size: int, points, t_min: float,
                                   max_iters: int, stack_size: int,
                                   stats=None):
    """Plain version of ``_closest_multi_shadow_kernel_w8_b``: phase 1,
    then one hard any-hit walk per light from the shared biased hit point.
    scal: [bias, root min(3), root max(3)], then per light a position(3)
    (``points[l]``) or a toward-light direction(3) and its clamped
    inverse(3). -> (out, mask i32[PB,8,128] with bit l = light l occluded,
    counts i32[2])."""
    _check_mask_lights(len(points))
    ph = _Phase1(rays, nodes, tris, at0, at1, leaf_size, t_min, max_iters,
                 stack_size, stats)
    so = ph.origin(scal[0])
    rmin, rmax = scal[1:4], scal[4:7]
    mask = torch.zeros(ph.n, dtype=torch.int32, device=rays.device)
    s = 7
    for li, is_point in enumerate(points):
        if is_point:
            ray = _point_ray(scal[s:s + 3], so, ph.hitm)
            s += 3
        else:
            ray = _dir_ray(scal[s:s + 3], scal[s + 3:s + 6], rmin, rmax, so,
                           ph.hitm)
            s += 6
        mask |= ph.occluded(so, ray).to(torch.int32) << li
    return ph.out, ph.image(mask), ph.counts()


def _sampled_counts(ph, so, spp, seed, zero_stream, make_ray):
    """Occlusion counts in [0, spp] over spp samples of light 0."""
    ray_index = torch.arange(ph.n, device=so[0].device)
    cnt = torch.zeros(ph.n, dtype=torch.int32, device=so[0].device)
    for s in range(spp):
        u1, u2 = sample_uniforms(seed, 0, ray_index, s, zero_stream)
        cnt += ph.occluded(so, make_ray(u1, u2)).to(torch.int32)
    return cnt


def _cone_sampler(scal, at, rmin, rmax, so, hitm):
    """Light-0 cone at scal[at:at+10]: axis(3), basis t0(3), t1(3),
    cone_cos."""
    axis, t0, t1 = scal[at:at + 3], scal[at + 3:at + 6], scal[at + 6:at + 9]
    cone_cos = scal[at + 9]
    return lambda u1, u2: _cone_ray(u1, u2, axis, t0, t1, cone_cos, rmin,
                                    rmax, so, hitm)


def _disk_sampler(scal, at, so, hitm):
    """Light-0 disk at scal[at:at+4]: position(3), radius."""
    lp, radius = scal[at:at + 3], scal[at + 3]
    e0 = (lp[0] - so[0], lp[1] - so[1], lp[2] - so[2])
    basis = lane_axis_onb(*e0)
    return lambda u1, u2: _disk_ray(u1, u2, e0, basis, radius, hitm)


def closest_soft_shadow_reference(rays, nodes, tris, at0, at1, scal, *,
                                  leaf_size: int, spp: int, seed: int,
                                  zero_stream: bool, t_min: float,
                                  max_iters: int, stack_size: int,
                                  stats=None):
    """Plain version of ``_closest_soft_shadow_kernel_w8_b``: phase 1, then
    spp cone samples around the sun axis. scal f32[17]: axis(3), basis
    t0(3), t1(3), cone_cos, root min(3), root max(3), bias. -> (out, counts
    i32[PB,8,128] in [0, spp], walk counts i32[2])."""
    ph = _Phase1(rays, nodes, tris, at0, at1, leaf_size, t_min, max_iters,
                 stack_size, stats)
    so = ph.origin(scal[16])
    sample = _cone_sampler(scal, 0, scal[10:13], scal[13:16], so, ph.hitm)
    cnt = _sampled_counts(ph, so, spp, seed, zero_stream, sample)
    return ph.out, ph.image(cnt), ph.counts()


def closest_point_soft_shadow_reference(rays, nodes, tris, at0, at1, scal,
                                        *, leaf_size: int, spp: int,
                                        seed: int, zero_stream: bool,
                                        t_min: float, max_iters: int,
                                        stack_size: int, stats=None):
    """Plain version of ``_closest_psoft_shadow_kernel_w8_b``: phase 1,
    then spp jittered-disk samples on a point light, in a per-ray Duff
    basis around the axis to the light's centre. scal f32[5]: position(3),
    radius, bias. -> (out, counts, walk counts)."""
    ph = _Phase1(rays, nodes, tris, at0, at1, leaf_size, t_min, max_iters,
                 stack_size, stats)
    so = ph.origin(scal[4])
    sample = _disk_sampler(scal, 0, so, ph.hitm)
    cnt = _sampled_counts(ph, so, spp, seed, zero_stream, sample)
    return ph.out, ph.image(cnt), ph.counts()


def _soft_multi_scal_len(disk: bool, n_extra: int) -> int:
    return 7 + (4 if disk else 10) + 6 * n_extra


def closest_soft_multi_shadow_reference(rays, nodes, tris, at0, at1, scal,
                                        *, leaf_size: int, spp: int,
                                        seed: int, zero_stream: bool,
                                        disk: bool, n_extra: int,
                                        t_min: float, max_iters: int,
                                        stack_size: int, stats=None):
    """Plain version of ``_closest_soft_multi_shadow_kernel_w8_b``: phase
    1; light 0 soft (``disk``: jittered disk, else cone) -> counts; one
    hard walk per extra directional light -> mask (bit i = extra light i).
    scal: [bias, root min(3), root max(3)], light 0 (disk: position(3),
    radius; cone: axis(3), t0(3), t1(3), cone_cos), then per extra light
    direction(3) and clamped inverse(3). -> (out, counts, mask, walk
    counts)."""
    if n_extra:
        _check_mask_lights(n_extra)
    ph = _Phase1(rays, nodes, tris, at0, at1, leaf_size, t_min, max_iters,
                 stack_size, stats)
    so = ph.origin(scal[0])
    rmin, rmax = scal[1:4], scal[4:7]
    if disk:
        sample, base = _disk_sampler(scal, 7, so, ph.hitm), 11
    else:
        sample, base = _cone_sampler(scal, 7, rmin, rmax, so, ph.hitm), 17
    cnt = _sampled_counts(ph, so, spp, seed, zero_stream, sample)
    mask = torch.zeros(ph.n, dtype=torch.int32, device=rays.device)
    for li in range(n_extra):
        s = base + 6 * li
        ray = _dir_ray(scal[s:s + 3], scal[s + 3:s + 6], rmin, rmax, so,
                       ph.hitm)
        mask |= ph.occluded(so, ray).to(torch.int32) << li
    return ph.out, ph.image(cnt), ph.image(mask), ph.counts()


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


class Params(ctypes.Structure):
    """One launch's arguments: ``Params`` of csrc/fused_shadows.cu, field
    for field (the loader checks the two sizes agree)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "nodes", "tris", "at0", "at1", "rays", "scal", "out", "cnt_out",
        "mask_out", "counts")]
        + [(n, ctypes.c_int) for n in ("num_rays", "k", "max_iters",
                                       "stack_size")]
        + [("t_min", ctypes.c_float)]
        + [(n, ctypes.c_int) for n in ("nlights", "point_mask", "spp",
                                       "zero_stream", "disk", "n_extra")]
        + [("seed", ctypes.c_uint32)])


# The kernel template's modes (csrc/fused_shadows.cu ``Mode``).
HARD, MULTI, SOFT, PSOFT, SOFT_MULTI = range(5)


def _launch(mode: int, outputs, rays, nodes, tris, at0, at1, scal, *,
            leaf_size: int, t_min: float, max_iters: int, stack_size: int,
            scal_len: int, **extra):
    """Check a fused launch's inputs, allocate its outputs, launch ``mode``
    on the current stream. outputs: the i32[PB,8,128] blocks to return,
    a tuple of "cnt_out" / "mask_out". extra: the mode's Params fields.
    -> (out, *outputs, counts); raises on a refused launch."""
    from ._build import load_library
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {dev}")
    k = int(leaf_size)
    if not 1 <= k <= 14:
        raise ValueError(f"leaf_size {k} outside 1..14")
    if not 1 <= stack_size <= STACK_CAPACITY:
        raise ValueError(f"stack_size {stack_size} outside 1..{STACK_CAPACITY}")
    pb = rays.shape[0]
    nl = tris.shape[0]
    _check(rays, "rays", torch.float32, (pb, 10, 8, 128), dev)
    _check(nodes, "nodes", torch.float32, (nodes.shape[0], 128), dev)
    _check(tris, "tris", torch.float32, (nl, 128), dev)
    _check(at0, "at0", torch.float32, (nl, 128), dev)
    _check(at1, "at1", torch.float32, ((nl if k > 8 else 1), 128), dev)
    _check(scal, "scal", torch.float32, (scal_len,), dev)
    lib = load_library()
    out = torch.empty((pb, ATTR_CH, 8, 128), dtype=torch.float32, device=dev)
    blocks = [torch.empty((pb, 8, 128), dtype=torch.int32, device=dev)
              for _ in outputs]
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    params = Params(
        nodes=nodes.data_ptr(), tris=tris.data_ptr(), at0=at0.data_ptr(),
        at1=at1.data_ptr(), rays=rays.data_ptr(), scal=scal.data_ptr(),
        out=out.data_ptr(), counts=counts.data_ptr(), num_rays=pb * LANES,
        k=k, max_iters=int(max_iters), stack_size=int(stack_size),
        t_min=float(t_min),
        **{name: b.data_ptr() for name, b in zip(outputs, blocks)}, **extra)
    err = lib.tpurt_fused_shadows_launch(
        mode, ctypes.byref(params), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused kernel mode {mode} launch failed: CUDA "
                           f"error {err}")
    return (out, *blocks, counts)


def _sampling(spp: int, seed: int, zero_stream: bool) -> dict:
    """The sampling modes' Params fields."""
    if spp < 1:
        raise ValueError(f"spp {spp} < 1")
    return dict(spp=int(spp), seed=int(seed) & 0xFFFFFFFF,
                zero_stream=int(zero_stream))


# Each *_cuda launches one mode of csrc/fused_shadows.cu, with the contract
# of its *_reference; it takes CUDA tensors only, builds the kernel library
# on first use, raises on anything the kernel does not take and on a
# refused launch, and counts its launches in ``.launches``.

def closest_shadow_cuda(rays, nodes, tris, at0, at1, scal, *,
                        leaf_size: int, point: bool, t_min: float,
                        max_iters: int, stack_size: int):
    """Mode HARD: light 0's hard shadow."""
    res = _launch(HARD, ("mask_out",), rays, nodes, tris, at0, at1, scal,
                  leaf_size=leaf_size, t_min=t_min, max_iters=max_iters,
                  stack_size=stack_size, scal_len=4 if point else 13,
                  nlights=1, point_mask=int(bool(point)))
    closest_shadow_cuda.launches += 1
    return res


def closest_multi_shadow_cuda(rays, nodes, tris, at0, at1, scal, *,
                              leaf_size: int, points, t_min: float,
                              max_iters: int, stack_size: int):
    """Mode MULTI: one hard shadow per light."""
    _check_mask_lights(len(points))
    res = _launch(MULTI, ("mask_out",), rays, nodes, tris, at0, at1, scal,
                  leaf_size=leaf_size, t_min=t_min, max_iters=max_iters,
                  stack_size=stack_size, scal_len=_multi_scal_len(points),
                  nlights=len(points),
                  point_mask=sum(1 << i for i, p in enumerate(points) if p))
    closest_multi_shadow_cuda.launches += 1
    return res


def closest_soft_shadow_cuda(rays, nodes, tris, at0, at1, scal, *,
                             leaf_size: int, spp: int, seed: int,
                             zero_stream: bool, t_min: float,
                             max_iters: int, stack_size: int):
    """Mode SOFT: spp cone samples of a sun."""
    res = _launch(SOFT, ("cnt_out",), rays, nodes, tris, at0, at1, scal,
                  leaf_size=leaf_size, t_min=t_min, max_iters=max_iters,
                  stack_size=stack_size, scal_len=17,
                  **_sampling(spp, seed, zero_stream))
    closest_soft_shadow_cuda.launches += 1
    return res


def closest_point_soft_shadow_cuda(rays, nodes, tris, at0, at1, scal, *,
                                   leaf_size: int, spp: int, seed: int,
                                   zero_stream: bool, t_min: float,
                                   max_iters: int, stack_size: int):
    """Mode PSOFT: spp disk samples of a point light."""
    res = _launch(PSOFT, ("cnt_out",), rays, nodes, tris, at0, at1, scal,
                  leaf_size=leaf_size, t_min=t_min, max_iters=max_iters,
                  stack_size=stack_size, scal_len=5,
                  **_sampling(spp, seed, zero_stream))
    closest_point_soft_shadow_cuda.launches += 1
    return res


def closest_soft_multi_shadow_cuda(rays, nodes, tris, at0, at1, scal, *,
                                   leaf_size: int, spp: int, seed: int,
                                   zero_stream: bool, disk: bool,
                                   n_extra: int, t_min: float,
                                   max_iters: int, stack_size: int):
    """Mode SOFT_MULTI: soft light 0 plus hard directional extras."""
    if n_extra:
        _check_mask_lights(n_extra)
    res = _launch(SOFT_MULTI, ("cnt_out", "mask_out"), rays, nodes, tris,
                  at0, at1, scal, leaf_size=leaf_size, t_min=t_min,
                  max_iters=max_iters, stack_size=stack_size,
                  scal_len=_soft_multi_scal_len(disk, n_extra),
                  disk=int(bool(disk)), n_extra=int(n_extra),
                  **_sampling(spp, seed, zero_stream))
    closest_soft_multi_shadow_cuda.launches += 1
    return res


CUDA_KERNELS = (closest_shadow_cuda, closest_multi_shadow_cuda,
                closest_soft_shadow_cuda, closest_point_soft_shadow_cuda,
                closest_soft_multi_shadow_cuda)
for _fn in CUDA_KERNELS:
    _fn.launches = 0


# ---------------------------------------------------------------------------
# Inputs and wrappers
# ---------------------------------------------------------------------------

def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _dir_scalars(ld, device):
    """Toward-light direction(3) and its clamped inverse(3)."""
    d = _f32(ld, device)
    return [d, torch.clamp(1.0 / d, -_BIG, _BIG)]


def _root_box(bvh: WideBVH):
    return [bvh.root_min.to(torch.float32), bvh.root_max.to(torch.float32)]


def _cone_scalars(axis_dir, cone_cos, device):
    """Cone axis(3), its Duff basis t0(3), t1(3), cone_cos."""
    axis = _f32(axis_dir, device)
    t0, t1 = onb3(axis)
    return [axis, t0, t1, _f32([cone_cos], device)]


def _shadow_scalars(bvh: WideBVH, light_dir, bias, light_pos, device):
    """f32[4] (point: position, bias) or f32[13] (directional: dir,
    clamped 1/dir, bias, root box min, max)."""
    b = _f32([bias], device)
    if light_pos is not None:
        return torch.cat([_f32(light_pos, device), b])
    return torch.cat(_dir_scalars(light_dir, device) + [b]
                     + _root_box(bvh))


def _fused_inputs(bvh: WideBVH, origins, dirs, attr_tables, t_max, t_min,
                  stack_size, scal_fn, **kw):
    """Pack image rays for a fused kernel -> (args, kwargs, p, meta):
    ``kernel(*args, **kwargs)`` or its plain version; ``p`` and ``meta``
    unpack the outputs. ``scal_fn(device)`` makes the scalar block."""
    rays, p, meta = _ray_packets_packed(origins, dirs, t_max, batch=1)
    args = (rays, bvh.nodes, bvh.tris, attr_tables[0], attr_tables[1],
            scal_fn(rays.device))
    kwargs = dict(leaf_size=bvh.leaf_size, t_min=float(t_min),
                  max_iters=iter_cap(bvh.num_wide), stack_size=stack_size,
                  **kw)
    return args, kwargs, p, meta


def closest_shadow_inputs(bvh: WideBVH, origins, dirs, light_dir, bias,
                          attr_tables, t_max=_BIG, t_min: float = 0.0,
                          light_pos=None, stack_size: int = STACK_CAPACITY):
    """Inputs of ``closest_shadow_cuda`` / ``closest_shadow_reference``."""
    return _fused_inputs(
        bvh, origins, dirs, attr_tables, t_max, t_min, stack_size,
        lambda dev: _shadow_scalars(bvh, light_dir, bias, light_pos, dev),
        point=light_pos is not None)


def closest_multi_shadow_inputs(bvh: WideBVH, origins, dirs, lights, bias,
                                attr_tables, t_max=_BIG, t_min: float = 0.0,
                                stack_size: int = STACK_CAPACITY):
    """Inputs of the multi-light kernel. lights: (light_dir, light_pos)
    pairs, exactly one of each pair not None."""
    _check_mask_lights(len(lights))
    points = tuple(lp is not None for _, lp in lights)

    def scal(dev):
        blocks = [_f32([bias], dev)] + _root_box(bvh)
        for ld, lp in lights:
            blocks += [_f32(lp, dev)] if lp is not None \
                else _dir_scalars(ld, dev)
        return torch.cat(blocks)
    return _fused_inputs(bvh, origins, dirs, attr_tables, t_max, t_min,
                         stack_size, scal, points=points)


def closest_soft_shadow_inputs(bvh: WideBVH, origins, dirs, axis_dir,
                               cone_cos, spp: int, seed: int, bias,
                               attr_tables, t_max=_BIG, t_min: float = 0.0,
                               zero_stream: bool = False,
                               stack_size: int = STACK_CAPACITY):
    """Inputs of the cone kernel (scal f32[17])."""
    return _fused_inputs(
        bvh, origins, dirs, attr_tables, t_max, t_min, stack_size,
        lambda dev: torch.cat(_cone_scalars(axis_dir, cone_cos, dev)
                              + _root_box(bvh) + [_f32([bias], dev)]),
        spp=int(spp), seed=int(seed), zero_stream=bool(zero_stream))


def closest_point_soft_shadow_inputs(bvh: WideBVH, origins, dirs, light_pos,
                                     radius, spp: int, seed: int, bias,
                                     attr_tables, t_max=_BIG,
                                     t_min: float = 0.0,
                                     zero_stream: bool = False,
                                     stack_size: int = STACK_CAPACITY):
    """Inputs of the disk kernel (scal f32[5])."""
    return _fused_inputs(
        bvh, origins, dirs, attr_tables, t_max, t_min, stack_size,
        lambda dev: torch.cat([_f32(light_pos, dev),
                               _f32([radius, bias], dev)]),
        spp=int(spp), seed=int(seed), zero_stream=bool(zero_stream))


def closest_soft_multi_shadow_inputs(bvh: WideBVH, origins, dirs, light0,
                                     extra_dirs, spp: int, seed: int, bias,
                                     attr_tables, t_max=_BIG,
                                     t_min: float = 0.0,
                                     zero_stream: bool = False,
                                     stack_size: int = STACK_CAPACITY):
    """Inputs of the soft-plus-extras kernel. light0: ("cone", axis,
    cone_cos) or ("disk", position, radius); extra_dirs: toward-light
    directions of the hard extras."""
    kind, vec, scalar = light0
    if kind not in ("cone", "disk"):
        raise ValueError(f"light 0 kind {kind!r}, expected 'cone' or 'disk'")
    if extra_dirs:
        _check_mask_lights(len(extra_dirs))

    def scal(dev):
        blocks = [_f32([bias], dev)] + _root_box(bvh)
        blocks += [_f32(vec, dev), _f32([scalar], dev)] if kind == "disk" \
            else _cone_scalars(vec, scalar, dev)
        for ld in extra_dirs:
            blocks += _dir_scalars(ld, dev)
        return torch.cat(blocks)
    return _fused_inputs(bvh, origins, dirs, attr_tables, t_max, t_min,
                         stack_size, scal, spp=int(spp), seed=int(seed),
                         zero_stream=bool(zero_stream), disk=kind == "disk",
                         n_extra=len(extra_dirs))


def _pick(device: torch.device, cuda_fn, plain_fn):
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if device.type == "cuda":
        return cuda_fn
    if device.type == "cpu":
        return plain_fn
    raise ValueError(f"unsupported device {device}")


def _need_attrs(attr_tables) -> None:
    if attr_tables is None:
        raise NotImplementedError(
            "the attrs=0 variant (t/sidx outputs) is not ported")


def trace_closest_shadow(bvh: WideBVH, origins, dirs, light_dir, bias,
                         t_max=_BIG, t_min: float = 0.0, light_pos=None,
                         attr_tables=None, stack_size: int = STACK_CAPACITY):
    """Fused primary visibility + light-0 hard shadow (ONE kernel launch).

    origins/dirs f32[H, W, 3]; light_dir f32[3] toward the light (used when
    ``light_pos`` is None); light_pos f32[3] for a hard point light; bias:
    the normal-offset shadow bias; attr_tables (at0, at1): the leaf
    attribute rows. Returns (channel dict, occluded bool[H, W], counts
    i32[2]). CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    _need_attrs(attr_tables)
    fn = _pick(origins.device, closest_shadow_cuda, closest_shadow_reference)
    args, kwargs, p, meta = closest_shadow_inputs(
        bvh, origins, dirs, light_dir, bias, attr_tables, t_max, t_min,
        light_pos, stack_size)
    out, occ, counts = fn(*args, **kwargs)
    occ = _unpack(occ[:p], meta)
    return _attr_channels(out, p, meta), occ > 0, counts


def trace_closest_multi_shadow(bvh: WideBVH, origins, dirs, lights, bias,
                               t_max=_BIG, t_min: float = 0.0,
                               attr_tables=None,
                               stack_size: int = STACK_CAPACITY):
    """Fused primary visibility + N hard shadows (ONE kernel launch).
    lights: (light_dir, light_pos) pairs as ``tpurt``'s
    ``trace_closest_multi_shadow_pallas`` takes them (at most 31). Returns
    (channel dict, occ_mask i32[H, W] with bit l = light l occluded,
    counts i32[2])."""
    _need_attrs(attr_tables)
    fn = _pick(origins.device, closest_multi_shadow_cuda,
               closest_multi_shadow_reference)
    args, kwargs, p, meta = closest_multi_shadow_inputs(
        bvh, origins, dirs, lights, bias, attr_tables, t_max, t_min,
        stack_size)
    out, mask, counts = fn(*args, **kwargs)
    return _attr_channels(out, p, meta), _unpack(mask[:p], meta), counts


def trace_closest_soft_shadow(bvh: WideBVH, origins, dirs, axis_dir,
                              cone_cos, spp: int, seed: int, bias,
                              t_max=_BIG, t_min: float = 0.0,
                              attr_tables=None, zero_stream: bool = False,
                              stack_size: int = STACK_CAPACITY):
    """Fused primary visibility + area-light (cone) soft shadows (ONE
    kernel launch). Returns (channel dict, occlusion counts i32[H, W] in
    [0, spp], walk counts i32[2]); visibility = 1 - counts / spp."""
    _need_attrs(attr_tables)
    fn = _pick(origins.device, closest_soft_shadow_cuda,
               closest_soft_shadow_reference)
    args, kwargs, p, meta = closest_soft_shadow_inputs(
        bvh, origins, dirs, axis_dir, cone_cos, spp, seed, bias,
        attr_tables, t_max, t_min, zero_stream, stack_size)
    out, cnt, counts = fn(*args, **kwargs)
    return _attr_channels(out, p, meta), _unpack(cnt[:p], meta), counts


def trace_closest_point_soft_shadow(bvh: WideBVH, origins, dirs, light_pos,
                                    radius, spp: int, seed: int, bias,
                                    t_max=_BIG, t_min: float = 0.0,
                                    attr_tables=None,
                                    zero_stream: bool = False,
                                    stack_size: int = STACK_CAPACITY):
    """Fused primary visibility + point-light penumbra (ONE kernel
    launch). Returns (channel dict, counts i32[H, W] in [0, spp], walk
    counts i32[2])."""
    _need_attrs(attr_tables)
    fn = _pick(origins.device, closest_point_soft_shadow_cuda,
               closest_point_soft_shadow_reference)
    args, kwargs, p, meta = closest_point_soft_shadow_inputs(
        bvh, origins, dirs, light_pos, radius, spp, seed, bias, attr_tables,
        t_max, t_min, zero_stream, stack_size)
    out, cnt, counts = fn(*args, **kwargs)
    return _attr_channels(out, p, meta), _unpack(cnt[:p], meta), counts


def trace_closest_soft_multi_shadow(bvh: WideBVH, origins, dirs, light0,
                                    extra_dirs, spp: int, seed: int, bias,
                                    t_max=_BIG, t_min: float = 0.0,
                                    attr_tables=None,
                                    zero_stream: bool = False,
                                    stack_size: int = STACK_CAPACITY):
    """Fused primary + soft light 0 + hard directional extras (ONE kernel
    launch). light0: ("cone", axis, cone_cos) or ("disk", position,
    radius). Returns (channel dict, counts0 i32[H, W], occ_mask i32[H, W]
    with bit i = extra light i, walk counts i32[2])."""
    _need_attrs(attr_tables)
    fn = _pick(origins.device, closest_soft_multi_shadow_cuda,
               closest_soft_multi_shadow_reference)
    args, kwargs, p, meta = closest_soft_multi_shadow_inputs(
        bvh, origins, dirs, light0, extra_dirs, spp, seed, bias, attr_tables,
        t_max, t_min, zero_stream, stack_size)
    out, cnt, mask, counts = fn(*args, **kwargs)
    return (_attr_channels(out, p, meta), _unpack(cnt[:p], meta),
            _unpack(mask[:p], meta), counts)
