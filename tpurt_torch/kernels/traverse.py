"""Fused closest hit + light-0 hard shadow over the 8-wide BVH (counterpart
of ``tpurt/kernels/traverse.py`` ``trace_closest_shadow_pallas`` ->
``_closest_shadow_kernel_w8_b``).

Three pieces share one contract on the packed ray block:

- ``closest_shadow_cuda``: the hand-written CUDA kernel
  (``csrc/closest_shadow.cu``), one thread per ray. It takes CUDA tensors
  only and launches or raises.
- ``closest_shadow_reference``: the same function in plain PyTorch, a
  vectorised per-ray stack walk. The wrapper takes it only for CPU tensors.
- ``trace_closest_shadow``: the wrapper the frame calls. It packs the
  rays, picks one of the two by the tensors' device, and decodes the
  attribute channels.

Both walks return ``counts`` i32[2]: pushes dropped because the per-ray
stack was full, and walks cut at the iteration cap. A correct walk leaves
both at zero; ``check_walk_counts`` raises otherwise.

The layouts at the kernel boundary are the JAX package's: nodes
f32[Nw,128], leaf rows f32[L,128], attribute rows f32[nblk,128], rays
f32[PB,10,8,128] (o, d, clamped 1/d, t_max), outputs f32[PB,15,8,128]
attribute channels and i32[PB,8,128] occlusion.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..bvh.wide import WideBVH

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


def _leaf_occluded(tri, o, d, t_min, tmax):
    """Division-free occlusion test of n rays x k triangles -> bool[n]."""
    det, nu, nv, nt = _mt_terms(tri, o, d)
    sgn = torch.where(det < 0.0, -1.0, 1.0)
    adet = det * sgn
    nu = nu * sgn
    nv = nv * sgn
    nt = nt * sgn
    tm = tmax[:, None]
    ok = ((adet >= 1e-9) & (nu >= 0.0) & (nv >= 0.0) & (nu + nv <= adet)
          & (nt > t_min * adet) & (nt < tm * adet))
    return ok.any(dim=1)


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


def _closest_walk(nodes, tris, at0, at1, k, o, d, inv, tmax, t_min,
                  max_iters, stack_size):
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
        cap = torch.where(active0[rows], best_t[rows], -_BIG)
        ro = tuple(c[rows] for c in o)
        hit = _slab8(rec, ro, tuple(c[rows] for c in inv), t_min, cap)
        refs = rec[:, :, 6].to(torch.int32)
        for c in range(8):
            leaf_m = hit[:, c] & (refs[:, c] < 0)
            if bool(leaf_m.any()):
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
                 stack_size):
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
                h = _leaf_occluded(_leaf_tris(tris, leaf, k),
                                   tuple(x[r] for x in o),
                                   tuple(x[r] for x in d), t_min, tmax[r])
                occ[r] = h
                done[leaf_m] = h
            push_m = hit[:, c] & (refs[:, c] >= 0) & ~done
            if bool(push_m.any()):
                w.push(rows[push_m], refs[push_m, c])
        w.it[rows] += 1
    capped = ((w.sp > 0) & ~occ).sum().to(torch.int32)
    return occ, w.overflow, capped


def _shadow_rays(scal, point, o, d, best_t, best_i, gn):
    """Phase 2 ray per hit: origin pushed by the bias along the unit
    geometric normal turned toward the viewer; t capped at the root-box
    exit x 1.0001 (directional) or the light distance x (1 - 1e-4)
    (point). Lanes with no hit get t_max = -BIG."""
    nx, ny, nz = gn
    ox, oy, oz = o
    dx, dy, dz = d
    hitm = best_i >= 0
    bias = scal[3] if point else scal[6]
    rn = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                      min=1e-30))
    flip = torch.where(nx * dx + ny * dy + nz * dz > 0.0, -1.0, 1.0)
    off = bias * rn * flip
    so = (ox + best_t * dx + nx * off, oy + best_t * dy + ny * off,
          oz + best_t * dz + nz * off)
    if point:
        e = (scal[0] - so[0], scal[1] - so[1], scal[2] - so[2])
        d2 = torch.clamp(e[0] * e[0] + e[1] * e[1] + e[2] * e[2], min=1e-24)
        drn = 1.0 / torch.sqrt(d2)
        sd = tuple(x * drn for x in e)
        sinv = tuple(torch.clamp(1.0 / x, -_BIG, _BIG) for x in sd)
        stmax = torch.where(hitm, d2 * drn * (1.0 - 1e-4), -_BIG)
    else:
        n = best_t.shape[0]
        sd = tuple(scal[a].expand(n) for a in range(3))
        sinv = tuple(scal[3 + a].expand(n) for a in range(3))
        ex = None
        for a in range(3):
            t0 = (scal[7 + a] - so[a]) * sinv[a]
            t1 = (scal[10 + a] - so[a]) * sinv[a]
            m = torch.maximum(t0, t1)
            ex = m if ex is None else torch.minimum(ex, m)
        stmax = torch.where(hitm, torch.clamp(ex, min=0.0) * 1.0001, -_BIG)
    return so, sd, sinv, stmax


def closest_shadow_reference(rays, nodes, tris, at0, at1, scal, *,
                             leaf_size: int, point: bool, t_min: float,
                             max_iters: int, stack_size: int):
    """Plain PyTorch version of the fused kernel, on any device.

    rays f32[PB,10,8,128] -> (out f32[PB,15,8,128], occ i32[PB,8,128],
    counts i32[2]). Each ray walks its own stack [N, stack_size]; the loop
    runs until every stack is empty. Children of a popped node are tested
    against the cap at pop time and handled in slot order (leaf tests in
    place, internal children pushed), as the kernel does."""
    pb = rays.shape[0]
    comp = rays.reshape(pb, 10, LANES).permute(1, 0, 2).reshape(10, -1)
    o, d, inv, tmax = (comp[0], comp[1], comp[2]), \
        (comp[3], comp[4], comp[5]), (comp[6], comp[7], comp[8]), comp[9]
    k = leaf_size
    best_t, best_i, attr, ovf1, cap1 = _closest_walk(
        nodes, tris, at0, at1, k, o, d, inv, tmax, t_min, max_iters,
        stack_size)
    n = tmax.shape[0]
    zero = torch.zeros(n, dtype=torch.float32, device=tmax.device)
    chans = [torch.where(best_i >= 0, best_t, _BIG), best_i.to(torch.float32),
             attr[:, 0], attr[:, 1], zero, zero, attr[:, 2], zero,
             attr[:, 3], attr[:, 4], attr[:, 5], attr[:, 6],
             attr[:, 7], attr[:, 8], attr[:, 9]]
    out = torch.stack(chans).reshape(ATTR_CH, pb, 8, 128).permute(1, 0, 2, 3)
    gn = (attr[:, 7], attr[:, 8], attr[:, 9])
    so, sd, sinv, stmax = _shadow_rays(scal, point, o, d, best_t, best_i, gn)
    occ, ovf2, cap2 = _anyhit_walk(nodes, tris, k, so, sd, sinv, stmax, 0.0,
                                   max_iters, stack_size)
    occ = occ.to(torch.int32).reshape(pb, 8, 128)
    counts = torch.stack([ovf1 + ovf2, cap1 + cap2]).to(torch.int32)
    return out.contiguous(), occ, counts


# ---------------------------------------------------------------------------
# The CUDA kernel
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


def closest_shadow_cuda(rays, nodes, tris, at0, at1, scal, *,
                        leaf_size: int, point: bool, t_min: float,
                        max_iters: int, stack_size: int):
    """Launch the CUDA kernel (csrc/closest_shadow.cu) on the current
    stream; same contract as ``closest_shadow_reference``. Builds the
    kernel library on first use. Raises on anything the kernel does not
    take and on a refused launch."""
    from ._build import load_library
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(f"closest_shadow_cuda needs CUDA tensors, got {dev}")
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
    _check(scal, "scal", torch.float32, ((4 if point else 13),), dev)
    lib = load_library()
    out = torch.empty((pb, ATTR_CH, 8, 128), dtype=torch.float32, device=dev)
    occ = torch.empty((pb, 8, 128), dtype=torch.int32, device=dev)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.tpurt_closest_shadow_launch(
        nodes.data_ptr(), tris.data_ptr(), at0.data_ptr(), at1.data_ptr(),
        rays.data_ptr(), scal.data_ptr(), out.data_ptr(), occ.data_ptr(),
        counts.data_ptr(), pb * LANES, k, int(point), ctypes.c_float(t_min),
        int(max_iters), int(stack_size), stream)
    if err != 0:
        raise RuntimeError(f"closest_shadow kernel launch failed: CUDA error "
                           f"{err}")
    closest_shadow_cuda.launches += 1
    return out, occ, counts


closest_shadow_cuda.launches = 0


def _shadow_scalars(bvh: WideBVH, light_dir, bias, light_pos, device):
    """f32[4] (point: position, bias) or f32[13] (directional: dir,
    clamped 1/dir, bias, root box min, max)."""
    b = torch.tensor([float(bias)], dtype=torch.float32, device=device)
    if light_pos is not None:
        lp = torch.as_tensor(np.asarray(light_pos, np.float32), device=device)
        return torch.cat([lp, b])
    ld = torch.as_tensor(np.asarray(light_dir, np.float32), device=device)
    inv = torch.clamp(1.0 / ld, -_BIG, _BIG)
    return torch.cat([ld, inv, b, bvh.root_min.to(torch.float32),
                      bvh.root_max.to(torch.float32)])


def closest_shadow_inputs(bvh: WideBVH, origins, dirs, light_dir, bias,
                          attr_tables, t_max=_BIG, t_min: float = 0.0,
                          light_pos=None, stack_size: int = STACK_CAPACITY):
    """Pack image rays for the kernel contract -> (args, kwargs, p, meta):
    ``closest_shadow_cuda(*args, **kwargs)`` or the plain version; ``p``
    and ``meta`` unpack the outputs."""
    rays, p, meta = _ray_packets_packed(origins, dirs, t_max, batch=1)
    scal = _shadow_scalars(bvh, light_dir, bias, light_pos, rays.device)
    args = (rays, bvh.nodes, bvh.tris, attr_tables[0], attr_tables[1], scal)
    kwargs = dict(leaf_size=bvh.leaf_size, point=light_pos is not None,
                  t_min=float(t_min), max_iters=iter_cap(bvh.num_wide),
                  stack_size=stack_size)
    return args, kwargs, p, meta


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
    if attr_tables is None:
        raise NotImplementedError(
            "the attrs=0 variant (t/sidx/occ outputs) is not ported")
    dev = origins.device
    if dev.type == "cuda":
        fn = closest_shadow_cuda
    elif dev.type == "cpu":
        fn = closest_shadow_reference
    else:
        raise ValueError(f"unsupported device {dev}")
    args, kwargs, p, meta = closest_shadow_inputs(
        bvh, origins, dirs, light_dir, bias, attr_tables, t_max, t_min,
        light_pos, stack_size)
    out, occ, counts = fn(*args, **kwargs)
    occ = _unpack(occ[:p], meta)
    return _attr_channels(out, p, meta), occ > 0, counts
