"""The traversals over the 8-wide BVH (counterparts of
``tpurt/kernels/traverse.py``). The fused closest-hit + shadow kernels:

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

Each of the five takes the leaf attribute rows (attrs=1: the winner's
attribute channels; with ``textured=True`` attrs=2, which adds the
winner's interpolated uv and its texture layer) or none (attrs=0,
``attr_tables=None``: t and the sorted index, the keys of the shade
table).

The unfused frame's kernels:

- ``trace_closest_attrs`` -> ``_closest_attr_kernel_w8_b``: the closest
  hit and its attribute channels alone (``textured`` as above);
- ``trace_closest`` -> ``_closest_hit_kernel_w8_b``: the closest hit
  alone, t and the sorted index (the shade-table G-buffer); with
  ``seeded=True`` first ``_first_hit_kernel_w8_b``, whose first hit caps
  each ray's t_max for the closest hit (the seeded G-buffer);
- ``trace_any`` -> ``_any_hit_kernel_w8_b``: any hit of given rays;
- ``trace_any_soft`` -> ``_any_hit_kernel_w8_soft`` and
  ``trace_any_point_soft`` -> ``_any_hit_kernel_w8_psoft``: spp cone or
  disk samples from given biased origins, counts.

Over the packed binary LBVH (``kernels/pack.py``; ``bvh_width=2`` and a
plain ``build_lbvh`` tree) ``trace_closest`` and ``trace_any`` take the
binary walks instead:

- ``trace_closest`` -> ``_closest_hit_kernel``: t and the sorted index;
- ``trace_any`` -> ``_any_hit_kernel``: any hit of given rays.

Over a WideBVHT (``bvh/wide.py``: the same nodes, the leaf triangles
transposed, leaf_size 8 or 16) the w8t walks:

- ``trace_closest`` -> ``_closest_hit_kernel_w8t``: t and the sorted
  index (``seeded`` is ignored, as in ``tpurt``);
- ``trace_any`` -> ``_any_hit_kernel_w8t``: any hit of given rays;
- ``trace_closest_attrs_t`` -> ``_closest_attr_kernel_w8t_b``: the
  closest hit and its attribute channels from the transposed attribute
  rows (``textured`` as above; untextured, the layer channel is -1).

``trace_any`` and ``trace_closest`` take ``tpurt``'s ``variant=``: the
retired variants it selects (the unbatched and dual-pop 8-wide walks, the
packet-frustum binary walks) compute the functions of the modes above and
launch them (ROADMAP decision 23). The per-packet stats walk
(``trace_any_pallas_stats``) is ``_variants.trace_any_stats``.

The first five (both variants), ``trace_closest_attrs`` and
``trace_closest``'s two walks are modes of one CUDA kernel template
(``csrc/fused_shadows.cu``), the three shadow-ray kernels modes of another
(``csrc/shadow_rays.cu``), the two binary walks modes of a third
(``csrc/binary.cu``), the w8t walks modes of a fourth
(``csrc/transposed.cu``). Each function has three pieces that share one
contract on the packed ray block:

- ``*_cuda``: the hand-written CUDA kernel in its mode, one thread per
  ray. It takes CUDA tensors only and launches or raises; ``.launches``
  counts its launches. The attrs=0 variants of the five fused modes are
  ``*_st_cuda`` (no attribute tables in their arguments), the attrs=2
  variants of those and of CLOSEST ``*_tex_cuda``.
- ``*_reference``: the same function in plain PyTorch, a vectorised
  per-ray stack walk. The wrapper takes it only for CPU tensors.
- ``trace_*``: the wrapper the frame calls. It packs the rays, picks one
  of the two by the tensors' device, and decodes the attribute channels.

``WALK_KERNELS`` holds one row per kernel: its entry point and mode, what
the launch takes and returns, and its plain version; one factory makes
every ``*_cuda`` from its row. The five fused wrappers are one launch
(``_fused_launch``, a ``FusedLaunch`` of the outputs as written) and one
unpacking (``FusedLaunch.unpacked``).

All walks return ``counts`` i32[2]: pushes dropped because the per-ray
stack was full, and walks cut at the iteration cap, summed over phase 1
and every shadow walk. A correct frame leaves both at zero;
``check_walk_counts`` raises otherwise. The soft samplers draw from the
counter-based generator of ``sampling.py``; their ``seed`` is an int or
the frame block's one-element int32 view of the frame seed
(``frame_block.py``), which the kernels read through a pointer, so that
a launch captured into a CUDA graph reads each replay's seed. The
wrappers' light, bias and radius arguments take host data or the
block's views alike.

The layouts at the kernel boundary are the JAX package's: nodes
f32[Nw,128] (binary: f32[Nr,128], 8 records per row), leaf rows
f32[L,128], attribute rows f32[nblk,128], rays
f32[PB,10,8,128] (o, d, clamped 1/d, t_max), soft-shadow origins
f32[PB,4,8,128] (o, valid flag), the float32 scalar blocks of the JAX
wrappers, outputs f32[PB,15,8,128] attribute channels (attrs=1) or t
f32[PB,8,128] and sorted index i32[PB,8,128] (attrs=0), and i32[PB,8,128]
occlusion, mask or counts.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..bvh.lbvh import LBVH
from ..bvh.wide import WideBVH, WideBVHT, leaves_per_block
from ..camera import as_f32
from ._build import _check, _pick, _stream
from .pack import NODE_STRIDE, PackedBVH, pack_bvh
from .sampling import (lane_axis_onb, onb3, rsqrt, sample_uniforms,
                       seed_arg, sincos_2pi)

TILE = 32          # 32x32 pixel tile -> one (8, 128) packet
_BIG = 3.4e38
ATTR_CH = 15
LANES = 8 * 128
# Per-ray stack entries compiled into the CUDA kernel (csrc STACK_CAPACITY).
# An 8-wide tree of D internal levels needs at most 7*D + 1.
STACK_CAPACITY = 256
# The first-hit walk checks every FIRST_HIT_PERIOD iterations whether its
# ray has a hit (csrc FIRST_HIT_PERIOD; tpurt's 2**W8_EXIT_LOG).
FIRST_HIT_PERIOD = 4
# The seed's loosening (tpurt's trace_closest_pallas): cap = t1 * (1 +
# 4e-6) + 1e-6, about 33 ulps, so the closest walk's strict '<' always
# accepts the seed's own triangle again.
SEED_SCALE, SEED_PAD = 1.0 + 4e-6, 1e-6


def iter_cap(num_nodes: int) -> int:
    """Walk iteration cap: every node is pushed at most once, so a walk
    that reaches it is corrupted (the JAX package's 2*num_wide+64, and
    ``_iter_cap``'s 2*num_internal+64 for the binary tree)."""
    return 2 * num_nodes + 64


def stack_bound(depth: int) -> int:
    return 7 * depth + 1


def check_stack_bound(depth: int, capacity: int = STACK_CAPACITY) -> None:
    """Raise when a wide tree of ``depth`` levels could overflow a per-ray
    stack of ``capacity`` entries."""
    if stack_bound(depth) > capacity:
        raise ValueError(
            f"wide BVH depth {depth} needs a per-ray stack of "
            f"{stack_bound(depth)} entries; the kernel has {capacity}")


def check_binary_stack_bound(depth: int,
                             capacity: int = STACK_CAPACITY) -> None:
    """Raise when a binary tree whose deepest internal node lies at
    ``depth`` (root = 0) could overflow a per-ray stack of ``capacity``
    entries: the binary walk needs depth + 1."""
    if depth + 1 > capacity:
        raise ValueError(f"binary BVH depth {depth} needs a per-ray stack of "
                         f"{depth + 1} entries; the kernel has {capacity}")


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


def _flat_packets(x: torch.Tensor, npad: int, fill: float) -> torch.Tensor:
    """f32[N] -> f32[npad / 1024, 8, 128], padded with ``fill``."""
    return F.pad(x, (0, npad - x.shape[0]), value=fill).reshape(-1, 8, 128)


def t_max_tensor(t_max, device) -> torch.Tensor:
    """A walk's t_max as a float32 tensor on ``device``: a Python number
    filled there (no copy of host data onto the card), host data copied,
    a tensor as it is."""
    if isinstance(t_max, (int, float)):
        return torch.full((), t_max, dtype=torch.float32, device=device)
    return as_f32(t_max, device)


def _ray_packets(origins, dirs, t_max):
    """(H, W, 3) rays -> seven (P, 8, 128) component tensors in 32x32 pixel
    tiles, or (N, 3) rays in runs of 1024."""
    tm = t_max_tensor(t_max, origins.device)
    if origins.ndim == 3:
        h, w = origins.shape[:2]
        comps = [to_packets(origins[..., c]) for c in range(3)]
        comps += [to_packets(dirs[..., c], fill=1.0) for c in range(3)]
        return comps, to_packets(tm.expand(h, w), fill=-1.0), ("img", h, w)
    n = origins.shape[0]
    npad = -(-n // LANES) * LANES
    comps = [_flat_packets(origins[:, c], npad, 0.0) for c in range(3)]
    comps += [_flat_packets(dirs[:, c], npad, 1.0) for c in range(3)]
    return comps, _flat_packets(tm.expand(n), npad, -1.0), ("flat", n, npad)


def _unpack(res, meta):
    kind, a, b = meta
    if kind == "img":
        return from_packets(res, a, b)
    return res.reshape(-1)[:a]


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


def _pack_soft_origins(origins, valid, batch: int):
    """Biased shadow origins and valid flags -> ONE f32[PB, 4, 8, 128]
    block (o.xyz, valid as 1.0 / 0.0), padded to a multiple of ``batch``
    with invalid packets. origins (H, W, 3) with valid (H, W), or (N, 3)
    with (N,)."""
    v = valid.to(torch.float32)
    if origins.ndim == 3:
        h, w = origins.shape[:2]
        comps = [to_packets(origins[..., c]) for c in range(3)]
        comps.append(to_packets(v))
        meta = ("img", h, w)
    else:
        n = origins.shape[0]
        npad = -(-n // LANES) * LANES
        comps = [_flat_packets(origins[:, c], npad, 0.0) for c in range(3)]
        comps.append(_flat_packets(v, npad, 0.0))
        meta = ("flat", n, npad)
    rays = torch.stack(comps, dim=1)                   # (P, 4, 8, 128)
    p = rays.shape[0]
    pb = -(-p // batch) * batch
    if pb != p:
        rays = torch.cat([rays, rays.new_zeros((pb - p, 4, 8, 128))])
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
    return _slab(rec, o, inv, t_min, cap) & (rec[:, :, 0] <= rec[:, :, 3])


def _slab(rec, o, inv, t_min, cap):
    """Slab test of c boxes per ray: rec f32[n, c, >=6] holding bmin.xyz,
    bmax.xyz first -> bool[n, c], hit iff max(lx, ly, lz, t_min) <=
    min(hx, hy, hz, cap)."""
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
    return enter <= exit_


def _t_offsets(leaf, k):
    """i64[n, k]: the word of a WideBVHT's transposed blocks where
    triangle s = 8h + t of each leaf starts, blk*1024 + t*128 + unit*j +
    9h for leaf lpb*blk + j (unit = 9 * k/8); its nine fields, and its
    attributes in the transposed attribute rows, follow there."""
    lpb = leaves_per_block(k)
    blk = torch.div(leaf, lpb, rounding_mode="floor")
    j = leaf - blk * lpb
    s = torch.arange(k, device=leaf.device)
    return ((blk * LANES + j * (9 * (k // 8)))[:, None]
            + (s % 8) * 128 + 9 * (s // 8))


def _leaf_tris(tris, leaf, k):
    """The nine fields (v0.xyz, e1.xyz, e2.xyz) of each leaf's k triangles,
    each f32[n, k], from the leaf rows f32[L, 128] or, for a WideBVHT,
    from its transposed blocks f32[nblk, 8, 128]."""
    if tris.dim() == 3:
        off = _t_offsets(leaf, k)[:, :, None] + torch.arange(
            9, device=leaf.device)
        row = tris.reshape(-1)[off]
    else:
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


def _winner_attrs(at0, at1, k, leaf, sel, u, v, normal, textured):
    """Channels 2-14 of each winner (triangle ``sel`` of ``leaf``) from its
    attribute row: u, v, uv, kd, layer, tid, oct0..2, the normal. With
    ``textured`` uv is uv0 + u d1 + v d2 in tpurt's order (no FMA) and
    the layer lane is read; else both stay 0."""
    ar = at0[leaf] if k <= 8 else torch.cat([at0[leaf], at1[leaf]], dim=1)
    a = ar[:, :16 * k].reshape(-1, k, 16).gather(
        1, sel[:, :, None].expand(-1, 1, 16))[:, 0]
    uj = u.gather(1, sel)[:, 0]
    vj = v.gather(1, sel)[:, 0]
    if textured:
        uvu = a[:, 5] + uj * a[:, 7] + vj * a[:, 9]
        uvv = a[:, 6] + uj * a[:, 8] + vj * a[:, 10]
        lay = a[:, 4]
    else:
        uvu = uvv = lay = torch.zeros_like(uj)
    return torch.stack([uj, vj, uvu, uvv, a[:, 3], lay, a[:, 11], a[:, 0],
                        a[:, 1], a[:, 2], *normal], dim=1)


def _winner_attrs_t(at0, at1, k, leaf, sel, u, v, normal, textured):
    """``_winner_attrs`` from the transposed attribute rows of a WideBVHT
    (``make_leaf_attr_rows_t``), read at the winner's geometry address:
    kd, the triangle id and oct0..2 from at0_t; with ``textured`` the
    layer and uv0 from at0_t, d1 and d2 from at1_t, uv = uv0 + u d1 + v
    d2 in tpurt's order (no FMA); else uv 0 and the layer -1, the w8t
    kernel's initial layer."""
    off = _t_offsets(leaf, k).gather(1, sel)[:, :1]
    a = at0.reshape(-1)[off + torch.arange(9, device=off.device)]
    uj = u.gather(1, sel)[:, 0]
    vj = v.gather(1, sel)[:, 0]
    if textured:
        b = at1.reshape(-1)[off + torch.arange(4, device=off.device)]
        uvu = a[:, 6] + uj * b[:, 0] + vj * b[:, 2]
        uvv = a[:, 7] + uj * b[:, 1] + vj * b[:, 3]
        lay = a[:, 5]
    else:
        uvu = uvv = torch.zeros_like(uj)
        lay = torch.full_like(uj, -1.0)
    return torch.stack([uj, vj, uvu, uvv, a[:, 3], lay, a[:, 4], a[:, 0],
                        a[:, 1], a[:, 2], *normal], dim=1)


def _closest_walk(nodes, tris, at0, at1, k, o, d, inv, tmax, t_min,
                  max_iters, stack_size, stats=None, textured=False,
                  first_hit=False):
    """Closest hit of n rays -> (best_t, best_i, attr f32[n, 13],
    overflow, capped). attr holds the winner's channels 2-14 of the
    attribute block: u, v, the interpolated uv and kd, layer, tid, oct0..2
    read from the attribute rows, then the unnormalised geometric normal.
    Without ``textured`` uv and layer stay 0 (the zero carry of the JAX
    kernel); with ``at0`` None (the attrs=0 walk, which reads no
    attribute row) only the normal is kept. ``tris`` of a WideBVHT (the
    transposed blocks, 3-D) are read by ``_t_offsets``, and so are its
    transposed attribute rows; its untextured layer is -1 on every ray,
    as the w8t kernel's. ``first_hit``: the seed walk, which stops a ray
    after every FIRST_HIT_PERIOD-th iteration once it has some hit (a
    stopped walk is not a capped one)."""
    n = tmax.shape[0]
    dev = tmax.device
    active0 = tmax > t_min
    best_t = torch.where(active0, tmax, -_BIG)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    attr = torch.zeros((n, ATTR_CH - 2), dtype=torch.float32, device=dev)
    transposed = tris.dim() == 3
    if transposed and at0 is not None and not textured:
        attr[:, 5] = -1.0
    winner_attrs = _winner_attrs_t if transposed else _winner_attrs
    w = _Walk(n, stack_size, dev)
    stopped = torch.zeros((n,), dtype=torch.bool, device=dev)
    while True:
        rows = torch.nonzero((w.sp > 0) & (w.it < max_iters)
                             & ~stopped)[:, 0]
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
                e1x, e1y, e1z, e2x, e2y, e2z = (
                    x.gather(1, sel)[:, 0] for x in tri[3:9])
                normal = [e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z,
                          e1x * e2y - e1y * e2x]
                if at0 is None:
                    attr[r, 10:] = torch.stack(normal, dim=1)
                else:
                    attr[r] = winner_attrs(at0, at1, k, leaf, sel,
                                           u[better], v[better], normal,
                                           textured)
            push_m = hit[:, c] & (refs[:, c] >= 0)
            if bool(push_m.any()):
                w.push(rows[push_m], refs[push_m, c])
        w.it[rows] += 1
        if first_hit:
            stopped[rows] = ((w.it[rows] % FIRST_HIT_PERIOD == 0)
                             & (best_i[rows] >= 0))
    capped = ((w.sp > 0) & ~stopped).sum().to(torch.int32)
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


def _components(rays) -> list:
    """A packed f32[PB, C, 8, 128] block -> its C components, each f32[N]
    in (packet, lane) order: ray i of the block is element i."""
    pb, c = rays.shape[:2]
    return list(rays.reshape(pb, c, LANES).permute(1, 0, 2).reshape(c, -1))


class _Walks:
    """Any-hit walks of n rays over one accel, from t_min, summing every
    walk's dropped pushes and capped walks."""

    def __init__(self, nodes, tris, k, n, t_min, max_iters, stack_size,
                 stats):
        self.args = (nodes, tris, k)
        self.n = n
        self.t_min = t_min
        self.walk_kw = dict(max_iters=max_iters, stack_size=stack_size,
                            stats=stats)
        zero = torch.zeros((), dtype=torch.int32, device=nodes.device)
        self.ovf, self.cap = zero, zero

    def occluded(self, so, ray) -> torch.Tensor:
        """One any-hit walk per ray; adds to the counters."""
        sd, sinv, stmax = ray
        nodes, tris, k = self.args
        occ, ovf, cap = _anyhit_walk(nodes, tris, k, so, sd, sinv, stmax,
                                     self.t_min, **self.walk_kw)
        self.ovf = self.ovf + ovf
        self.cap = self.cap + cap
        return occ

    def image(self, x: torch.Tensor) -> torch.Tensor:
        """Per-ray i32 values -> the kernels' (PB, 8, 128) output block."""
        return x.to(torch.int32).reshape(-1, 8, 128)

    def counts(self) -> torch.Tensor:
        return torch.stack([self.ovf, self.cap]).to(torch.int32)


class _Phase1(_Walks):
    """The shared phase 1 of every closest-hit plain version: the closest
    walk over the packed rays and its outputs ``outs``: with the attribute
    rows (attrs=1, and attrs=2 with ``textured``, which also fills the uv
    and layer channels) the 15 channels f32[PB,15,8,128], without them
    (``at0`` None, attrs=0) t f32[PB,8,128] (BIG on a miss) and the sorted
    index i32[PB,8,128] (-1). The shadow walks of phase 2 start at t = 0
    and add to its walk counters."""

    def __init__(self, rays, nodes, tris, at0, at1, k, t_min, max_iters,
                 stack_size, stats, textured=False, first_hit=False):
        pb = rays.shape[0]
        comp = _components(rays)
        self.o = (comp[0], comp[1], comp[2])
        self.d = (comp[3], comp[4], comp[5])
        inv, tmax = (comp[6], comp[7], comp[8]), comp[9]
        n = tmax.shape[0]
        super().__init__(nodes, tris, k, n, 0.0, max_iters, stack_size,
                         stats)
        best_t, best_i, attr, self.ovf, self.cap = _closest_walk(
            nodes, tris, at0, at1, k, self.o, self.d, inv, tmax, t_min,
            max_iters, stack_size, stats, textured, first_hit)
        t_out = torch.where(best_i >= 0, best_t, _BIG)
        if at0 is None:
            self.outs = (t_out.reshape(pb, 8, 128), self.image(best_i))
        else:
            chans = torch.cat([t_out[None], best_i.to(torch.float32)[None],
                               attr.T])
            self.outs = (chans.reshape(ATTR_CH, pb, 8, 128)
                         .permute(1, 0, 2, 3).contiguous(),)
        self.best_t = best_t
        self.hitm = best_i >= 0
        self.gn = (attr[:, 10], attr[:, 11], attr[:, 12])

    def origin(self, bias):
        return _biased_origin(bias, self.o, self.d, self.best_t, self.gn)


def closest_shadow_reference(rays, nodes, tris, at0, at1, scal, *,
                             leaf_size: int, point: bool, t_min: float,
                             max_iters: int, stack_size: int, stats=None,
                             textured: bool = False):
    """Plain PyTorch version of the fused kernel, on any device.

    rays f32[PB,10,8,128] -> (out f32[PB,15,8,128], occ i32[PB,8,128],
    counts i32[2]); with ``at0`` None (attrs=0) (t f32[PB,8,128], sidx
    i32[PB,8,128], occ, counts), as every fused plain version here. Each
    ray walks its own stack [N, stack_size]; the loop
    runs until every stack is empty. Children of a popped node are tested
    against the cap at pop time and handled in slot order (leaf tests in
    place, internal children pushed), as the kernel does. ``stats``: an
    optional dict that receives the node pops and triangle tests.
    ``textured`` (attrs=2, every fused plain version and
    ``closest_attrs_reference``): the walk also interpolates the winner's
    uv and reads its layer into channels 4, 5 and 7, which otherwise stay
    0."""
    ph = _Phase1(rays, nodes, tris, at0, at1, leaf_size, t_min, max_iters,
                 stack_size, stats, textured)
    if point:
        so = ph.origin(scal[3])
        ray = _point_ray(scal[0:3], so, ph.hitm)
    else:
        so = ph.origin(scal[6])
        ray = _dir_ray(scal[0:3], scal[3:6], scal[7:10], scal[10:13], so,
                       ph.hitm)
    occ = ph.occluded(so, ray)
    return (*ph.outs, ph.image(occ), ph.counts())


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
                                   stats=None,
                                   textured: bool = False):
    """Plain version of ``_closest_multi_shadow_kernel_w8_b``: phase 1,
    then one hard any-hit walk per light from the shared biased hit point.
    scal: [bias, root min(3), root max(3)], then per light a position(3)
    (``points[l]``) or a toward-light direction(3) and its clamped
    inverse(3). -> (out, mask i32[PB,8,128] with bit l = light l occluded,
    counts i32[2])."""
    _check_mask_lights(len(points))
    ph = _Phase1(rays, nodes, tris, at0, at1, leaf_size, t_min, max_iters,
                 stack_size, stats, textured)
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
    return (*ph.outs, ph.image(mask), ph.counts())


def _sampled_counts(walks, so, spp, seed, zero_stream, make_ray,
                    light: int = 0):
    """Occlusion counts in [0, spp] over spp samples of ``light``."""
    ray_index = torch.arange(walks.n, device=so[0].device)
    cnt = torch.zeros(walks.n, dtype=torch.int32, device=so[0].device)
    for s in range(spp):
        u1, u2 = sample_uniforms(seed, light, ray_index, s, zero_stream)
        cnt += walks.occluded(so, make_ray(u1, u2)).to(torch.int32)
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
                                  stats=None,
                                  textured: bool = False):
    """Plain version of ``_closest_soft_shadow_kernel_w8_b``: phase 1, then
    spp cone samples around the sun axis. scal f32[17]: axis(3), basis
    t0(3), t1(3), cone_cos, root min(3), root max(3), bias. -> (out, counts
    i32[PB,8,128] in [0, spp], walk counts i32[2])."""
    ph = _Phase1(rays, nodes, tris, at0, at1, leaf_size, t_min, max_iters,
                 stack_size, stats, textured)
    so = ph.origin(scal[16])
    sample = _cone_sampler(scal, 0, scal[10:13], scal[13:16], so, ph.hitm)
    cnt = _sampled_counts(ph, so, spp, seed, zero_stream, sample)
    return (*ph.outs, ph.image(cnt), ph.counts())


def closest_point_soft_shadow_reference(rays, nodes, tris, at0, at1, scal,
                                        *, leaf_size: int, spp: int,
                                        seed: int, zero_stream: bool,
                                        t_min: float, max_iters: int,
                                        stack_size: int, stats=None,
                                        textured: bool = False):
    """Plain version of ``_closest_psoft_shadow_kernel_w8_b``: phase 1,
    then spp jittered-disk samples on a point light, in a per-ray Duff
    basis around the axis to the light's centre. scal f32[5]: position(3),
    radius, bias. -> (out, counts, walk counts)."""
    ph = _Phase1(rays, nodes, tris, at0, at1, leaf_size, t_min, max_iters,
                 stack_size, stats, textured)
    so = ph.origin(scal[4])
    sample = _disk_sampler(scal, 0, so, ph.hitm)
    cnt = _sampled_counts(ph, so, spp, seed, zero_stream, sample)
    return (*ph.outs, ph.image(cnt), ph.counts())


def _soft_multi_scal_len(disk: bool, n_extra: int) -> int:
    return 7 + (4 if disk else 10) + 6 * n_extra


def closest_soft_multi_shadow_reference(rays, nodes, tris, at0, at1, scal,
                                        *, leaf_size: int, spp: int,
                                        seed: int, zero_stream: bool,
                                        disk: bool, n_extra: int,
                                        t_min: float, max_iters: int,
                                        stack_size: int, stats=None,
                                        textured: bool = False):
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
                 stack_size, stats, textured)
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
    return (*ph.outs, ph.image(cnt), ph.image(mask), ph.counts())


def closest_attrs_reference(rays, nodes, tris, at0, at1, *, leaf_size: int,
                            t_min: float, max_iters: int, stack_size: int,
                            stats=None,
                            textured: bool = False):
    """Plain version of ``_closest_attr_kernel_w8_b``: phase 1 alone.
    rays f32[PB,10,8,128] -> (out f32[PB,15,8,128], counts i32[2])."""
    ph = _Phase1(rays, nodes, tris, at0, at1, leaf_size, t_min, max_iters,
                 stack_size, stats, textured)
    return (*ph.outs, ph.counts())


def closest_reference(rays, nodes, tris, *, leaf_size: int, t_min: float,
                      max_iters: int, stack_size: int, stats=None):
    """Plain version of ``_closest_hit_kernel_w8_b``: phase 1 without
    attribute rows, each ray capped at its own t_max (row 9). rays
    f32[PB,10,8,128] -> (t f32[PB,8,128], BIG on a miss; sidx
    i32[PB,8,128], -1 on a miss; counts i32[2])."""
    ph = _Phase1(rays, nodes, tris, None, None, leaf_size, t_min,
                 max_iters, stack_size, stats)
    return (*ph.outs, ph.counts())


def first_hit_reference(rays, nodes, tris, *, leaf_size: int, t_min: float,
                        max_iters: int, stack_size: int, stats=None):
    """Plain version of ``_first_hit_kernel_w8_b``: ``closest_reference``'s
    walk, which stops a ray after every FIRST_HIT_PERIOD-th iteration once
    it has some hit. Same contract; (t, sidx) is an upper bound on each
    ray's closest hit (a miss where the closest walk misses)."""
    ph = _Phase1(rays, nodes, tris, None, None, leaf_size, t_min,
                 max_iters, stack_size, stats, first_hit=True)
    return (*ph.outs, ph.counts())


def seed_cap(rays, t1, s1) -> torch.Tensor:
    """The seeded closest hit's per-ray t_max: the seed's t loosened
    (SEED_SCALE, SEED_PAD) where it hit, the ray's own t_max (row 9)
    elsewhere -> f32[PB, 8, 128]."""
    return torch.where(s1 >= 0, t1 * SEED_SCALE + SEED_PAD, rays[:, 9])


def any_reference(rays, nodes, tris, *, leaf_size: int, t_min: float,
                  max_iters: int, stack_size: int, stats=None):
    """Plain version of ``_any_hit_kernel_w8_b``: any hit in (t_min,
    t_max) of each ray of the f32[PB,10,8,128] block; a ray with t_max <=
    t_min is inactive. -> (occ i32[PB,8,128], counts i32[2])."""
    c = _components(rays)
    w = _Walks(nodes, tris, leaf_size, c[9].shape[0], t_min, max_iters,
               stack_size, stats)
    occ = w.occluded((c[0], c[1], c[2]),
                     ((c[3], c[4], c[5]), (c[6], c[7], c[8]), c[9]))
    return w.image(occ), w.counts()


def _soft_walks(rays, nodes, tris, leaf_size, t_min, max_iters, stack_size,
                stats):
    """The origins block f32[PB,4,8,128] -> (walks, origins, valid)."""
    c = _components(rays)
    w = _Walks(nodes, tris, leaf_size, c[0].shape[0], t_min, max_iters,
               stack_size, stats)
    return w, (c[0], c[1], c[2]), c[3] > 0.0


def any_soft_reference(rays, nodes, tris, scal, *, leaf_size: int, spp: int,
                       seed: int, light: int, zero_stream: bool,
                       t_min: float, max_iters: int, stack_size: int,
                       stats=None):
    """Plain version of ``_any_hit_kernel_w8_soft``: spp cone samples from
    each biased origin of the f32[PB,4,8,128] block, drawn with the key
    (seed, light). scal f32[16]: axis(3), basis t0(3), t1(3), cone_cos,
    root min(3), root max(3). Invalid rays walk with t = -BIG. -> (counts
    i32[PB,8,128] in [0, spp], walk counts i32[2])."""
    w, so, valid = _soft_walks(rays, nodes, tris, leaf_size, t_min,
                               max_iters, stack_size, stats)
    sample = _cone_sampler(scal, 0, scal[10:13], scal[13:16], so, valid)
    cnt = _sampled_counts(w, so, spp, seed, zero_stream, sample, light)
    return w.image(cnt), w.counts()


def any_point_soft_reference(rays, nodes, tris, scal, *, leaf_size: int,
                             spp: int, seed: int, light: int,
                             zero_stream: bool, t_min: float,
                             max_iters: int, stack_size: int, stats=None):
    """Plain version of ``_any_hit_kernel_w8_psoft``: spp jittered-disk
    samples on a point light from each biased origin, in a per-ray Duff
    basis around the axis to the light's centre. scal f32[4]: position(3),
    radius. -> (counts, walk counts)."""
    w, so, valid = _soft_walks(rays, nodes, tris, leaf_size, t_min,
                               max_iters, stack_size, stats)
    sample = _disk_sampler(scal, 0, so, valid)
    cnt = _sampled_counts(w, so, spp, seed, zero_stream, sample, light)
    return w.image(cnt), w.counts()


# ---------------------------------------------------------------------------
# The binary walks (the packed LBVH of kernels/pack.py)
# ---------------------------------------------------------------------------

def _binary_pop(w, rows, nodes, stats):
    """Pop one node per ray of ``rows`` -> (boxes f32[m, 2, 6] left and
    right, refs i32[m, 2]). Each pop slab-tests both child boxes."""
    rec = nodes.reshape(-1, NODE_STRIDE)[w.pop(rows)]
    if stats is not None:
        _count(stats, "pops", rec.shape[0])
        _count(stats, "slab_tests", 2 * rec.shape[0])
    return rec[:, :12].reshape(-1, 2, 6), rec[:, 12:14].to(torch.int32)


def _binary_closest_walk(nodes, tris, k, o, d, inv, tmax, t_min, max_iters,
                         stack_size, stats=None):
    """Closest hit of n rays over the packed binary tree -> (best_t,
    best_i, overflow, capped). Pop a node, test both boxes against the
    running best t, then visit the left child and the right: a leaf is
    tested at once, an internal child pushed (the right pops first)."""
    n = tmax.shape[0]
    dev = tmax.device
    active0 = tmax > t_min
    best_t = torch.where(active0, tmax, -_BIG)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    w = _Walk(n, stack_size, dev)
    while True:
        rows = torch.nonzero((w.sp > 0) & (w.it < max_iters))[:, 0]
        if rows.numel() == 0:
            break
        boxes, refs = _binary_pop(w, rows, nodes, stats)
        cap = torch.where(active0[rows], best_t[rows], -_BIG)
        hit = _slab(boxes, tuple(c[rows] for c in o),
                    tuple(c[rows] for c in inv), t_min, cap)
        for c in range(2):
            leaf_m = hit[:, c] & (refs[:, c] < 0)
            if bool(leaf_m.any()):
                _count(stats, "closest_tris", leaf_m.sum() * k)
                r = rows[leaf_m]
                leaf = torch.clamp(-refs[leaf_m, c] - 1, min=0).long()
                t, _, _ = _leaf_closest_t(_leaf_tris(tris, leaf, k),
                                          tuple(x[r] for x in o),
                                          tuple(x[r] for x in d))
                cand = torch.where(t > t_min, t, float("inf"))
                j = torch.argmin(cand, dim=1)      # first minimum
                tj = cand.gather(1, j[:, None])[:, 0]
                better = (tj < best_t[r]) & active0[r]
                best_t[r[better]] = tj[better]
                best_i[r[better]] = (leaf * k + j)[better].to(torch.int32)
            push_m = hit[:, c] & (refs[:, c] >= 0)
            if bool(push_m.any()):
                w.push(rows[push_m], refs[push_m, c])
        w.it[rows] += 1
    capped = ((w.sp > 0).sum()).to(torch.int32)
    return best_t, best_i, w.overflow, capped


def _binary_anyhit_walk(nodes, tris, k, o, d, inv, tmax, t_min, max_iters,
                        stack_size, stats=None):
    """Any hit in (t_min, tmax) of n rays over the packed binary tree ->
    (occluded, overflow, capped). The walk stops at the first occluder,
    the right child unvisited if the left leaf occludes."""
    n = tmax.shape[0]
    dev = tmax.device
    active0 = tmax > t_min
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    w = _Walk(n, stack_size, dev)
    while True:
        rows = torch.nonzero((w.sp > 0) & (w.it < max_iters) & ~occ)[:, 0]
        if rows.numel() == 0:
            break
        boxes, refs = _binary_pop(w, rows, nodes, stats)
        cap = torch.where(active0[rows], tmax[rows], -_BIG)
        hit = _slab(boxes, tuple(c[rows] for c in o),
                    tuple(c[rows] for c in inv), t_min, cap)
        done = torch.zeros(rows.shape[0], dtype=torch.bool, device=dev)
        for c in range(2):
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


def _binary_rays(rays):
    c = _components(rays)
    return (c[0], c[1], c[2]), (c[3], c[4], c[5]), (c[6], c[7], c[8]), c[9]


def binary_closest_reference(rays, nodes, tris, *, leaf_size: int,
                             t_min: float, max_iters: int, stack_size: int,
                             stats=None):
    """Plain version of ``_closest_hit_kernel`` (mode BIN_CLOSEST): the
    closest hit in (t_min, t_max) of each ray of the f32[PB,10,8,128]
    block over the packed binary tree (nodes f32[Nr,128], leaf rows
    f32[L,128]); a ray with t_max <= t_min is inactive. -> (t
    f32[PB,8,128], BIG on a miss; sorted index i32[PB,8,128], -1 on a
    miss; counts i32[2])."""
    o, d, inv, tmax = _binary_rays(rays)
    best_t, best_i, ovf, cap = _binary_closest_walk(
        nodes, tris, leaf_size, o, d, inv, tmax, t_min, max_iters,
        stack_size, stats)
    t_out = torch.where(best_i >= 0, best_t, _BIG)
    return (t_out.reshape(-1, 8, 128), best_i.reshape(-1, 8, 128),
            torch.stack([ovf, cap]).to(torch.int32))


def binary_any_reference(rays, nodes, tris, *, leaf_size: int, t_min: float,
                         max_iters: int, stack_size: int, stats=None):
    """Plain version of ``_any_hit_kernel`` (mode BIN_ANY): any hit in
    (t_min, t_max) of each ray of the f32[PB,10,8,128] block over the
    packed binary tree. -> (occ i32[PB,8,128], counts i32[2])."""
    o, d, inv, tmax = _binary_rays(rays)
    occ, ovf, cap = _binary_anyhit_walk(nodes, tris, leaf_size, o, d, inv,
                                        tmax, t_min, max_iters, stack_size,
                                        stats)
    return (occ.to(torch.int32).reshape(-1, 8, 128),
            torch.stack([ovf, cap]).to(torch.int32))


# The w8t walks over a WideBVHT (``tpurt``'s transposed-leaf kernels): the
# 8-wide walks above, which read a 3-D ``tris`` (the transposed blocks
# f32[nblk, 8, 128]) and its transposed attribute rows by ``_t_offsets``.

def _check_t(tris_t, leaf_size: int) -> None:
    leaves_per_block(leaf_size)
    if tris_t.dim() != 3 or tuple(tris_t.shape[1:]) != (8, 128):
        raise ValueError(f"tris_t has shape {tuple(tris_t.shape)}, "
                         "expected (nblk, 8, 128)")


def w8t_any_reference(rays, nodes, tris_t, **walk):
    """Plain version of ``_any_hit_kernel_w8t``: ``any_reference``'s walk
    over the transposed leaves, the same contract."""
    _check_t(tris_t, walk["leaf_size"])
    return any_reference(rays, nodes, tris_t, **walk)


def w8t_closest_reference(rays, nodes, tris_t, **walk):
    """Plain version of ``_closest_hit_kernel_w8t``: ``closest_reference``'s
    walk over the transposed leaves -> (t f32[PB,8,128], sorted index
    i32[PB,8,128], counts i32[2])."""
    _check_t(tris_t, walk["leaf_size"])
    return closest_reference(rays, nodes, tris_t, **walk)


def w8t_closest_attrs_reference(rays, nodes, tris_t, at0_t, at1_t, *,
                                textured: bool = False, **walk):
    """Plain version of ``_closest_attr_kernel_w8t_b``: the closest hit and
    its 15 attribute channels from the transposed attribute rows
    (``make_leaf_attr_rows_t``); without ``textured`` channel 7 (the
    layer) is -1 on every ray and uv 0. -> (out f32[PB,15,8,128], counts
    i32[2])."""
    for t in (tris_t, at0_t):
        _check_t(t, walk["leaf_size"])
    return closest_attrs_reference(rays, nodes, tris_t, at0_t, at1_t,
                                   textured=textured, **walk)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

class Params(ctypes.Structure):
    """One launch's arguments: ``Params`` of csrc/walk.cuh, field for field
    (the loader checks the two sizes agree)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "nodes", "tris", "at0", "at1", "rays", "scal", "out", "sidx_out",
        "cnt_out", "mask_out", "counts", "seed")]
        + [(n, ctypes.c_int) for n in ("num_rays", "k", "max_iters",
                                       "stack_size", "attrs")]
        + [("t_min", ctypes.c_float)]
        + [(n, ctypes.c_int) for n in ("nlights", "point_mask", "spp",
                                       "zero_stream", "disk", "n_extra")]
        + [("light", ctypes.c_uint32)])


# The kernel templates' modes: csrc/fused_shadows.cu ``Mode`` (closest hit,
# alone or with shadows) and csrc/shadow_rays.cu ``Mode`` (shadow rays).
HARD, MULTI, SOFT, PSOFT, SOFT_MULTI, CLOSEST, NEAREST, FIRST_HIT = range(8)
ANY, ANY_SOFT, ANY_PSOFT = range(3)
# csrc/binary.cu ``Mode``: the walks over the packed binary tree.
BIN_CLOSEST, BIN_ANY = range(2)
# csrc/transposed.cu ``Mode``: the w8t walks over a WideBVHT.
W8T_ANY, W8T_CLOSEST = range(2)
_FUSED = "tpurt_fused_shadows_launch"
_SHADOW_RAYS = "tpurt_shadow_rays_launch"
_BINARY = "tpurt_binary_launch"
_TRANSPOSED = "tpurt_transposed_launch"
# Each entry point's walk source under csrc/.
_SOURCES = {_FUSED: "fused_shadows.cu", _SHADOW_RAYS: "shadow_rays.cu",
            _BINARY: "binary.cu", _TRANSPOSED: "transposed.cu"}


def _require_cuda(dev) -> None:
    """The kernels take CUDA tensors only: no fallback."""
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {dev}")


def _launch(entry: str, mode: int, outputs, rays, nodes, tris, scal, *,
            ray_comps: int, attrs, leaf_size: int, t_min: float,
            max_iters: int, stack_size: int, scal_len: int,
            closest: bool = False, textured: bool = False,
            transposed: bool = False, **extra):
    """Check a launch's inputs, allocate its outputs, launch ``mode`` of the
    C entry point ``entry`` on the current stream. rays: the
    f32[PB,ray_comps,8,128] block; ``closest``: the mode runs the closest
    walk, which returns out f32[PB,15,8,128] with the attribute tables
    ``attrs`` = (at0, at1) (attrs=1; attrs=2 with ``textured``, which
    also fills the uv and layer channels), or t f32[PB,8,128] and sidx
    i32[PB,8,128] with ``attrs`` None (attrs=0); scal: f32[scal_len], or
    None when scal_len is 0; outputs: the i32[PB,8,128] blocks to return,
    a tuple of "cnt_out" / "mask_out"; ``transposed``: the w8t kernels,
    whose leaves (and attribute rows) are a WideBVHT's transposed blocks
    f32[nblk, 8, 128], at leaf_size 8 or 16; extra: the mode's Params
    fields, ``seed`` as ``_sampling`` gives it (the kernel reads it
    through a pointer). -> (closest outputs, *outputs, counts); raises on
    a refused launch."""
    from ._build import load_library
    k = int(leaf_size)
    if transposed:
        leaves_per_block(k)
        leaf_shape = (8, 128)
    elif not 1 <= k <= 14:
        raise ValueError(f"leaf_size {k} outside 1..14")
    else:
        leaf_shape = (128,)
    if not 1 <= stack_size <= STACK_CAPACITY:
        raise ValueError(f"stack_size {stack_size} outside 1..{STACK_CAPACITY}")
    dev = rays.device
    _require_cuda(dev)
    pb = rays.shape[0]
    nl = tris.shape[0]
    _check(rays, "rays", torch.float32, (pb, ray_comps, 8, 128), dev)
    _check(nodes, "nodes", torch.float32, (nodes.shape[0], 128), dev)
    _check(tris, "tris_t" if transposed else "tris", torch.float32,
           (nl, *leaf_shape), dev)
    ptrs, res = {}, []
    if closest and attrs is not None:
        at0, at1 = attrs
        n1 = (nl if textured else 1) if transposed else (nl if k > 8 else 1)
        _check(at0, "at0", torch.float32, (nl, *leaf_shape), dev)
        _check(at1, "at1", torch.float32, (n1, *leaf_shape), dev)
        res.append(torch.empty((pb, ATTR_CH, 8, 128), dtype=torch.float32,
                               device=dev))
        ptrs.update(at0=at0.data_ptr(), at1=at1.data_ptr(),
                    out=res[0].data_ptr(), attrs=2 if textured else 1)
    elif closest:
        if textured:
            raise ValueError("a textured walk needs the attribute rows")
        res += [torch.empty((pb, 8, 128), dtype=torch.float32, device=dev),
                torch.empty((pb, 8, 128), dtype=torch.int32, device=dev)]
        ptrs.update(out=res[0].data_ptr(), sidx_out=res[1].data_ptr(),
                    attrs=0)
    if scal_len:
        _check(scal, "scal", torch.float32, (scal_len,), dev)
        ptrs["scal"] = scal.data_ptr()
    if "seed" in extra:
        seed = _seed_on(extra["seed"], dev)
        extra["seed"] = seed.data_ptr()
    lib = load_library()
    blocks = [torch.empty((pb, 8, 128), dtype=torch.int32, device=dev)
              for _ in outputs]
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    params = Params(
        nodes=nodes.data_ptr(), tris=tris.data_ptr(), rays=rays.data_ptr(),
        counts=counts.data_ptr(), num_rays=pb * LANES, k=k,
        max_iters=int(max_iters), stack_size=int(stack_size),
        t_min=float(t_min), **ptrs,
        **{name: b.data_ptr() for name, b in zip(outputs, blocks)}, **extra)
    err = getattr(lib, entry)(mode, ctypes.byref(params), _stream(dev))
    if err != 0:
        raise RuntimeError(f"{entry} mode {mode} launch failed: CUDA error "
                           f"{err}")
    return (*res, *blocks, counts)


def _sampling(spp: int, seed, zero_stream: bool, light: int) -> dict:
    """The sampling modes' Params fields (``seed`` as ``seed_arg`` keeps
    it; ``_launch`` gives the kernel its address)."""
    if spp < 1:
        raise ValueError(f"spp {spp} < 1")
    return dict(spp=int(spp), seed=seed_arg(seed),
                zero_stream=int(zero_stream), light=int(light) & 0xFFFFFFFF)


def _seed_on(seed, dev) -> torch.Tensor:
    """The key word a sampling launch reads through its pointer: the
    frame block's int32 view, or an int's 32 bits copied onto ``dev``."""
    if isinstance(seed, torch.Tensor):
        _check(seed, "seed", torch.int32, (1,), dev)
        return seed
    return torch.tensor([seed - (1 << 32) if seed >= 1 << 31 else seed],
                        dtype=torch.int32, device=dev)


def _no_fields() -> dict:
    return {}


def _hard_fields(point: bool) -> dict:
    return dict(scal_len=4 if point else 13, nlights=1,
                point_mask=int(bool(point)))


def _multi_fields(points) -> dict:
    _check_mask_lights(len(points))
    return dict(scal_len=_multi_scal_len(points), nlights=len(points),
                point_mask=sum(1 << i for i, p in enumerate(points) if p))


def _fused_sampling(spp: int, seed, zero_stream: bool) -> dict:
    """SOFT's and PSOFT's fields: light 0's samples."""
    return _sampling(spp, seed, zero_stream, 0)


def _soft_multi_fields(disk: bool, n_extra: int, spp: int, seed,
                       zero_stream: bool) -> dict:
    if n_extra:
        _check_mask_lights(n_extra)
    return dict(scal_len=_soft_multi_scal_len(disk, n_extra),
                disk=int(bool(disk)), n_extra=int(n_extra),
                **_sampling(spp, seed, zero_stream, 0))


def _check_records(nodes) -> None:
    """The binary kernels and the penumbra walks (PSOFT, ANY_PSOFT) read a
    node record as 16-byte loads."""
    if nodes.data_ptr() % 16:
        raise ValueError("node rows are not 16-byte aligned")


@dataclasses.dataclass
class _WalkKernel:
    """A row of ``WALK_KERNELS``: one walk kernel, a mode of one walk
    source in one attrs variant, and what ``_launch`` needs for it.
    ``outputs``: its i32[PB,8,128] blocks; ``ray_comps``: the rows of its
    ray block (4: the shadow-ray origins); ``closest``: the mode runs the
    closest walk, whose outputs ``attrs`` selects (0: t and the sorted
    index; 1: the attribute channels, from the tables that follow (rays,
    nodes, tris) in the arguments; 2: those with the winner's uv and
    layer); ``transposed``: a WideBVHT's leaves; ``records``: the kernel
    reads 16-byte node records; ``fields``: the mode's own keywords ->
    its Params fields; ``scal_len``: the length of the scalar block, the
    last argument (None: ``fields`` gives it; 0: no block). ``launch`` is
    the ``*_cuda`` launcher, ``reference`` its plain version."""

    name: str
    entry: str
    mode: int
    outputs: Tuple[str, ...]
    doc: str
    reference: Callable
    ray_comps: int = 10
    closest: bool = False
    attrs: int = 0
    transposed: bool = False
    records: bool = False
    fields: Callable[..., dict] = _no_fields
    scal_len: Optional[int] = 0
    launch: Callable = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.launch = _launcher(self)

    @property
    def source(self) -> str:
        """The kernel's walk source under csrc/."""
        return _SOURCES[self.entry]


def _launcher(w: _WalkKernel):
    """Row ``w``'s ``*_cuda``: (rays, nodes, tris[, at0, at1][, scal])
    and keywords, the walk's (leaf_size, t_min, max_iters, stack_size)
    and the mode's (``w.fields``)."""
    nargs = 3 + (2 if w.attrs else 0) + (w.scal_len != 0)
    const = dict(ray_comps=w.ray_comps, closest=w.closest,
                 textured=w.attrs == 2, transposed=w.transposed)
    if w.scal_len is not None:
        const["scal_len"] = w.scal_len

    def launch(*args, leaf_size: int, t_min: float, max_iters: int,
               stack_size: int, **kw):
        if len(args) != nargs:
            raise TypeError(f"{launch.__name__} takes {nargs} positional "
                            f"arguments, {len(args)} given")
        if w.records:
            _check_records(args[1])
        res = _launch(w.entry, w.mode, w.outputs, args[0], args[1], args[2],
                      args[-1] if w.scal_len != 0 else None,
                      attrs=args[3:5] if w.attrs else None,
                      leaf_size=leaf_size, t_min=t_min, max_iters=max_iters,
                      stack_size=stack_size, **const, **w.fields(**kw))
        launch.launches += 1
        return res

    launch.__name__ = launch.__qualname__ = w.name + "_cuda"
    launch.__doc__ = w.doc
    launch.launches = 0
    return launch


def _variant(name: str, reference, attrs: int):
    """The plain version of a closest walk's attrs variant, made from its
    attrs=1 one: attrs=0 takes no attribute tables, attrs=2 walks
    ``textured``."""
    if attrs == 1:
        return reference
    if attrs == 0:
        def plain(rays, nodes, tris, scal, **kw):
            return reference(rays, nodes, tris, None, None, scal, **kw)
    else:
        def plain(*args, **kw):
            return reference(*args, textured=True, **kw)
    plain.__name__ = plain.__qualname__ = name + "_reference"
    plain.__doc__ = (f"Plain version of ``{name}_cuda``: "
                     f"``{reference.__name__}`` in attrs={attrs}.")
    return plain


# An attrs variant's suffix of the kernel's name and the end of its doc.
_ATTRS_NAMES = {1: ("", "."),
                0: ("_st", ", t and the sorted index (attrs=0)."),
                2: ("_tex", ", the attribute channels with the winner's "
                    "interpolated uv and layer (attrs=2).")}


def _closest_variants(name, entry, mode, outputs, doc, reference,
                      attrs=(1, 0, 2), **row):
    """The rows of a closest walk's mode in each of its ``attrs``
    variants: ``name`` (1), ``name``_st (0), ``name``_tex (2)."""
    rows = []
    for a in attrs:
        suffix, more = _ATTRS_NAMES[a]
        rows.append(_WalkKernel(name + suffix, entry, mode, outputs,
                                doc + more,
                                _variant(name + suffix, reference, a),
                                closest=True, attrs=a, **row))
    return rows


_MASK, _CNT = ("mask_out",), ("cnt_out",)

# The walk launches, one row per kernel: the five fused modes of
# csrc/fused_shadows.cu in attrs 1, 0 and 2, its CLOSEST in attrs 1 and 2,
# NEAREST and FIRST_HIT; the shadow rays of csrc/shadow_rays.cu; the
# binary walks of csrc/binary.cu; the w8t walks of csrc/transposed.cu.
WALK_KERNELS = {w.name: w for w in (
    *_closest_variants("closest_shadow", _FUSED, HARD, _MASK,
                       "Mode HARD: light 0's hard shadow",
                       closest_shadow_reference, fields=_hard_fields,
                       scal_len=None),
    *_closest_variants("closest_multi_shadow", _FUSED, MULTI, _MASK,
                       "Mode MULTI: one hard shadow per light",
                       closest_multi_shadow_reference, fields=_multi_fields,
                       scal_len=None),
    *_closest_variants("closest_soft_shadow", _FUSED, SOFT, _CNT,
                       "Mode SOFT: spp cone samples of a sun",
                       closest_soft_shadow_reference,
                       fields=_fused_sampling, scal_len=17),
    *_closest_variants("closest_point_soft_shadow", _FUSED, PSOFT, _CNT,
                       "Mode PSOFT: spp disk samples of a point light",
                       closest_point_soft_shadow_reference, records=True,
                       fields=_fused_sampling, scal_len=5),
    *_closest_variants("closest_soft_multi_shadow", _FUSED, SOFT_MULTI,
                       ("cnt_out", "mask_out"),
                       "Mode SOFT_MULTI: soft light 0 plus hard directional "
                       "extras", closest_soft_multi_shadow_reference,
                       fields=_soft_multi_fields, scal_len=None),
    *_closest_variants("closest_attrs", _FUSED, CLOSEST, (),
                       "Mode CLOSEST: the closest hit and its attributes "
                       "alone", closest_attrs_reference, attrs=(1, 2)),
    _WalkKernel("closest", _FUSED, NEAREST, (),
                "Mode NEAREST: the closest hit alone, t and the sorted "
                "index.", closest_reference, closest=True),
    _WalkKernel("first_hit", _FUSED, FIRST_HIT, (),
                "Mode FIRST_HIT: the seed of the seeded G-buffer, t and the "
                "sorted index of a hit, found by NEAREST's walk stopped "
                "once the ray has one.", first_hit_reference, closest=True),
    _WalkKernel("any", _SHADOW_RAYS, ANY, _MASK,
                "Mode ANY of csrc/shadow_rays.cu: any hit of given rays.",
                any_reference),
    _WalkKernel("any_soft", _SHADOW_RAYS, ANY_SOFT, _CNT,
                "Mode ANY_SOFT: spp cone samples from given origins.",
                any_soft_reference, ray_comps=4, fields=_sampling,
                scal_len=16),
    _WalkKernel("any_point_soft", _SHADOW_RAYS, ANY_PSOFT, _CNT,
                "Mode ANY_PSOFT: spp disk samples from given origins.",
                any_point_soft_reference, ray_comps=4, records=True,
                fields=_sampling, scal_len=4),
    _WalkKernel("binary_closest", _BINARY, BIN_CLOSEST, (),
                "Mode BIN_CLOSEST of csrc/binary.cu: the closest hit over "
                "the packed binary tree, t and the sorted index.",
                binary_closest_reference, closest=True, records=True),
    _WalkKernel("binary_any", _BINARY, BIN_ANY, _MASK,
                "Mode BIN_ANY of csrc/binary.cu: any hit over the packed "
                "binary tree.", binary_any_reference, records=True),
    _WalkKernel("w8t_any", _TRANSPOSED, W8T_ANY, _MASK,
                "Mode W8T_ANY of csrc/transposed.cu: any hit of given rays.",
                w8t_any_reference, transposed=True),
    _WalkKernel("w8t_closest", _TRANSPOSED, W8T_CLOSEST, (),
                "Mode W8T_CLOSEST without attribute rows: t and the sorted "
                "index.", w8t_closest_reference, closest=True,
                transposed=True),
    *_closest_variants("w8t_closest_attrs", _TRANSPOSED, W8T_CLOSEST, (),
                       "Mode W8T_CLOSEST: the 15 attribute channels from "
                       "the transposed rows",
                       w8t_closest_attrs_reference, attrs=(1, 2),
                       transposed=True),
)}

# Each *_cuda launches its row's mode with the contract of its
# *_reference; it takes CUDA tensors only, builds the kernel library on
# first use, raises on anything the kernel does not take and on a refused
# launch, and counts its launches in ``.launches``.
closest_shadow_cuda = WALK_KERNELS["closest_shadow"].launch
closest_multi_shadow_cuda = WALK_KERNELS["closest_multi_shadow"].launch
closest_soft_shadow_cuda = WALK_KERNELS["closest_soft_shadow"].launch
closest_point_soft_shadow_cuda = \
    WALK_KERNELS["closest_point_soft_shadow"].launch
closest_soft_multi_shadow_cuda = \
    WALK_KERNELS["closest_soft_multi_shadow"].launch
closest_shadow_st_cuda = WALK_KERNELS["closest_shadow_st"].launch
closest_multi_shadow_st_cuda = WALK_KERNELS["closest_multi_shadow_st"].launch
closest_soft_shadow_st_cuda = WALK_KERNELS["closest_soft_shadow_st"].launch
closest_point_soft_shadow_st_cuda = \
    WALK_KERNELS["closest_point_soft_shadow_st"].launch
closest_soft_multi_shadow_st_cuda = \
    WALK_KERNELS["closest_soft_multi_shadow_st"].launch
closest_shadow_tex_cuda = WALK_KERNELS["closest_shadow_tex"].launch
closest_multi_shadow_tex_cuda = WALK_KERNELS["closest_multi_shadow_tex"].launch
closest_soft_shadow_tex_cuda = WALK_KERNELS["closest_soft_shadow_tex"].launch
closest_point_soft_shadow_tex_cuda = \
    WALK_KERNELS["closest_point_soft_shadow_tex"].launch
closest_soft_multi_shadow_tex_cuda = \
    WALK_KERNELS["closest_soft_multi_shadow_tex"].launch
closest_attrs_cuda = WALK_KERNELS["closest_attrs"].launch
closest_attrs_tex_cuda = WALK_KERNELS["closest_attrs_tex"].launch
closest_cuda = WALK_KERNELS["closest"].launch
first_hit_cuda = WALK_KERNELS["first_hit"].launch
any_cuda = WALK_KERNELS["any"].launch
any_soft_cuda = WALK_KERNELS["any_soft"].launch
any_point_soft_cuda = WALK_KERNELS["any_point_soft"].launch
binary_closest_cuda = WALK_KERNELS["binary_closest"].launch
binary_any_cuda = WALK_KERNELS["binary_any"].launch
w8t_any_cuda = WALK_KERNELS["w8t_any"].launch
w8t_closest_cuda = WALK_KERNELS["w8t_closest"].launch
w8t_closest_attrs_cuda = WALK_KERNELS["w8t_closest_attrs"].launch
w8t_closest_attrs_tex_cuda = WALK_KERNELS["w8t_closest_attrs_tex"].launch

# The plain versions of the attrs=0 and attrs=2 variants.
closest_shadow_st_reference = WALK_KERNELS["closest_shadow_st"].reference
closest_multi_shadow_st_reference = \
    WALK_KERNELS["closest_multi_shadow_st"].reference
closest_soft_shadow_st_reference = \
    WALK_KERNELS["closest_soft_shadow_st"].reference
closest_point_soft_shadow_st_reference = \
    WALK_KERNELS["closest_point_soft_shadow_st"].reference
closest_soft_multi_shadow_st_reference = \
    WALK_KERNELS["closest_soft_multi_shadow_st"].reference
closest_shadow_tex_reference = WALK_KERNELS["closest_shadow_tex"].reference
closest_multi_shadow_tex_reference = \
    WALK_KERNELS["closest_multi_shadow_tex"].reference
closest_soft_shadow_tex_reference = \
    WALK_KERNELS["closest_soft_shadow_tex"].reference
closest_point_soft_shadow_tex_reference = \
    WALK_KERNELS["closest_point_soft_shadow_tex"].reference
closest_soft_multi_shadow_tex_reference = \
    WALK_KERNELS["closest_soft_multi_shadow_tex"].reference
closest_attrs_tex_reference = WALK_KERNELS["closest_attrs_tex"].reference
w8t_closest_attrs_tex_reference = \
    WALK_KERNELS["w8t_closest_attrs_tex"].reference

CUDA_KERNELS = tuple(w.launch for w in WALK_KERNELS.values())


# ---------------------------------------------------------------------------
# Inputs and wrappers
# ---------------------------------------------------------------------------

def _vec(x, device) -> torch.Tensor:
    """A piece of a kernel's scalar block as a 1-D float32 tensor on
    ``device``: host data (copied there), or a view of the frame's block
    of constants (``frame_block.FrameBlock``) as it is."""
    return as_f32(x, device).reshape(-1)


def _dir_scalars(ld, device):
    """Toward-light direction(3) and its clamped inverse(3)."""
    d = _vec(ld, device)
    return [d, torch.clamp(1.0 / d, -_BIG, _BIG)]


def _root_box(bvh: WideBVH):
    return [bvh.root_min.to(torch.float32), bvh.root_max.to(torch.float32)]


def _cone_scalars(axis_dir, cone_cos, device):
    """Cone axis(3), its Duff basis t0(3), t1(3), cone_cos."""
    axis = _vec(axis_dir, device)
    t0, t1 = onb3(axis)
    return [axis, t0, t1, _vec(cone_cos, device)]


def _shadow_scalars(bvh: WideBVH, light_dir, bias, light_pos, device):
    """f32[4] (point: position, bias) or f32[13] (directional: dir,
    clamped 1/dir, bias, root box min, max)."""
    b = _vec(bias, device)
    if light_pos is not None:
        return torch.cat([_vec(light_pos, device), b])
    return torch.cat(_dir_scalars(light_dir, device) + [b]
                     + _root_box(bvh))


def _walk_kwargs(bvh: WideBVH, t_min, stack_size) -> dict:
    return dict(leaf_size=bvh.leaf_size, t_min=float(t_min),
                max_iters=iter_cap(bvh.num_wide), stack_size=stack_size)


def _fused_inputs(bvh: WideBVH, origins, dirs, attr_tables, t_max, t_min,
                  stack_size, scal_fn, **kw):
    """Pack image rays for a fused kernel -> (args, kwargs, p, meta):
    ``kernel(*args, **kwargs)`` or its plain version (with
    ``attr_tables`` None, the attrs=0 ``*_st`` pair, whose arguments hold
    no tables); ``p`` and ``meta`` unpack the outputs. ``scal_fn(device)``
    makes the scalar block."""
    rays, p, meta = _ray_packets_packed(origins, dirs, t_max, batch=1)
    tables = () if attr_tables is None else tuple(attr_tables)
    args = (rays, bvh.nodes, bvh.tris, *tables, scal_fn(rays.device))
    return args, dict(_walk_kwargs(bvh, t_min, stack_size), **kw), p, meta


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
        blocks = [_vec(bias, dev)] + _root_box(bvh)
        for ld, lp in lights:
            blocks += [_vec(lp, dev)] if lp is not None \
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
                              + _root_box(bvh) + [_vec(bias, dev)]),
        spp=int(spp), seed=seed_arg(seed), zero_stream=bool(zero_stream))


def closest_point_soft_shadow_inputs(bvh: WideBVH, origins, dirs, light_pos,
                                     radius, spp: int, seed: int, bias,
                                     attr_tables, t_max=_BIG,
                                     t_min: float = 0.0,
                                     zero_stream: bool = False,
                                     stack_size: int = STACK_CAPACITY):
    """Inputs of the disk kernel (scal f32[5])."""
    return _fused_inputs(
        bvh, origins, dirs, attr_tables, t_max, t_min, stack_size,
        lambda dev: torch.cat([_vec(light_pos, dev), _vec(radius, dev),
                               _vec(bias, dev)]),
        spp=int(spp), seed=seed_arg(seed), zero_stream=bool(zero_stream))


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
        blocks = [_vec(bias, dev)] + _root_box(bvh)
        blocks += [_vec(vec, dev), _vec(scalar, dev)] \
            if kind == "disk" else _cone_scalars(vec, scalar, dev)
        for ld in extra_dirs:
            blocks += _dir_scalars(ld, dev)
        return torch.cat(blocks)
    return _fused_inputs(bvh, origins, dirs, attr_tables, t_max, t_min,
                         stack_size, scal, spp=int(spp),
                         seed=seed_arg(seed), zero_stream=bool(zero_stream),
                         disk=kind == "disk",
                         n_extra=len(extra_dirs))


def _leaves(bvh):
    """The leaf triangles a walk reads: a WideBVH's rows, a WideBVHT's
    transposed blocks."""
    return bvh.tris_t if isinstance(bvh, WideBVHT) else bvh.tris


def closest_attrs_inputs(bvh, origins, dirs, attr_tables,
                         t_max=_BIG, t_min: float = 0.0,
                         stack_size: int = STACK_CAPACITY):
    """Inputs of ``closest_attrs_cuda`` / ``closest_attrs_reference`` (on a
    WideBVHT with its transposed rows, of the ``w8t_closest_attrs`` pair)
    -> (args, kwargs, p, meta)."""
    rays, p, meta = _ray_packets_packed(origins, dirs, t_max, batch=1)
    args = (rays, bvh.nodes, _leaves(bvh), attr_tables[0], attr_tables[1])
    return args, _walk_kwargs(bvh, t_min, stack_size), p, meta


def closest_inputs(bvh, origins, dirs, t_max=_BIG,
                   t_min: float = 0.0, stack_size: int = STACK_CAPACITY):
    """Inputs of ``closest_cuda`` / ``closest_reference`` (on a WideBVHT,
    of ``w8t_closest_cuda`` / ``w8t_closest_reference``): rays (H, W, 3)
    or (N, 3), t_max a scalar or per ray -> (args, kwargs, p, meta)."""
    rays, p, meta = _ray_packets_packed(origins, dirs, t_max, batch=1)
    args = (rays, bvh.nodes, _leaves(bvh))
    return args, _walk_kwargs(bvh, t_min, stack_size), p, meta


# The any-hit walks take the same block and accel.
any_inputs = closest_inputs


def as_packed(bvh):
    """The accel a tracer walks: an LBVH is packed (``tpurt``'s
    ``_as_packed``, per call); a PackedBVH, a WideBVH or a WideBVHT is
    taken as it is."""
    return pack_bvh(bvh) if isinstance(bvh, LBVH) else bvh


def is_binary(bvh) -> bool:
    """Does the accel go through the binary walks?"""
    return isinstance(bvh, (LBVH, PackedBVH))


def binary_closest_inputs(bvh, origins, dirs, t_max=_BIG, t_min: float = 0.0,
                          stack_size: int = STACK_CAPACITY):
    """Inputs of ``binary_closest_cuda`` / ``binary_closest_reference`` on
    an LBVH (packed here) or a PackedBVH: rays (H, W, 3) or (N, 3), t_max
    a scalar or per ray -> (args, kwargs, p, meta). The ray block's
    clamped 1/d is the binary kernels' in-kernel ``_inv3``, bit for
    bit."""
    packed = as_packed(bvh)
    rays, p, meta = _ray_packets_packed(origins, dirs, t_max, batch=1)
    kwargs = dict(leaf_size=packed.leaf_size, t_min=float(t_min),
                  max_iters=iter_cap(packed.num_internal),
                  stack_size=stack_size)
    return (rays, packed.nodes, packed.tris), kwargs, p, meta


# The any-hit walk takes the same block and tree.
binary_any_inputs = binary_closest_inputs


def _soft_inputs(bvh, origins, valid, scal_fn, spp, seed, light, t_min,
                 zero_stream, stack_size, packed):
    rays, p, meta = packed if packed is not None \
        else _pack_soft_origins(origins, valid, batch=1)
    args = (rays, bvh.nodes, bvh.tris, scal_fn(rays.device))
    kwargs = dict(_walk_kwargs(bvh, t_min, stack_size), spp=int(spp),
                  seed=seed_arg(seed), light=int(light),
                  zero_stream=bool(zero_stream))
    return args, kwargs, p, meta


def any_soft_inputs(bvh: WideBVH, origins, valid, axis_dir, cone_cos,
                    spp: int, seed: int, light: int = 0, t_min: float = 0.0,
                    zero_stream: bool = False,
                    stack_size: int = STACK_CAPACITY, packed=None):
    """Inputs of the standalone cone kernel (scal f32[16]). ``packed``:
    the origins block already packed, (f32[PB, 4, 8, 128], p, meta), in
    place of ``origins`` and ``valid``."""
    return _soft_inputs(
        bvh, origins, valid,
        lambda dev: torch.cat(_cone_scalars(axis_dir, cone_cos, dev)
                              + _root_box(bvh)),
        spp, seed, light, t_min, zero_stream, stack_size, packed)


def any_point_soft_inputs(bvh: WideBVH, origins, valid, light_pos, radius,
                          spp: int, seed: int, light: int = 0,
                          t_min: float = 0.0, zero_stream: bool = False,
                          stack_size: int = STACK_CAPACITY, packed=None):
    """Inputs of the standalone disk kernel (scal f32[4]); ``packed`` as
    for ``any_soft_inputs``."""
    return _soft_inputs(
        bvh, origins, valid,
        lambda dev: torch.cat([_vec(light_pos, dev), _vec(radius, dev)]),
        spp, seed, light, t_min, zero_stream, stack_size, packed)


# The closest walk's rows of csrc/fused_shadows.cu by (mode, attrs).
_FUSED_ROWS = {(w.mode, w.attrs): w for w in WALK_KERNELS.values()
               if w.entry == _FUSED}


def _fused_pair(mode: int, attr_tables, textured: bool, device):
    """The kernel or plain version of fused ``mode`` for ``device``, in the
    variant of ``tpurt``'s ``attrs``: 0 without attribute tables (the
    shade-table G-buffer), 1 with them, 2 with them on a textured mesh."""
    w = _FUSED_ROWS[mode, 0 if attr_tables is None else 2 if textured else 1]
    return _pick(device, w.launch, w.reference)


@dataclasses.dataclass
class FusedLaunch:
    """A fused launch's outputs as the kernel or its plain version wrote
    them, in the packet layout (``_fused_launch``): ``attrs`` the
    attribute channels f32[PB, ATTR_CH, 8, 128] (attrs=1, 2; None for
    attrs=0, whose t f32[PB, 8, 128] and sorted index i32[PB, 8, 128] are
    ``hit``), ``shadow`` the mode's i32[PB, 8, 128] blocks (occlusion,
    counts or mask; counts then mask for SOFT_MULTI), ``counts`` the walk
    counts i32[2], ``rays`` the packed ray block f32[PB, 10, 8, 128], ``p``
    and ``meta``, which ``_unpack`` takes, and the fused ``mode``.
    ``kernels/resolve.py`` takes an attrs=1 launch as it is."""

    attrs: Optional[torch.Tensor]
    shadow: Tuple[torch.Tensor, ...]
    counts: torch.Tensor
    rays: torch.Tensor
    p: int
    meta: tuple
    mode: int
    hit: Tuple[torch.Tensor, ...] = ()

    def unpacked(self) -> tuple:
        """The outputs image-shaped, as the fused wrappers return them:
        the channel dict, or t and the sorted index; the mode's shadow
        outputs (HARD's occlusion as bool); the walk counts."""
        head = _hit_outputs(self.hit or (self.attrs,), self.p, self.meta)
        shadow = [_unpack(b[:self.p], self.meta) for b in self.shadow]
        if self.mode == HARD:
            shadow[0] = shadow[0] > 0
        return (*head, *shadow, self.counts)


def _hit_outputs(hit, p, meta) -> tuple:
    """A closest launch's phase-1 outputs, image-shaped: (channel dict,)
    from the attribute channels, else (t, sidx) with misses (inf, -1), as
    ``tpurt``'s wrappers return them."""
    if len(hit) == 1:
        return (_attr_channels(hit[0], p, meta),)
    t, sidx = _unpack(hit[0][:p], meta), _unpack(hit[1][:p], meta)
    return torch.where(sidx >= 0, t, torch.inf), sidx


def _fused_launch(mode: int, inputs, attr_tables,
                  textured: bool) -> FusedLaunch:
    """ONE launch of fused ``mode`` on its ``*_inputs`` ``inputs``, in the
    variant the tables and ``textured`` select: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    args, kwargs, p, meta = inputs
    rays = args[0]
    fn = _fused_pair(mode, attr_tables, textured, rays.device)
    res = fn(*args, **kwargs)
    if attr_tables is None:
        return FusedLaunch(None, tuple(res[2:-1]), res[-1], rays, p, meta,
                           mode, hit=tuple(res[:2]))
    return FusedLaunch(res[0], tuple(res[1:-1]), res[-1], rays, p, meta,
                       mode)


def trace_closest_shadow(bvh: WideBVH, origins, dirs, light_dir, bias,
                         t_max=_BIG, t_min: float = 0.0, light_pos=None,
                         attr_tables=None, stack_size: int = STACK_CAPACITY,
                         textured: bool = False):
    """Fused primary visibility + light-0 hard shadow (ONE kernel launch).

    origins/dirs f32[H, W, 3]; light_dir f32[3] toward the light (used when
    ``light_pos`` is None); light_pos f32[3] for a hard point light; bias:
    the normal-offset shadow bias; attr_tables (at0, at1): the leaf
    attribute rows; ``textured`` (with them): the attrs=2 variant, which
    also returns the winner's interpolated uv and layer (every fused
    wrapper and ``trace_closest_attrs`` take it). Returns (channel dict,
    occluded bool[H, W], counts i32[2]); without attribute tables
    (attrs=0) (t f32[H, W], sidx i32[H, W], occluded, counts), misses
    (inf, -1). Every fused wrapper returns its t and sidx so. CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    return _fused_launch(HARD, closest_shadow_inputs(
        bvh, origins, dirs, light_dir, bias, attr_tables, t_max, t_min,
        light_pos, stack_size), attr_tables, textured).unpacked()


def trace_closest_multi_shadow(bvh: WideBVH, origins, dirs, lights, bias,
                               t_max=_BIG, t_min: float = 0.0,
                               attr_tables=None,
                               stack_size: int = STACK_CAPACITY,
                               textured: bool = False):
    """Fused primary visibility + N hard shadows (ONE kernel launch).
    lights: (light_dir, light_pos) pairs as ``tpurt``'s
    ``trace_closest_multi_shadow_pallas`` takes them (at most 31). Returns
    (channel dict, occ_mask i32[H, W] with bit l = light l occluded,
    counts i32[2]), or (t, sidx, occ_mask, counts) without tables."""
    return _fused_launch(MULTI, closest_multi_shadow_inputs(
        bvh, origins, dirs, lights, bias, attr_tables, t_max, t_min,
        stack_size), attr_tables, textured).unpacked()


def trace_closest_soft_shadow(bvh: WideBVH, origins, dirs, axis_dir,
                              cone_cos, spp: int, seed: int, bias,
                              t_max=_BIG, t_min: float = 0.0,
                              attr_tables=None, zero_stream: bool = False,
                              stack_size: int = STACK_CAPACITY,
                              textured: bool = False):
    """Fused primary visibility + area-light (cone) soft shadows (ONE
    kernel launch). Returns (channel dict, occlusion counts i32[H, W] in
    [0, spp], walk counts i32[2]), or (t, sidx, counts, walk counts)
    without tables; visibility = 1 - counts / spp."""
    return _fused_launch(SOFT, closest_soft_shadow_inputs(
        bvh, origins, dirs, axis_dir, cone_cos, spp, seed, bias,
        attr_tables, t_max, t_min, zero_stream, stack_size), attr_tables,
        textured).unpacked()


def trace_closest_point_soft_shadow(bvh: WideBVH, origins, dirs, light_pos,
                                    radius, spp: int, seed: int, bias,
                                    t_max=_BIG, t_min: float = 0.0,
                                    attr_tables=None,
                                    zero_stream: bool = False,
                                    stack_size: int = STACK_CAPACITY,
                                    textured: bool = False):
    """Fused primary visibility + point-light penumbra (ONE kernel
    launch). Returns (channel dict, counts i32[H, W] in [0, spp], walk
    counts i32[2]), or (t, sidx, counts, walk counts) without tables."""
    return _fused_launch(PSOFT, closest_point_soft_shadow_inputs(
        bvh, origins, dirs, light_pos, radius, spp, seed, bias, attr_tables,
        t_max, t_min, zero_stream, stack_size), attr_tables,
        textured).unpacked()


def trace_closest_soft_multi_shadow(bvh: WideBVH, origins, dirs, light0,
                                    extra_dirs, spp: int, seed: int, bias,
                                    t_max=_BIG, t_min: float = 0.0,
                                    attr_tables=None,
                                    zero_stream: bool = False,
                                    stack_size: int = STACK_CAPACITY,
                                    textured: bool = False):
    """Fused primary + soft light 0 + hard directional extras (ONE kernel
    launch). light0: ("cone", axis, cone_cos) or ("disk", position,
    radius). Returns (channel dict, counts0 i32[H, W], occ_mask i32[H, W]
    with bit i = extra light i, walk counts i32[2]), or (t, sidx, counts0,
    occ_mask, walk counts) without tables."""
    return _fused_launch(SOFT_MULTI, closest_soft_multi_shadow_inputs(
        bvh, origins, dirs, light0, extra_dirs, spp, seed, bias, attr_tables,
        t_max, t_min, zero_stream, stack_size), attr_tables,
        textured).unpacked()


def trace_closest_attrs(bvh: WideBVH, origins, dirs, attr_tables,
                        t_max=_BIG, t_min: float = 0.0,
                        stack_size: int = STACK_CAPACITY,
                        textured: bool = False):
    """Attribute-tracked closest hit (ONE kernel launch): the G-buffer of
    the unfused frame, on the row-layout accel (a WideBVHT takes
    ``trace_closest_attrs_t``). Returns (channel dict, walk counts
    i32[2])."""
    if isinstance(bvh, WideBVHT):
        raise ValueError("a WideBVHT walks through trace_closest_attrs_t")
    fn = _fused_pair(CLOSEST, attr_tables, textured, origins.device)
    args, kwargs, p, meta = closest_attrs_inputs(
        bvh, origins, dirs, attr_tables, t_max, t_min, stack_size)
    out, counts = fn(*args, **kwargs)
    return _attr_channels(out, p, meta), counts


def trace_closest_attrs_t(bvh: WideBVHT, origins, dirs, attr_tables,
                          t_max=_BIG, t_min: float = 0.0,
                          stack_size: int = STACK_CAPACITY,
                          textured: bool = False):
    """The w8t attribute-tracked closest hit (ONE kernel launch;
    ``tpurt``'s ``trace_closest_attrs_pallas_t``): a WideBVHT and its
    transposed attribute rows (``make_leaf_attr_rows_t`` of the same
    LBVH). Returns (channel dict, walk counts i32[2]), as
    ``trace_closest_attrs``; without ``textured`` the raw layer channel
    is -1 on every ray."""
    if not isinstance(bvh, WideBVHT):
        raise ValueError("trace_closest_attrs_t walks a WideBVHT")
    fn = _pick(origins.device,
               w8t_closest_attrs_tex_cuda if textured
               else w8t_closest_attrs_cuda,
               w8t_closest_attrs_tex_reference if textured
               else w8t_closest_attrs_reference)
    args, kwargs, p, meta = closest_attrs_inputs(
        bvh, origins, dirs, attr_tables, t_max, t_min, stack_size)
    out, counts = fn(*args, **kwargs)
    return _attr_channels(out, p, meta), counts


def trace_closest(bvh, origins, dirs, t_max=_BIG,
                  t_min: float = 0.0, return_sorted: bool = False,
                  gather_tri_id: bool = True,
                  stack_size: int = STACK_CAPACITY, seeded: bool = False,
                  variant: str = "lanes"):
    """Closest hit (ONE kernel launch), ``tpurt``'s
    ``trace_closest_pallas``: over a WideBVH the plain closest hit (mode
    NEAREST), over a WideBVHT the w8t closest hit (W8T_CLOSEST), over an
    LBVH (packed per call) or a PackedBVH the binary walk (BIN_CLOSEST).
    origins/dirs (H, W, 3) or (N, 3), t_max a scalar
    or per ray. Returns (t, tri_id, walk counts) with misses (inf,
    -1); ``return_sorted`` adds the sorted hit index, the key of the shade
    table: (t, tri_id, sidx, walk counts); ``gather_tri_id=False`` (with
    ``return_sorted``) leaves tri_id to the table's id lane: (t, None,
    sidx, walk counts).

    ``seeded=True`` (a WideBVH with ``variant="lanes"``; two launches)
    is ``tpurt``'s seeded G-buffer: the first-hit walk (FIRST_HIT) gives
    each ray an upper bound on its closest hit, loosened into its t_max
    (``seed_cap``), and the closest hit (NEAREST) starts from those caps.
    t and the triangle are the unseeded walk's; the sorted index may name
    another SBVH reference of the same triangle (ROADMAP decision 20). The
    walk counts sum both launches'.

    ``variant`` follows ``tpurt``'s dispatch, and like ``tpurt`` the
    string is not validated. A WideBVHT ignores it (and ``seeded``), as
    ``tpurt`` takes that branch first. On a WideBVH "lanes" is the
    batched walk, the only branch that reads ``seeded``; any other value
    is ``tpurt``'s unbatched walk (``_closest_hit_kernel_w8``), which
    computes NEAREST's function, so it launches NEAREST and ignores
    ``seeded``. On a binary tree ``seeded`` is ignored; "frustum" is
    ``tpurt``'s packet-frustum walk (``_closest_hit_kernel_v2``), whose
    culling only schedules the TPU's packet, so it launches BIN_CLOSEST
    as every other value does (ROADMAP decision 23)."""
    if not (gather_tri_id or return_sorted):
        raise ValueError("gather_tri_id=False requires return_sorted")
    if is_binary(bvh) or variant != "lanes":
        seeded = False
    if is_binary(bvh):
        bvh = as_packed(bvh)
        fn = _pick(origins.device, binary_closest_cuda,
                   binary_closest_reference)
        inputs_fn = binary_closest_inputs
    elif isinstance(bvh, WideBVHT):
        fn = _pick(origins.device, w8t_closest_cuda, w8t_closest_reference)
        inputs_fn = closest_inputs
        seeded = False
    else:
        fn = _pick(origins.device, closest_cuda, closest_reference)
        inputs_fn = closest_inputs
    args, kwargs, p, meta = inputs_fn(bvh, origins, dirs, t_max, t_min,
                                      stack_size)
    seed_counts = 0
    if seeded:
        first = _pick(origins.device, first_hit_cuda, first_hit_reference)
        t1, s1, seed_counts = first(*args, **kwargs)
        rays = args[0].clone()
        rays[:, 9] = seed_cap(args[0], t1, s1)
        args = (rays, *args[1:])
    res = fn(*args, **kwargs)
    t, sidx = _hit_outputs(res[:2], p, meta)
    counts = res[2] + seed_counts
    if not gather_tri_id:
        return t, None, sidx, counts
    n = bvh.tri_id.shape[0]
    tri_id = torch.where(sidx >= 0,
                         bvh.tri_id[torch.clamp(sidx, 0, n - 1).long()], -1)
    return (t, tri_id, sidx, counts) if return_sorted \
        else (t, tri_id, counts)


def trace_any(bvh, origins, dirs, t_max, t_min: float = 0.0,
              stack_size: int = STACK_CAPACITY, variant: str = "lanes"):
    """Occlusion query (ONE kernel launch; mode ANY over a WideBVH,
    W8T_ANY over a WideBVHT, BIN_ANY over an LBVH or a PackedBVH): True
    where something lies in (t_min, t_max); rays with t_max <= t_min are
    inactive and return False. origins/dirs (H, W, 3) or (N, 3). Returns
    (occluded bool[H, W] or [N], walk counts i32[2]).

    ``variant`` follows ``tpurt``'s ``trace_any_pallas`` dispatch, and
    like ``tpurt`` the string is not validated: a WideBVHT ignores it; on
    a WideBVH "lanes" is the batched walk, any other value the unbatched
    one (``_any_hit_kernel_w8``, or with "x2" the dual-pop
    ``_any_hit_kernel_w8_x2``); on a binary tree "frustum" is the
    packet-frustum walk (``_any_hit_kernel_v2``), any other value the
    plain one. The unbatched, dual-pop and frustum walks compute the
    occlusion of the per-ray walk (the second pop and the frustum only
    schedule the TPU's packet), so each launches ANY or BIN_ANY (ROADMAP
    decision 23)."""
    if is_binary(bvh):
        fn = _pick(origins.device, binary_any_cuda, binary_any_reference)
        inputs_fn = binary_any_inputs
    elif isinstance(bvh, WideBVHT):
        fn = _pick(origins.device, w8t_any_cuda, w8t_any_reference)
        inputs_fn = any_inputs
    else:
        fn = _pick(origins.device, any_cuda, any_reference)
        inputs_fn = any_inputs
    args, kwargs, p, meta = inputs_fn(bvh, origins, dirs, t_max, t_min,
                                      stack_size)
    occ, counts = fn(*args, **kwargs)
    return _unpack(occ[:p], meta) > 0, counts


def trace_any_soft(bvh: WideBVH, origins, valid, axis_dir, cone_cos,
                   spp: int, seed: int, light: int = 0, t_min: float = 0.0,
                   zero_stream: bool = False,
                   stack_size: int = STACK_CAPACITY, packed=None):
    """Area-light (cone) soft shadows from given biased origins (ONE kernel
    launch), sampled in the kernel with the generator key (seed, light).
    origins (H, W, 3) with valid bool[H, W], or (N, 3) with [N]. Returns
    (occlusion counts i32 in [0, spp], walk counts i32[2]). ``packed``:
    the origins block already packed, (f32[P, 4, 8, 128], p, meta), in
    place of ``origins`` and ``valid``; the counts then stay in packets,
    i32[P, 8, 128]."""
    args, kwargs, p, meta = any_soft_inputs(
        bvh, origins, valid, axis_dir, cone_cos, spp, seed, light, t_min,
        zero_stream, stack_size, packed)
    fn = _pick(args[0].device, any_soft_cuda, any_soft_reference)
    cnt, counts = fn(*args, **kwargs)
    return (cnt if packed is not None else _unpack(cnt[:p], meta)), counts


def trace_any_point_soft(bvh: WideBVH, origins, valid, light_pos, radius,
                         spp: int, seed: int, light: int = 0,
                         t_min: float = 0.0, zero_stream: bool = False,
                         stack_size: int = STACK_CAPACITY, packed=None):
    """Point-light penumbra from given biased origins (ONE kernel launch):
    spp jittered-disk samples keyed by (seed, light). Returns (counts i32
    in [0, spp], walk counts i32[2]); ``packed`` as for
    ``trace_any_soft``."""
    args, kwargs, p, meta = any_point_soft_inputs(
        bvh, origins, valid, light_pos, radius, spp, seed, light, t_min,
        zero_stream, stack_size, packed)
    fn = _pick(args[0].device, any_point_soft_cuda, any_point_soft_reference)
    cnt, counts = fn(*args, **kwargs)
    return (cnt if packed is not None else _unpack(cnt[:p], meta)), counts
