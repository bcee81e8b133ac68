"""Binary LBVH -> 8-wide BVH collapse (counterpart of
``tpurt/bvh/wide.py``): the area frontier and the fixed depth-3 cut.

Two collapses of the area-greedy rule:

- once per scene (static path, and the rebuild path's pad count): plain
  tensor code, the area-greedy frontiers of every node, the 64-sweep
  reachability of wide roots, dense wide ids in binary-node order and the
  one-gather row assembly (tests/test_torch_accel.py);
- every frame of the rebuild (``widen_area_kernel``): the breadth-first
  collapse kernel (``kernels/build.collapse_area``), whose wide ids are BFS
  positions, and the same kind of row assembly, with node boxes from range
  queries over the leaf boxes (tests/test_torch_rebuild.py).

The fixed cut (``mode="fixed"``, the rebuild's ``rebuild_collapse=
"fixed"``) takes every internal node at depth % 3 == 0 as a wide node,
whose children are its 3-level frontier: ``widen_lbvh`` on a full- or
deferred-box build, with the topology kernel's depths or
``node_depths``' pointer doubling, dense wide ids in binary-node order,
and no host sync (``wide_count_device`` gives the count as a device
scalar).

Then the per-frame near-first child ordering, ``build_wide`` (count,
then widen into a bucketed pad) and the w8t accel: ``build_wide_t``
keeps the nodes and transposes the LBVH's leaf triangles into blocks of
14 (leaf 8) or 7 (leaf 16) leaves (``WideBVHT``, ``transpose_leaf_rows``).
Every step reproduces the JAX package's arrays exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..kernels.build import (EMPTY, WIDE_FACTOR, collapse_area, greedy_slots,
                             node_depths)
from ..camera import as_f32
from ..spans import host_read
from .lbvh import LBVH, _leaf_boxes, range_boxes, range_query, range_table

_BIG = 3.4e38


@dataclasses.dataclass
class WideBVH:
    """8-wide BVH in kernel row layout.

    nodes  : f32[Nw, 128] — child c occupies lanes [16c, 16c+16):
             [bmin.xyz, bmax.xyz, ref, 0...]; ref is a float-encoded exact
             int (>= 0: wide node id, < 0: leaf as -(leaf_id+1)); empty
             slots have inverted boxes (+BIG/-BIG) and ref -1.
    tris   : f32[L, 128] — one leaf per row, k x (v0, e1, e2).
    tri_id : i32[Tpad] sorted position -> original triangle id.
    root_min/max : f32[3]
    num_wide : padded wide-node count (rows beyond the real count are pad)
    leaf_size : triangles per leaf
    """

    nodes: torch.Tensor
    tris: torch.Tensor
    tri_id: torch.Tensor
    root_min: torch.Tensor
    root_max: torch.Tensor
    num_wide: int
    leaf_size: int


@dataclasses.dataclass
class WideBVHT:
    """8-wide BVH with the row-layout nodes and TRANSPOSED leaf triangles
    (``tpurt``'s w8t accel, the only layout that holds 16-triangle
    leaves).

    nodes  : f32[Nw, 128] — the row layout, identical to WideBVH.nodes.
    tris_t : f32[ceil(L / lpb), 8, 128] — lpb = 14 leaves per block at
             leaf_size 8, 7 at leaf_size 16; field f (v0.xyz, e1.xyz,
             e2.xyz) of triangle 8h + t of leaf lpb*b + j lies at
             [b, t, unit*j + 9h + f] with unit = 9 * (leaf_size / 8);
             lanes 126 and 127 are zero. A triangle's nine fields are
             consecutive words.
    tri_id, root_min, root_max, num_wide, leaf_size : as in WideBVH.
    num_leaves : the leaves (triangle blocks) the blocks hold.
    """

    nodes: torch.Tensor
    tris_t: torch.Tensor
    tri_id: torch.Tensor
    root_min: torch.Tensor
    root_max: torch.Tensor
    num_wide: int
    num_leaves: int
    leaf_size: int


LEAVES_PER_BLOCK = 14    # leaf_size 8:  14 leaves x 9 fields = 126 lanes
LEAVES_PER_BLOCK16 = 7   # leaf_size 16: 7 leaves x 2 groups x 9 = 126


def leaves_per_block(leaf_size: int) -> int:
    if leaf_size not in (8, 16):
        raise ValueError(f"the transposed layout needs leaf_size 8 or 16, "
                         f"got {leaf_size}")
    return LEAVES_PER_BLOCK if leaf_size == 8 else LEAVES_PER_BLOCK16


def transpose_leaf_rows(rows9: torch.Tensor, k: int) -> torch.Tensor:
    """[Tpad, 9] per-triangle field rows -> the transposed
    f32[ceil(nl / lpb), 8, 128] blocks (``WideBVHT.tris_t``'s lane map):
    field f of triangle 8h + t of leaf j at [blk, t, unit*j + 9h + f].
    The geometry (``build_wide_t``) and the transposed attribute rows
    (``passes/shading.make_leaf_attr_rows_t``) share it, so a triangle's
    attributes lie at its geometry's address."""
    lpb = leaves_per_block(k)
    nl = rows9.shape[0] // k
    rows9 = rows9.reshape(nl, k, 9)
    nlb = -(-nl // lpb)
    if nlb * lpb > nl:
        rows9 = torch.cat([rows9, rows9.new_zeros((nlb * lpb - nl, k, 9))])
    if k == 8:
        out = (rows9.reshape(nlb, lpb, k, 9)
               .permute(0, 2, 1, 3).reshape(nlb, 8, 126))
    else:
        # leaf j at lanes 18j, sublane group h in {0, 1}: triangle 8h + t.
        out = (rows9.reshape(nlb, lpb, 2, 8, 9)
               .permute(0, 3, 1, 2, 4).reshape(nlb, 8, 126))
    return torch.nn.functional.pad(out, (0, 2)).contiguous()


def build_wide_t(wide: WideBVH, bvh: LBVH) -> WideBVHT:
    """The 8-wide accel ``wide`` and the LBVH it was widened from -> the
    WideBVHT (``tpurt``'s ``build_wide_t``): the same nodes, the leaf
    triangles of the LBVH transposed (a leaf-16 accel's ``wide.tris`` is
    a placeholder)."""
    k = wide.leaf_size
    tri9 = torch.stack([bvh.tri_v0, bvh.tri_e1, bvh.tri_e2],
                       dim=1).reshape(-1, 9)
    return WideBVHT(nodes=wide.nodes, tris_t=transpose_leaf_rows(tri9, k),
                    tri_id=wide.tri_id, root_min=wide.root_min,
                    root_max=wide.root_max, num_wide=wide.num_wide,
                    num_leaves=tri9.shape[0] // k, leaf_size=k)


def area_key(ext: torch.Tensor) -> torch.Tensor:
    """f32[N] expansion keys e0*e1 + e1*e2 + e2*e0 of box extents f32[N, 3],
    rounded as the JAX package's jitted code rounds them.

    XLA contracts the sum into fma(e2, e0, fma(e0, e1, e1*e2)) under jit.
    Products of two floats are exact in float64, so each fused step is one
    float64 add rounded to float32; equal slot areas must tie exactly for
    the first-maximum rule to pick the same slot."""
    ext = ext.double()
    e0, e1, e2 = ext[:, 0], ext[:, 1], ext[:, 2]
    inner = (e1 * e2).float().double()
    mid = (e0 * e1 + inner).float().double()
    return (e2 * e0 + mid).float()


def frontiers_area(child: torch.Tensor, nodes_box: torch.Tensor
                   ) -> torch.Tensor:
    """i32[Ni, 8] SAH-greedy frontiers of every internal node: expand the
    LARGEST-AREA internal slot while the row has < 8 slots (the first
    maximum winning, as ``jnp.argmax``)."""
    own_min = torch.minimum(nodes_box[:, 0:3], nodes_box[:, 6:9])
    own_max = torch.maximum(nodes_box[:, 3:6], nodes_box[:, 9:12])
    area = area_key(torch.clamp(own_max - own_min, min=0.0))
    return greedy_slots(child, area,
                        torch.arange(child.shape[0], device=child.device))


def wide_roots_reachable(child: torch.Tensor, front: torch.Tensor,
                         sweeps: int) -> torch.Tensor:
    """bool[Ni]: the root is wide; every internal ref inside a wide node's
    frontier is wide. ``sweeps`` scatter-max passes, as in the reference."""
    ni = child.shape[0]
    wide = torch.zeros((ni,), dtype=torch.int32, device=child.device)
    wide[0] = 1
    for _ in range(sweeps):
        new = torch.zeros_like(wide)
        for s in range(WIDE_FACTOR):
            ref = front[:, s]
            is_int = ref >= 0
            tgt = torch.where(is_int, ref, 0).long()
            new = new.scatter_reduce(0, tgt, wide * is_int.to(torch.int32),
                                     "amax", include_self=True)
        wide = torch.maximum(wide, new)
    return wide > 0


def frontiers(child: torch.Tensor) -> torch.Tensor:
    """i32[Ni, 8]: every internal node's 3-level frontier (internal ids >=
    0, leaves as -(leaf+1), EMPTY): two expansion levels, each one batched
    gather over the current slots, left child in place and right child
    after it."""
    ni = child.shape[0]
    refs = child                                        # [Ni, 2]
    for _ in range(2):                                  # levels 2 and 3
        is_int = refs >= 0
        kids = child[refs.clamp(0, ni - 1).long()]      # [Ni, k, 2]
        left = torch.where(is_int, kids[..., 0], refs)
        right = torch.where(is_int, kids[..., 1], EMPTY)
        refs = torch.stack([left, right], dim=-1).reshape(ni, -1)
    return refs


def wide_roots(child: torch.Tensor) -> torch.Tensor:
    """bool[Ni]: the fixed cut's wide nodes. Internal refs sit in a
    frontier exactly 3 levels below its wide node (only leaves end
    early), so the wide nodes are those at depth % 3 == 0."""
    return node_depths(child) % 3 == 0


# The static scenes' frontier: the area-greedy one (tpurt's FRONTIER_MODE).
FRONTIER_MODE = "area"


def _front_and_mask(child, nodes_box=None, mode=None, depths=None):
    """(frontiers i32[Ni, 8], wide mask bool[Ni]) of ``mode``: "area" (the
    default; the reference's 64 sweeps of reachability) or "fixed" (the
    depth-3 cut, its mask from ``depths`` where given, else
    ``node_depths``). A deferred-box build has no node areas, so "area"
    resolves to "fixed" there, as in ``tpurt``."""
    mode = mode or FRONTIER_MODE
    if mode not in ("area", "fixed"):
        raise NotImplementedError(f"frontier mode {mode!r} is not ported")
    if mode == "area" and nodes_box is not None:
        front = frontiers_area(child, nodes_box)
        return front, wide_roots_reachable(child, front, sweeps=64)
    front = frontiers(child)
    if depths is not None:
        return front, depths % 3 == 0
    return front, wide_roots(child)


def count_wide(bvh: LBVH, mode: str = None) -> int:
    """Host sync: number of wide nodes (for choosing the padded size);
    ``mode`` must be the one the widen uses."""
    _, mask = _front_and_mask(bvh.nodes_child, bvh.nodes_box, mode=mode)
    return int(host_read(mask.sum()))


def wide_count_device(bvh: LBVH, mode: str = None,
                      depths=None) -> torch.Tensor:
    """The wide-node count as a device scalar i32[] (no host sync), for a
    rebuild's overflow check; ``depths`` as the widen was given them."""
    _, mask = _front_and_mask(bvh.nodes_child, bvh.nodes_box, mode=mode,
                              depths=depths)
    return mask.sum().to(torch.int32)


def leaf_boxes_from_nodes(bvh: LBVH) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-leaf boxes scattered out of the stored per-child node boxes (on
    SBVH topologies: the clipped boxes, tighter than the triangle union).
    ``scatter_reduce`` with amin/amax is defined on duplicate indices."""
    child = bvh.nodes_child
    nl = bvh.num_leaves
    dev = child.device
    lmin = torch.full((nl, 3), _BIG, dtype=torch.float32, device=dev)
    lmax = torch.full((nl, 3), -_BIG, dtype=torch.float32, device=dev)
    for lo in (0, 6):                       # [lmin lmax rmin rmax] rows
        ref = child[:, 0 if lo == 0 else 1]
        is_leaf = ref < 0
        tgt = torch.where(is_leaf, -ref - 1, 0).long()[:, None].expand(-1, 3)
        bmin = bvh.nodes_box[:, lo:lo + 3]
        bmax = bvh.nodes_box[:, lo + 3:lo + 6]
        lmin = lmin.scatter_reduce(
            0, tgt, torch.where(is_leaf[:, None], bmin, _BIG), "amin",
            include_self=True)
        lmax = lmax.scatter_reduce(
            0, tgt, torch.where(is_leaf[:, None], bmax, -_BIG), "amax",
            include_self=True)
    return lmin, lmax


def _inverted_box(device) -> torch.Tensor:
    """f32[1, 6] [+BIG x3, -BIG x3], the unhittable box of an empty slot,
    made by fills on the device (a tensor from host data would copy and
    sync)."""
    return torch.cat([torch.full((1, 3), _BIG, device=device),
                      torch.full((1, 3), -_BIG, device=device)], dim=1)


def _assemble_wide_nodes(refs, nodes_box, leaf_min, leaf_max, wref):
    """One-gather assembly of the f32[Nw, 128] wide node rows from a
    candidate table [Ni + Nl + 1, 6] (internal: union of stored child
    boxes; leaf: leaf box; last row: inverted, unhittable) plus the
    pre-remapped kernel refs ``wref`` f32[Nw, 8]."""
    ni = nodes_box.shape[0]
    nl = leaf_min.shape[0]
    nw = refs.shape[0]
    dev = nodes_box.device
    int_min = torch.minimum(nodes_box[:, 0:3], nodes_box[:, 6:9])
    int_max = torch.maximum(nodes_box[:, 3:6], nodes_box[:, 9:12])
    table = torch.cat([torch.cat([int_min, int_max], dim=1),
                       torch.cat([leaf_min, leaf_max], dim=1),
                       _inverted_box(dev)])
    row = torch.where(refs >= 0, refs,
                      torch.where(refs == EMPTY, ni + nl, ni + (-refs - 1)))
    rec = table[row.reshape(-1).long()]                 # [Nw*8, 6]
    rec = torch.cat([rec, wref.reshape(-1, 1),
                     torch.zeros((nw * 8, 9), dtype=torch.float32,
                                 device=dev)], dim=1)
    return rec.reshape(nw, 128)


def make_wide_plan(bvh: LBVH, nw_pad: int):
    """Topology-only collapse plan: per wide node, the 8 frontier refs (as
    binary/leaf ids, EMPTY-padded) plus their pre-remapped kernel refs.
    ``nonzero`` has no static size in torch, so the pad is written by
    hand (``jnp.nonzero(size=, fill_value=ni - 1)``)."""
    child = bvh.nodes_child
    ni = child.shape[0]
    dev = child.device
    front, wide = _front_and_mask(child, bvh.nodes_box)
    ids = torch.cumsum(wide.to(torch.int32), dim=0, dtype=torch.int32) - 1
    nz = torch.nonzero(wide)[:, 0][:nw_pad]
    src = torch.full((nw_pad,), ni - 1, dtype=torch.long, device=dev)
    src[:nz.shape[0]] = nz
    rows_front = front[src]
    is_pad = torch.arange(nw_pad, device=dev) >= wide.sum()
    refs = torch.where(is_pad[:, None], EMPTY, rows_front)     # [Nw, 8]
    wref = torch.where(refs >= 0, ids[refs.clamp(0, ni - 1).long()],
                       torch.where(refs == EMPTY, -1, refs))
    return refs, wref.to(torch.float32)


def widen_from_plan(plan, bvh: LBVH, leaf_boxes) -> WideBVH:
    """Assemble the 8-wide node rows from a plan and the leaf boxes
    (``leaf_boxes_from_nodes``), and pack one leaf per 128-lane row."""
    refs, wref = plan
    nw_pad = refs.shape[0]
    leaf_min, leaf_max = leaf_boxes
    nodes = _assemble_wide_nodes(refs, bvh.nodes_box, leaf_min, leaf_max,
                                 wref)
    return WideBVH(nodes=nodes.contiguous(), tris=block_rows(bvh),
                   tri_id=bvh.tri_id, root_min=bvh.root_min,
                   root_max=bvh.root_max, num_wide=nw_pad,
                   leaf_size=bvh.leaf_size)


def _leaf_boxes_from_tris(bvh: LBVH):
    """Per-tree-leaf boxes: the clustered build's own (one side of each
    split block's cut), else the k-chop triangle blocks' unions."""
    if bvh.leaf_block is not None:
        return bvh.leaf_min, bvh.leaf_max
    return _leaf_boxes(bvh.tri_v0, bvh.tri_e1, bvh.tri_e2, bvh.leaf_size)[:2]


def node_areas(bvh: LBVH, tab: torch.Tensor) -> torch.Tensor:
    """f32[Ni] surface-area keys of every internal node, from one batched
    query of the leaf boxes' ``range_table`` (works on deferred-box
    builds)."""
    amin, amax = range_query(tab, bvh.nodes_first, bvh.nodes_last)
    return area_key(torch.clamp(amax - amin, min=0.0))


def assemble_area_rows(bvh: LBVH, leaf_boxes, tab: torch.Tensor, front,
                       src, nw_pad: int) -> torch.Tensor:
    """f32[nw_pad, 128] wide rows from the collapse's BFS frontier: one
    gather over a candidate table of the wide nodes' boxes (range queries
    over their binary roots' leaf spans), the leaf boxes and an inverted
    empty box. Leaf slots carry their triangle BLOCK as the kernel ref;
    refs past the pad (an overflowed collapse) are clamped, and such an
    accel is never rendered."""
    leaf_min, leaf_max = leaf_boxes
    nl = leaf_min.shape[0]
    dev = front.device
    srcl = src.long()
    wmin, wmax = range_query(tab, bvh.nodes_first[srcl],
                             bvh.nodes_last[srcl])
    table = torch.cat([torch.cat([wmin, wmax], dim=1),
                       torch.cat([leaf_min, leaf_max], dim=1),
                       _inverted_box(dev)])
    safe = torch.clamp(front, max=nw_pad - 1)
    row = torch.where(front >= 0, safe,
                      torch.where(front == EMPTY, nw_pad + nl,
                                  nw_pad + (-front - 1)))
    rec = table[row.reshape(-1).long()]                       # [Nw*8, 6]
    leaf = (-front - 1).clamp(0, nl - 1).long()
    lref = front if bvh.leaf_block is None else -(bvh.leaf_block[leaf] + 1)
    kref = torch.where(front >= 0, safe.to(torch.float32),
                       torch.where(front == EMPTY, -1.0,
                                   lref.to(torch.float32)))
    rec = torch.cat([rec, kref.reshape(-1, 1),
                     torch.zeros((nw_pad * 8, 9), dtype=torch.float32,
                                 device=dev)], dim=1)
    return rec.reshape(nw_pad, 128)


def block_rows(bvh: LBVH) -> torch.Tensor:
    """f32[num_blocks, 128]: one triangle block per row, k x (v0, e1,
    e2), zero-padded. A leaf of more than 14 triangles fits no 128-lane
    row: as in ``tpurt``, the rows are then a f32[1, 128] zero
    placeholder, and such an accel is walked through its transposed
    leaves alone (``build_wide_t``); the row kernels refuse its
    leaf_size."""
    k = bvh.leaf_size
    if k * 9 > 128:
        return torch.zeros((1, 128), dtype=torch.float32,
                           device=bvh.tri_v0.device)
    tri9 = torch.stack([bvh.tri_v0, bvh.tri_e1, bvh.tri_e2], dim=1)
    tri9 = tri9.reshape(bvh.num_blocks, k * 9)
    return torch.nn.functional.pad(tri9, (0, 128 - k * 9)).contiguous()


def _wide_ids_and_src(wide: torch.Tensor, nw_pad: int):
    """Dense wide ids i32[Ni] (the cumsum of the mask, -1 based) and each
    wide row's binary node i64[nw_pad], the pad rows at Ni - 1 (``tpurt``'s
    ``jnp.nonzero(size=nw_pad, fill_value=Ni - 1)``), by one scatter and
    no host sync; wide nodes past the pad are dropped."""
    ni = wide.shape[0]
    dev = wide.device
    ids = torch.cumsum(wide.to(torch.int32), dim=0, dtype=torch.int32) - 1
    slot = torch.where(wide & (ids < nw_pad), ids.long(), nw_pad)
    src = torch.full((nw_pad + 1,), ni - 1, dtype=torch.long, device=dev)
    src.scatter_(0, slot, torch.arange(ni, device=dev))
    return ids, src[:nw_pad]


def _assemble_wide_nodes_deferred(refs, src, ids, bvh: LBVH, leaf_min,
                                  leaf_max):
    """One-gather assembly without binary node boxes (a deferred-box
    build): a wide node's box is the range query of its leaf span, so the
    candidate table [Nw + Nl + 1, 6] is indexed by dense wide id. Dense
    ids past the pad (an overflowed cut) are clamped into it; such an
    accel is never rendered."""
    ni = bvh.nodes_child.shape[0]
    nl = leaf_min.shape[0]
    nw = refs.shape[0]
    dev = refs.device
    wmin, wmax = range_boxes(leaf_min, leaf_max, bvh.nodes_first[src],
                             bvh.nodes_last[src])
    table = torch.cat([torch.cat([wmin, wmax], dim=1),
                       torch.cat([leaf_min, leaf_max], dim=1),
                       _inverted_box(dev)])
    dense = torch.clamp(ids[refs.clamp(0, ni - 1).long()], max=nw - 1)
    row = torch.where(refs >= 0, dense,
                      torch.where(refs == EMPTY, nw + nl, nw + (-refs - 1)))
    rec = table[row.reshape(-1).long()]                      # [Nw*8, 6]
    kref = torch.where(refs >= 0, dense.to(torch.float32),
                       torch.where(refs == EMPTY, -1.0,
                                   _leaf_kernel_refs(bvh, refs, nl)
                                   .to(torch.float32)))
    rec = torch.cat([rec, kref.reshape(-1, 1),
                     torch.zeros((nw * 8, 9), dtype=torch.float32,
                                 device=dev)], dim=1)
    return rec.reshape(nw, 128)


def _leaf_kernel_refs(bvh: LBVH, refs, nl: int):
    """The kernel ref of each leaf slot in ``refs``: -(leaf + 1), or on a
    sub-leaf clustered tree -(triangle block + 1)."""
    if bvh.leaf_block is None:
        return refs
    return -(bvh.leaf_block[(-refs - 1).clamp(0, nl - 1).long()] + 1)


def widen_lbvh(bvh: LBVH, nw_pad: int, mode: str = None,
               depths=None) -> WideBVH:
    """Collapse to 8-wide (``tpurt``'s ``widen_lbvh``) with ``nw_pad`` >=
    ``count_wide(bvh, mode)`` rows, on the tree's device and without a
    host sync: the frontiers and wide mask of ``mode`` (``depths`` from
    ``build_lbvh(want_depth=True)`` give the fixed cut's mask), dense wide
    ids in binary-node order, one-gather row assembly (node boxes from the
    build, or on a deferred-box build range queries of the leaf boxes);
    the leaf slots take the triangle blocks' boxes. ``tpurt``'s size guard
    against a TPU fault has no counterpart on the card."""
    child = bvh.nodes_child
    ni = child.shape[0]
    dev = child.device
    front, wide = _front_and_mask(child, bvh.nodes_box, mode=mode,
                                  depths=depths)
    ids, src = _wide_ids_and_src(wide, nw_pad)
    is_pad = torch.arange(nw_pad, device=dev) >= wide.sum()
    refs = torch.where(is_pad[:, None], EMPTY, front[src])      # [Nw, 8]
    leaf_min, leaf_max = _leaf_boxes_from_tris(bvh)
    if bvh.nodes_box is None:
        nodes = _assemble_wide_nodes_deferred(refs, src, ids, bvh, leaf_min,
                                              leaf_max)
    else:
        wref = torch.where(refs >= 0, ids[refs.clamp(0, ni - 1).long()],
                           torch.where(refs == EMPTY, -1, _leaf_kernel_refs(
                               bvh, refs, leaf_min.shape[0])))
        nodes = _assemble_wide_nodes(refs, bvh.nodes_box, leaf_min, leaf_max,
                                     wref.to(torch.float32))
    return WideBVH(nodes=nodes.contiguous(), tris=block_rows(bvh),
                   tri_id=bvh.tri_id, root_min=bvh.root_min,
                   root_max=bvh.root_max, num_wide=nw_pad,
                   leaf_size=bvh.leaf_size)


def widen_area_kernel(bvh: LBVH, nw_pad: int):
    """The per-frame rebuild's 8-wide collapse: one sparse table of the
    leaf boxes, node areas from range queries, the BFS area-greedy
    collapse kernel, the one-gather row assembly. Works on full- and
    deferred-box builds. Returns (WideBVH, count i32[]): count > nw_pad
    means the pad overflowed and the rows are truncated."""
    leaf_boxes = _leaf_boxes_from_tris(bvh)
    tab = range_table(*leaf_boxes)
    area = node_areas(bvh, tab)
    front, src, count = collapse_area(bvh.nodes_child, area, nw_pad)
    nodes = assemble_area_rows(bvh, leaf_boxes, tab, front, src, nw_pad)
    wide = WideBVH(nodes=nodes.contiguous(), tris=block_rows(bvh),
                   tri_id=bvh.tri_id, root_min=bvh.root_min,
                   root_max=bvh.root_max, num_wide=nw_pad,
                   leaf_size=bvh.leaf_size)
    return wide, count


def wide_depth(wide: WideBVH) -> int:
    """Levels of internal wide nodes reachable from the root (root alone =
    1), walked on the host. A per-ray stack needs at most 7*depth + 1
    entries: each level leaves at most 7 siblings pending, and the deepest
    node pushes 8."""
    rows = wide.nodes.detach().cpu().numpy().reshape(-1, WIDE_FACTOR, 16)
    refs = rows[:, :, 6].astype(np.int64)
    child_ok = (rows[:, :, 0] <= rows[:, :, 3]) & (refs >= 0)
    frontier = np.zeros(1, np.int64)
    depth = 0
    while frontier.size:
        depth += 1
        if depth > rows.shape[0]:
            raise ValueError("wide BVH has a cycle")
        frontier = np.unique(refs[frontier][child_ok[frontier]])
    return depth


def order_children_for_point(wide: WideBVH, point) -> WideBVH:
    """Per-frame near-first child ordering for a shared ray origin (the
    camera): children are permuted inside each row so the kernel's LIFO
    stack pops the nearest child first. Any permutation is correct.
    ``point``: host data, or the camera position's view of the frame's
    block of constants."""
    rows = wide.nodes.reshape(-1, WIDE_FACTOR, 16)
    center = (rows[:, :, 0:3] + rows[:, :, 3:6]) * 0.5
    p = as_f32(point, rows.device)
    d = center - p
    key = d[:, :, 0] * d[:, :, 0] + d[:, :, 1] * d[:, :, 1] \
        + d[:, :, 2] * d[:, :, 2]
    return _apply_child_order(wide, rows, key)


def _apply_child_order(wide: WideBVH, rows, key) -> WideBVH:
    # Empty slots (inverted boxes) get the lowest key. Ascending sort of
    # -key puts the farthest real child in slot 0 and the nearest in slot
    # 7; the kernel pushes slots 0..7, so 7 pops first. The sort must be
    # stable, as jnp.argsort is, for equal keys to keep their order.
    empty = rows[:, :, 0] > rows[:, :, 3]
    key = torch.where(empty, -_BIG, key)
    perm = torch.argsort(-key, dim=1, stable=True)
    ordered = torch.take_along_dim(rows, perm[:, :, None], dim=1)
    return dataclasses.replace(
        wide, nodes=ordered.reshape(wide.nodes.shape).contiguous())


def round_up_bucket(n: int, bucket: int = 1024) -> int:
    return -(-n // bucket) * bucket


def build_wide(bvh: LBVH) -> WideBVH:
    """Count the area frontier's wide nodes (one host sync), then widen
    into the count rounded up to 1024 rows (``tpurt``'s ``build_wide``)."""
    nw = count_wide(bvh)
    return widen_lbvh(bvh, round_up_bucket(max(nw, 1)))
