"""Binary LBVH -> 8-wide BVH collapse (counterpart of
``tpurt/bvh/wide.py`` for the area frontier).

Two collapses of the same greedy rule:

- once per scene (static path, and the rebuild path's pad count): plain
  tensor code, the area-greedy frontiers of every node, the 64-sweep
  reachability of wide roots, dense wide ids in binary-node order and the
  one-gather row assembly (tests/test_torch_accel.py);
- every frame of the rebuild (``widen_area_kernel``): the breadth-first
  collapse kernel (``kernels/build.collapse_area``), whose wide ids are BFS
  positions, and the same kind of row assembly, with node boxes from range
  queries over the leaf boxes (tests/test_torch_rebuild.py).

Then the per-frame near-first child ordering. Every step reproduces the
JAX package's arrays exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..kernels.build import EMPTY, WIDE_FACTOR, collapse_area, greedy_slots
from .lbvh import LBVH, _leaf_boxes, range_query, range_table

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


def _front_and_mask(child, nodes_box):
    """The area frontier (the reference's static-scene FRONTIER_MODE) and
    its wide-root mask, with the reference's 64 sweeps."""
    front = frontiers_area(child, nodes_box)
    return front, wide_roots_reachable(child, front, sweeps=64)


def count_wide(bvh: LBVH) -> int:
    """Host sync: number of wide nodes (for choosing the padded size)."""
    _, mask = _front_and_mask(bvh.nodes_child, bvh.nodes_box)
    return int(mask.sum())


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
    e2), zero-padded."""
    k = bvh.leaf_size
    if k * 9 > 128:
        raise ValueError(f"leaf_size {k} does not fit one 128-lane leaf row")
    tri9 = torch.stack([bvh.tri_v0, bvh.tri_e1, bvh.tri_e2], dim=1)
    tri9 = tri9.reshape(bvh.num_blocks, k * 9)
    return torch.nn.functional.pad(tri9, (0, 128 - k * 9)).contiguous()


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
    stack pops the nearest child first. Any permutation is correct."""
    rows = wide.nodes.reshape(-1, WIDE_FACTOR, 16)
    center = (rows[:, :, 0:3] + rows[:, :, 3:6]) * 0.5
    p = torch.as_tensor(np.asarray(point, np.float32), device=rows.device)
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
