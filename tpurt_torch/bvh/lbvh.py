"""The ``LBVH`` container and the on-device Morton build (counterpart of
``tpurt/bvh/lbvh.py``).

The static path fills the container from the host SAH build
(``bvh/sah.py``). ``build_lbvh`` is the per-frame rebuild's build: Morton
codes of the centroids (a kernel), one stable key sort carrying every
per-triangle column, optional sub-leaf clustering, the Karras topology (a
kernel) from the adjacent deltas, and node boxes from a sparse table of
range minima (full) or none at all (deferred).

The topology is always the kernel formulation, the min-Cartesian tree over
the deltas (``topology_pallas``, equal to ``karras_topology_scan``). The
JAX package builds with it on the TPU below its 30k-leaf SMEM gate and
with the binary-search builder ``karras_topology`` elsewhere (its CPU
runs, bigger scenes); the two trees are the same with other internal node
ids. The card has no such gate. The search builder is not ported.

``top_sah`` steers the top of the tree: the sweep-SAH kernel re-chooses
the top splits over blocks of leaf boxes and writes them as priorities
D' (``kernels/build.sweep_sah_priorities``), whose min-Cartesian tree is
built by the same topology kernel; below the sweep's cut the Morton
structure is kept, and leaf ranges stay contiguous.

``morton_bits=60`` keys every triangle by two words (a kernel too) and
sorts them lexicographically, as one stable sort of the int64 key
``hi << 30 | lo``; the deltas read both words.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels.build import (D_MAX, SWEEP_MAXD, morton_codes, morton_codes60,
                             sweep_sah_priorities, topology)

INT32_MIN = -(2 ** 31)
_BIG = 3.4e38


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class LBVH:
    """Flattened binary BVH (tensors on one device).

    Ni = n_leaves - 1 internal nodes; leaf ``l`` covers sorted triangles
    [l*leaf_size, (l+1)*leaf_size).

    nodes_box   : f32[Ni, 12] = [Lmin, Lmax, Rmin, Rmax] child boxes, or
                  None (``build_lbvh(boxes="defer")``)
    nodes_child : i32[Ni, 2]  child refs; >= 0 internal index, < 0 leaf
                  encoded as -(leaf_id + 1)
    nodes_first : i32[Ni] first covered sorted-leaf index
    nodes_last  : i32[Ni] last covered sorted-leaf index (inclusive)
    tri_v0/e1/e2: f32[Tpad, 3] sorted triangle data (Möller–Trumbore layout)
    tri_sorted  : i32[Tpad, 3] vertex indices in sorted order
    tri_id      : i32[Tpad] sorted position -> original triangle id
    root_min/max: f32[3] scene bounds
    leaf_size   : triangles per leaf

    Sub-leaf clustering (``build_lbvh(split_blocks=M)``): the tree's leaves
    are L = num_blocks + M sub-leaves. Tree-leaf ``l`` has its own box
    (``leaf_min/leaf_max[l]``, one side of the best Morton-jump cut of its
    block) and scans the whole triangle block ``leaf_block[l]``.

    leaf_block  : i32[L] tree-leaf -> triangle-block id, or None
    leaf_min/max: f32[L, 3] per-tree-leaf boxes, or None
    """

    nodes_box: Optional[torch.Tensor]
    nodes_child: torch.Tensor
    nodes_first: torch.Tensor
    nodes_last: torch.Tensor
    tri_v0: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_sorted: torch.Tensor
    tri_id: torch.Tensor
    root_min: torch.Tensor
    root_max: torch.Tensor
    leaf_size: int = 4
    leaf_block: Optional[torch.Tensor] = None
    leaf_min: Optional[torch.Tensor] = None
    leaf_max: Optional[torch.Tensor] = None

    @property
    def num_internal(self) -> int:
        return int(self.nodes_child.shape[0])

    @property
    def num_leaves(self) -> int:
        return self.num_internal + 1

    @property
    def num_sorted_tris(self) -> int:
        return int(self.tri_id.shape[0])

    @property
    def num_blocks(self) -> int:
        """Triangle blocks (= leaves unless sub-leaf clustered)."""
        return self.num_sorted_tris // self.leaf_size


# ---------------------------------------------------------------------------
# Topology input and node boxes
# ---------------------------------------------------------------------------

def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of positive int32 values, exactly: float64 holds
    them exactly, and frexp's exponent is floor(log2) + 1."""
    return (torch.frexp(x.double())[1] - 1).to(torch.int32)


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of non-negative int32 values as 32-bit words (32 for
    0)."""
    return torch.where(x > 0, 31 - _floor_log2(x), 32).to(torch.int32)


def adjacent_deltas(codes) -> torch.Tensor:
    """D[g] = delta(g, g+1) of the sorted leaf codes: 30-bit codes i32[n],
    or 60-bit keys as a (hi, lo) pair of i32[n]. The common-prefix length
    clz(hi[g] ^ hi[g+1]), where the hi words agree 32 + clz(lo[g] ^
    lo[g+1]), and for equal keys 64 + clz(g ^ (g+1)). D fully determines
    the Karras radix tree."""
    hi, lo = codes if isinstance(codes, tuple) else (codes, None)
    g = torch.arange(hi.shape[0] - 1, dtype=torch.int32, device=hi.device)
    xh = hi[:-1] ^ hi[1:]
    d_lo = 64 + _clz32(g ^ (g + 1))
    if lo is not None:
        xl = lo[:-1] ^ lo[1:]
        d_lo = torch.where(xl == 0, d_lo, 32 + _clz32(xl))
    return torch.where(xh == 0, d_lo, _clz32(xh))


def range_table(leaf_min: torch.Tensor, leaf_max: torch.Tensor
                ) -> torch.Tensor:
    """f32[levels, n, 6] sparse table of range minima over [leaf_min,
    -leaf_max] (the JAX package's "packed" variant): row i of level k is
    the min over rows [i, i + 2^k), rows past the end clamped to the last
    row."""
    n = int(leaf_min.shape[0])
    t = torch.cat([leaf_min, -leaf_max], dim=1)                 # [n, 6]
    tabs = [t]
    for k in range(1, max(1, n.bit_length())):
        s = 1 << (k - 1)
        t = tabs[-1]
        shifted = torch.cat([t[s:], t[n - 1:n].expand(s, 6)])
        tabs.append(torch.minimum(t, shifted))
    return torch.stack(tabs)


def range_query(tab: torch.Tensor, first: torch.Tensor, last: torch.Tensor):
    """Box over each inclusive leaf range [first, last] from a
    ``range_table``: two rows of the level that covers the range. Returns
    (f32[Q, 3], f32[Q, 3])."""
    k = _floor_log2(last - first + 1).clamp(0, tab.shape[0] - 1).long()
    b = torch.clamp(last.long() - torch.pow(2, k) + 1, min=0)
    r = torch.minimum(tab[k, first.long()], tab[k, b])
    return r[:, 0:3], -r[:, 3:6]


def range_boxes(leaf_min: torch.Tensor, leaf_max: torch.Tensor,
                first: torch.Tensor, last: torch.Tensor):
    """Box over each inclusive leaf range [first, last]."""
    return range_query(range_table(leaf_min, leaf_max), first, last)


def _assemble_node_boxes(leaf_min, leaf_max, child, first, last):
    """Per-node [Lmin Lmax Rmin Rmax] rows from leaf boxes + topology, and
    the root box."""
    node_min, node_max = range_boxes(leaf_min, leaf_max, first, last)
    ni = child.shape[0]
    nl = leaf_min.shape[0]

    def child_box(c):
        is_leaf = (c < 0)[:, None]
        leaf_id = (-c - 1).clamp(0, nl - 1).long()
        node_id = c.clamp(0, ni - 1).long()
        return (torch.where(is_leaf, leaf_min[leaf_id], node_min[node_id]),
                torch.where(is_leaf, leaf_max[leaf_id], node_max[node_id]))

    lmin, lmax = child_box(child[:, 0])
    rmin, rmax = child_box(child[:, 1])
    nodes_box = torch.cat([lmin, lmax, rmin, rmax], dim=1)
    return nodes_box, node_min[0], node_max[0]


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

def _leaf_boxes(v0, e1, e2, leaf_size: int):
    """Per-leaf (k-chop) boxes and per-triangle boxes from the sorted
    triangle data; corners are rebuilt as v0 + e1, v0 + e2."""
    v1 = v0 + e1
    v2 = v0 + e2
    tmin = torch.minimum(torch.minimum(v0, v1), v2)
    tmax = torch.maximum(torch.maximum(v0, v1), v2)
    n_leaves = v0.shape[0] // leaf_size
    lmin = tmin.reshape(n_leaves, leaf_size, 3).amin(dim=1)
    lmax = tmax.reshape(n_leaves, leaf_size, 3).amax(dim=1)
    return lmin, lmax, tmin, tmax


def _split_key(best_s: torch.Tensor) -> torch.Tensor:
    """-best_s in int32 WITH the wrap of the JAX package: a block whose
    codes are all equal scores INT32_MIN, whose negation wraps to
    INT32_MIN, so the ascending sort ranks such blocks FIRST among the
    split candidates. Kept as it is: it decides which blocks split."""
    return torch.where(best_s == INT32_MIN, INT32_MIN, -best_s)


def _subleaf_split(chs, tmin_s, tmax_s, k: int, m: int):
    """Split the top-``m`` triangle blocks (ranked by their largest
    internal adjacent-code xor, the Morton jump) at that boundary into two
    tight-boxed tree-leaves that share the block's triangle rows.

    chs: i32[Tpad] sorted codes; tmin_s/tmax_s: f32[Tpad, 3] sorted
    per-triangle boxes. Returns (leaf_block i32[L], sub_codes i32[L],
    sub_min f32[L, 3], sub_max f32[L, 3]) with L = Tpad // k + m."""
    tpad = chs.shape[0]
    nb = tpad // k
    if not 0 < m <= nb:
        raise ValueError(f"split_blocks {m} outside 1..{nb}")
    dev = chs.device
    # Boundary scores: the xor of adjacent sorted codes with the sign bit
    # flipped, an int32 view that keeps the unsigned order.
    x = (chs[:-1] ^ chs[1:]) ^ INT32_MIN
    xi = torch.cat([x, torch.full((1,), INT32_MIN, dtype=torch.int32,
                                  device=dev)])
    sc = xi.reshape(nb, k)[:, :k - 1]       # col c-1 scores a cut at c
    best_s, best_c = torch.max(sc, dim=1)   # the first maximum
    best_c = best_c.to(torch.int32) + 1

    # The exact top-m split set: a stable ascending sort of the key.
    ordb = torch.sort(_split_key(best_s), stable=True).indices
    # index_fill_ takes the value as a kernel argument; an index_put_ of a
    # Python scalar copies it to the card and syncs.
    split = torch.zeros((nb,), dtype=torch.bool, device=dev).index_fill_(
        0, ordb[:m], True)

    t6 = torch.cat([tmin_s, -tmax_s], dim=1).reshape(nb, k, 6)
    end_a = torch.where(split, best_c, k)   # A covers rows [0, end_a)
    slot = torch.arange(k, dtype=torch.int32, device=dev)[None, :, None]
    box_a = torch.where(slot < end_a[:, None, None], t6, _BIG).amin(dim=1)
    box_b = torch.where(slot >= best_c[:, None, None], t6, _BIG).amin(dim=1)

    # Sub-leaf stream u = 2b (A, always) / 2b+1 (B, iff split), compacted
    # to exactly L = nb + m tree-leaves in Morton order (a scatter, not a
    # boolean mask: no host sync).
    emit = torch.stack([torch.ones_like(split), split], dim=1).reshape(-1)
    offs = torch.stack([torch.zeros_like(best_c), best_c], dim=1).reshape(-1)
    boxes = torch.stack([box_a, box_b], dim=1).reshape(2 * nb, 6)
    n_leaves = nb + m
    lid = torch.cumsum(emit.to(torch.int32), 0) - 1
    u = torch.arange(2 * nb, dtype=torch.int32, device=dev)
    compact = torch.zeros((n_leaves + 1,), dtype=torch.int32, device=dev)
    compact[torch.where(emit, lid, n_leaves).long()] = u
    compact_src = compact[:n_leaves].long()
    leaf_block = (compact_src >> 1).to(torch.int32)
    sub_codes = chs[leaf_block.long() * k + offs[compact_src]]
    b6 = boxes[compact_src]
    return leaf_block, sub_codes, b6[:, :3], -b6[:, 3:]


def auto_split_blocks(num_tris: int, leaf_size: int) -> int:
    """The sub-leaf split count for ``rebuild_splits=-1``: a quarter of the
    blocks, capped so the leaf count stays under the JAX package's 30k
    SMEM topology gate (kept: it fixes config 2's tree)."""
    tpad = _round_up(max(int(num_tris), 2 * leaf_size), leaf_size)
    nb = tpad // leaf_size
    return max(0, min(nb // 4, 30_000 - nb - 8))


def _triangle_data(vertices, indices, tpad: int):
    """Padded triangles (the last one repeated) -> (tri i32[Tpad, 3], v0,
    e1, e2, centroid, scene_min, scene_max)."""
    pad = tpad - indices.shape[0]
    tri = indices.to(torch.int32)
    if pad:
        tri = torch.cat([tri, tri[-1:].expand(pad, 3)])
    v = vertices[tri.reshape(-1).long()].reshape(tpad, 3, 3)
    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
    tmin = torch.minimum(torch.minimum(v0, v1), v2)
    tmax = torch.maximum(torch.maximum(v0, v1), v2)
    centroid = (tmin + tmax) * 0.5
    pb = torch.cat([tmin, -tmax], dim=1).amin(dim=0)
    return tri, v0, v1 - v0, v2 - v0, centroid, pb[:3], -pb[3:]


def _pad_columns(columns, tpad: int):
    """Per-triangle [T] columns padded to [Tpad] like the triangles: the
    last value repeated."""
    return [torch.cat([c, c[-1:].expand(tpad - c.shape[0])])
            for c in columns]


def _sort_payload(codes, columns):
    """One stable key sort: (sorted codes, every column gathered by the
    permutation). ``jax.lax.sort`` with one key is stable, so equal codes
    keep their original order."""
    chs, perm = torch.sort(codes, stable=True)
    return chs, [c[perm] for c in columns]


def top_sah_args(top_sah) -> dict:
    """``top_sah``'s sweep arguments: none for True (the defaults), the
    (block, maxd, min_blocks) tuple's otherwise (``tpurt``'s form)."""
    if isinstance(top_sah, tuple):
        return dict(zip(("block", "maxd", "min_blocks"), top_sah))
    return {}


def delta_range(top_sah=False) -> int:
    """d_max of the priorities a build hands the topology: the adjacent
    deltas lie in [0, D_MAX), the steered D' in [0, D_MAX + maxd). A tree
    over them is at most d_max - 1 levels deep."""
    if not top_sah:
        return D_MAX
    return D_MAX + int(top_sah_args(top_sah).get("maxd", SWEEP_MAXD))


def build_lbvh(vertices: torch.Tensor, indices: torch.Tensor,
               leaf_size: int = 4, morton_bits: int = 30,
               boxes: str = "full", extra_payload: tuple = (),
               want_depth: bool = False, top_sah=False,
               split_blocks: int = 0):
    """The on-device build: Morton codes, a stable key sort carrying every
    per-triangle column, sub-leaf clustering when ``split_blocks`` > 0,
    the topology kernel, then node boxes (``boxes="full"``) or only the
    root box (``"defer"``, for the fused rebuild, whose collapse reads the
    wide nodes' boxes from the sparse table).

    vertices f32[V, 3], indices i32[T, 3] (tensors on the build's device).
    ``morton_bits``: 30 (one word per key) or 60 (two words, sorted
    lexicographically; not with ``split_blocks``, which ``tpurt``
    asserts). ``extra_payload``: per-triangle [T] columns to co-sort.
    ``want_depth``: also every internal node's depth i32[Ni] (root 0),
    the topology kernel's depth output, which the fixed cut reads.
    ``top_sah``: True, or a (block, maxd, min_blocks) tuple, steers the
    top splits by the sweep-SAH kernel (not with ``split_blocks``, as in
    ``tpurt``, which asserts it). The
    return is the LBVH alone, or a tuple in ``tpurt``'s order: (LBVH,
    sorted columns if ``extra_payload``, depth if ``want_depth``)."""
    if morton_bits not in (30, 60):
        raise ValueError(f"morton_bits={morton_bits}")
    if morton_bits == 60 and split_blocks:
        raise ValueError("sub-leaf clustering needs 30-bit codes")
    if split_blocks and top_sah:
        raise ValueError("split_blocks and top_sah are exclusive")
    if boxes not in ("full", "defer"):
        raise ValueError(f"boxes={boxes!r}")
    num_tris = int(indices.shape[0])
    tpad = _round_up(max(num_tris, 2 * leaf_size), leaf_size)
    tri, v0, e1, e2, centroid, scene_min, scene_max = _triangle_data(
        vertices, indices, tpad)
    if morton_bits == 60:
        hi, lo = morton_codes60(centroid, scene_min, scene_max)
        codes = (hi.to(torch.int64) << 30) | lo.to(torch.int64)
    else:
        codes = morton_codes(centroid, scene_min, scene_max)

    order = torch.arange(tpad, dtype=torch.int32, device=codes.device)
    chs, s = _sort_payload(codes, [order, v0, e1, e2, tri]
                           + _pad_columns(extra_payload, tpad))
    # Padded rows are copies of triangle T-1: clamping keeps shading
    # lookups by original id in range.
    tri_id = torch.clamp(s[0], max=num_tris - 1)
    sv0, se1, se2, tri_sorted = s[1:5]
    sorted_extras = tuple(s[5:])

    leaf_block = None
    if split_blocks:
        _, _, tmin_s, tmax_s = _leaf_boxes(sv0, se1, se2, leaf_size)
        leaf_block, leaf_codes, lmin, lmax = _subleaf_split(
            chs, tmin_s, tmax_s, leaf_size, int(split_blocks))
    else:
        lmin, lmax, _, _ = _leaf_boxes(sv0, se1, se2, leaf_size)
        leaf_codes = chs[::leaf_size]
        if morton_bits == 60:
            leaf_codes = ((leaf_codes >> 30).to(torch.int32),
                          (leaf_codes & ((1 << 30) - 1)).to(torch.int32))

    d = adjacent_deltas(leaf_codes)
    if top_sah:
        d = sweep_sah_priorities(d, lmin, lmax, **top_sah_args(top_sah))
    topo = topology(d, want_depth=want_depth, d_max=delta_range(top_sah))
    child, first, last = topo[:3]

    if boxes == "defer":
        # The root box reduces the leaf boxes (rebuilt corners round ~1
        # ulp from the originals), bit-identical to the full path's root.
        pb = torch.cat([lmin, -lmax], dim=1).amin(dim=0)
        nodes_box, root_min, root_max = None, pb[:3], -pb[3:]
    else:
        nodes_box, root_min, root_max = _assemble_node_boxes(
            lmin, lmax, child, first, last)
    out = LBVH(nodes_box=nodes_box, nodes_child=child, nodes_first=first,
               nodes_last=last, tri_v0=sv0, tri_e1=se1, tri_e2=se2,
               tri_sorted=tri_sorted, tri_id=tri_id, root_min=root_min,
               root_max=root_max, leaf_size=leaf_size,
               leaf_block=leaf_block,
               leaf_min=lmin if leaf_block is not None else None,
               leaf_max=lmax if leaf_block is not None else None)
    ret = (out,)
    if extra_payload:
        ret += (sorted_extras,)
    if want_depth:
        ret += (topo[3],)
    return ret if len(ret) > 1 else out
