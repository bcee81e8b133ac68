"""The binary kernels' BVH layout (counterpart of ``tpurt/kernels/pack.py``).

The binary walks (``csrc/binary.cu``, modes BIN_CLOSEST and BIN_ANY) take
the LBVH re-packed into 128-float rows, the layout the JAX package's
``_any_hit_kernel`` and ``_closest_hit_kernel`` read:

- ``nodes`` f32[Nr, 128]: 8 binary-node records per row, 16 floats each:
  [Lmin.xyz, Lmax.xyz, Rmin.xyz, Rmax.xyz, childL, childR, 0, 0]. The
  child refs are float VALUES, exact below 2^24 (>= 0 internal index, < 0
  a leaf as -(leaf_id + 1)). On the card a record is four 16-byte loads.
- ``tris`` f32[L, 128]: one leaf per row, leaf_size x (v0, e1, e2) back to
  back, zero-padded; the same leaf rows as the 8-wide accel's.

``pack_bvh`` equals ``tpurt``'s bit for bit. It keeps the scene box beside
the rows (the unfused shadow pass caps directional rays at its exit).
``binary_vmem_bytes`` is the size ``tpurt`` budgets before it falls back
to its portable traversal; ``check_slice`` refuses the scenes it would
not run this way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..bvh.lbvh import LBVH

NODES_PER_ROW = 8
NODE_STRIDE = 16
MAX_LEAF_SIZE = 14
ROW_BYTES = 128 * 4


@dataclasses.dataclass
class PackedBVH:
    """An LBVH in the binary kernels' row layout (tensors on one device).

    nodes    : f32[Nr, 128] 8 node records per row (see the module)
    tris     : f32[L, 128] one leaf per row
    tri_id   : i32[Tpad] sorted position -> original triangle id
    num_internal, num_leaves, leaf_size : as the LBVH's
    root_min/max : f32[3] scene box, or None where the rows came from
                   ``tpurt``'s ``PackedBVH`` (``convert.packed_bvh``),
                   which carries none
    """

    nodes: torch.Tensor
    tris: torch.Tensor
    tri_id: torch.Tensor
    num_internal: int
    num_leaves: int
    leaf_size: int
    root_min: Optional[torch.Tensor] = None
    root_max: Optional[torch.Tensor] = None


def pack_bvh(bvh: LBVH) -> PackedBVH:
    """LBVH -> the kernel layout: reshapes and a concatenation, no host
    sync. Raises where ``tpurt``'s ``pack_bvh`` cannot pack: a leaf wider
    than one row, a node index past exact float32, and a sub-leaf
    clustered tree, whose leaves outnumber its triangle blocks (``tpurt``
    fails there in its leaf-row reshape)."""
    k = bvh.leaf_size
    if k > MAX_LEAF_SIZE:
        raise ValueError(f"leaf_size {k} > {MAX_LEAF_SIZE} cannot pack into "
                         "one 128-lane row")
    ni = bvh.num_internal
    if ni >= (1 << 24):
        raise ValueError("node index exceeds exact-f32 range")
    if bvh.leaf_block is not None:
        raise ValueError(
            "a sub-leaf clustered tree (split_blocks > 0) cannot be packed: "
            f"{bvh.num_leaves} leaves share {bvh.num_blocks} triangle rows, "
            "and tpurt's pack_bvh fails on it in its leaf-row reshape")
    if bvh.nodes_box is None:
        raise ValueError("pack_bvh needs node boxes (build_lbvh(boxes="
                         "'full'))")
    dev = bvh.nodes_child.device
    child_f = bvh.nodes_child.to(torch.float32)
    rec = torch.cat([bvh.nodes_box, child_f,
                     torch.zeros((ni, 2), dtype=torch.float32, device=dev)],
                    dim=1)                                      # [Ni, 16]
    nr = -(-ni // NODES_PER_ROW) * NODES_PER_ROW
    nodes = F.pad(rec, (0, 0, 0, nr - ni)).reshape(nr // NODES_PER_ROW, 128)
    n_leaves = bvh.num_leaves
    tri9 = torch.stack([bvh.tri_v0, bvh.tri_e1, bvh.tri_e2], dim=1)
    tri9 = tri9.reshape(n_leaves, k * 9)
    tris = F.pad(tri9, (0, 128 - k * 9))
    return PackedBVH(nodes=nodes.contiguous(), tris=tris.contiguous(),
                     tri_id=bvh.tri_id, num_internal=ni, num_leaves=n_leaves,
                     leaf_size=k, root_min=bvh.root_min,
                     root_max=bvh.root_max)


def packed_shapes(num_tris: int, leaf_size: int):
    """(num_internal, num_leaves, node_rows) of the layout for a scene of
    ``num_tris``, from the padding of ``build_lbvh`` and ``pack_bvh``,
    without building."""
    tpad = max(num_tris, 2 * leaf_size)
    tpad = -(-tpad // leaf_size) * leaf_size
    n_leaves = tpad // leaf_size
    ni = n_leaves - 1
    node_rows = -(-ni // NODES_PER_ROW)
    return ni, n_leaves, node_rows


def binary_vmem_bytes(num_tris: int, leaf_size: int) -> int:
    """Bytes of the packed layout (node rows + leaf rows): ``tpurt``'s
    budget measure for the binary kernels."""
    _, n_leaves, node_rows = packed_shapes(num_tris, leaf_size)
    return (node_rows + n_leaves) * ROW_BYTES


def tree_depth(nodes_child: torch.Tensor) -> int:
    """Depth of the deepest internal node of a binary tree (root = 0),
    walked level by level on the host. A per-ray stack of the binary walk
    needs depth + 1 entries: each level leaves at most one sibling
    pending, and the deepest node with internal children pushes two."""
    child = nodes_child.detach().cpu().numpy().astype(np.int64)
    frontier = np.zeros(1, np.int64)
    depth = -1
    while frontier.size:
        depth += 1
        if depth > child.shape[0]:
            raise ValueError("binary BVH has a cycle")
        refs = child[frontier].reshape(-1)
        frontier = refs[refs >= 0]
    return depth
