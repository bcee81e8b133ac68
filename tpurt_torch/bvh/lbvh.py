"""The ``LBVH`` container (counterpart of ``tpurt/bvh/lbvh.py:53-132``).

Only the array layout is ported: the static path fills it from the host
SAH build (``bvh/sah.py``). The on-device Morton/Karras build is later work.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class LBVH:
    """Flattened binary BVH (tensors on one device).

    Ni = n_leaves - 1 internal nodes; leaf ``l`` covers sorted triangles
    [l*leaf_size, (l+1)*leaf_size).

    nodes_box   : f32[Ni, 12] = [Lmin, Lmax, Rmin, Rmax] child boxes
    nodes_child : i32[Ni, 2]  child refs; >= 0 internal index, < 0 leaf
                  encoded as -(leaf_id + 1)
    nodes_first : i32[Ni] first covered sorted-leaf index
    nodes_last  : i32[Ni] last covered sorted-leaf index (inclusive)
    tri_v0/e1/e2: f32[Tpad, 3] sorted triangle data (Möller–Trumbore layout)
    tri_sorted  : i32[Tpad, 3] vertex indices in sorted order
    tri_id      : i32[Tpad] sorted position -> original triangle id
    root_min/max: f32[3] scene bounds
    leaf_size   : triangles per leaf
    """

    nodes_box: torch.Tensor
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
        """Triangle blocks (one per leaf on the static path)."""
        return self.num_sorted_tris // self.leaf_size
