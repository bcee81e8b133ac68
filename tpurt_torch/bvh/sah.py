"""Native SAH/SBVH build -> ``LBVH`` arrays (counterpart of
``tpurt/bvh/sah.py``).

The C++ builder (``native/tpurt_native.cpp``) runs once per scene on the
host; its depth-first skip-link tree is converted in NumPy to the LBVH
layout the wide collapse consumes, then copied to the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .lbvh import LBVH
from ..native import CpuBVH, build_sah_bvh
from ..types import Mesh


def cpu_bvh_to_lbvh(cpu: CpuBVH, mesh: Mesh, leaf_size: int,
                    device) -> LBVH:
    """CpuBVH (DFS + skip links, variable leaf counts) -> LBVH arrays on
    ``device`` with fixed ``leaf_size`` (leaves repeat-pad their last
    triangle)."""
    n = cpu.bb_min.shape[0]
    is_leaf = cpu.prim_count > 0
    left = np.arange(n, dtype=np.int64) + 1
    right = cpu.skip[np.clip(left, 0, n - 1)].astype(np.int64)
    int_ids = np.cumsum(~is_leaf) - 1
    leaf_ids = np.cumsum(is_leaf) - 1
    nl = int(is_leaf.sum())
    ni = int((~is_leaf).sum())
    if ni < 1:
        raise ValueError("degenerate SAH tree (single leaf) unsupported")

    def ref_of(node):
        node = np.clip(node, 0, n - 1)
        return np.where(is_leaf[node], -(leaf_ids[node] + 1),
                        int_ids[node]).astype(np.int32)

    internal = ~is_leaf
    child = np.stack([ref_of(left), ref_of(right)], axis=1)[internal]
    lb = np.clip(left, 0, n - 1)[internal]
    rb = np.clip(right, 0, n - 1)[internal]
    nodes_box = np.concatenate(
        [cpu.bb_min[lb], cpu.bb_max[lb], cpu.bb_min[rb], cpu.bb_max[rb]],
        axis=1).astype(np.float32)

    # DFS order => every subtree's leaves are contiguous.
    leaves_before = np.concatenate([[0], np.cumsum(is_leaf)])
    first = leaves_before[np.arange(n)][internal].astype(np.int32)
    last = (leaves_before[np.clip(cpu.skip, 0, n)][internal] - 1
            ).astype(np.int32)

    starts = cpu.prim_start[is_leaf].astype(np.int64)
    counts = cpu.prim_count[is_leaf].astype(np.int64)
    k = leaf_size
    slot = np.tile(np.arange(k, dtype=np.int64), nl)
    base = np.repeat(starts, k)
    cnt = np.repeat(counts, k)
    tri_rows = cpu.tri_order[base + np.minimum(slot, cnt - 1)]

    v = np.asarray(mesh.vertices, np.float32)
    tri = np.asarray(mesh.indices, np.int64)[tri_rows]
    v0 = v[tri[:, 0]]
    e1 = v[tri[:, 1]] - v0
    e2 = v[tri[:, 2]] - v0

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    return LBVH(nodes_box=dev(nodes_box, torch.float32),
                nodes_child=dev(child, torch.int32),
                nodes_first=dev(first, torch.int32),
                nodes_last=dev(last, torch.int32),
                tri_v0=dev(v0, torch.float32), tri_e1=dev(e1, torch.float32),
                tri_e2=dev(e2, torch.float32),
                tri_sorted=dev(tri.astype(np.int32), torch.int32),
                tri_id=dev(tri_rows.astype(np.int32), torch.int32),
                root_min=dev(cpu.bb_min[0], torch.float32),
                root_max=dev(cpu.bb_max[0], torch.float32),
                leaf_size=k)


def build_sah_lbvh(mesh: Mesh, device, leaf_size: int = 14,
                   spatial_alpha: float = 1e-4,
                   spatial_budget: float = 1.2) -> LBVH:
    """Native SBVH build for a static scene, in LBVH layout on ``device``,
    with the JAX package's static-scene defaults (alpha 1e-4, budget
    1.2)."""
    cpu = build_sah_bvh(np.asarray(mesh.vertices, np.float32),
                        np.asarray(mesh.indices, np.int32),
                        leaf_size=leaf_size, spatial_alpha=spatial_alpha,
                        spatial_budget=spatial_budget)
    return cpu_bvh_to_lbvh(cpu, mesh, leaf_size, device)
