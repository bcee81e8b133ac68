"""The port's breadth-first area collapse (``collapse_area_reference``, the
plain version of the CUDA kernel) against ``collapse_area_pallas`` in
interpret mode on the same binary tree and areas: front, src and count
equal exactly, with a fitting pad, with areas full of ties, and with a pad
smaller than the count (the overflow the rebuild recovers from). The
serial interpret-mode BFS costs ~14 s at 250 triangles, so the trees stay
that small."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.bvh.lbvh import build_lbvh, range_boxes
from tpurt.kernels.build import collapse_area_pallas
from tpurt.scenes import random_soup
from tpurt_torch.kernels.build import (EMPTY, collapse_area,
                                       collapse_area_cuda, greedy_slots)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tree():
    mesh = random_soup(250, seed=5)
    bvh = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices),
                     leaf_size=2, boxes="defer")
    v0, e1, e2 = bvh.tri_v0, bvh.tri_e1, bvh.tri_e2
    v1, v2 = v0 + e1, v0 + e2
    tmin = jnp.minimum(jnp.minimum(v0, v1), v2).reshape(-1, 2, 3).min(1)
    tmax = jnp.maximum(jnp.maximum(v0, v1), v2).reshape(-1, 2, 3).max(1)
    amin, amax = range_boxes(tmin, tmax, bvh.nodes_first, bvh.nodes_last)
    ext = np.maximum(np.asarray(amax - amin), 0.0)
    area = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
            + ext[:, 2] * ext[:, 0]).astype(np.float32)
    return np.array(bvh.nodes_child), area


def _both(child, area, nw_pad):
    front, src, count = collapse_area_pallas(
        jnp.asarray(child[:, 0]), jnp.asarray(child[:, 1]),
        jnp.asarray(area), nw_pad, interpret=True)
    got = collapse_area(torch.from_numpy(child), torch.from_numpy(area),
                        nw_pad)
    return (np.asarray(front), np.asarray(src), int(count)), got


def _assert_equal(want, got):
    for a, b, what in zip(want, got, ("front", "src", "count")):
        assert b.dtype == torch.int32, what
        np.testing.assert_array_equal(b.numpy(), a, err_msg=what)


@pytest.mark.parametrize("case", ["fitting_pad", "area_ties", "overflow"])
def test_equals_pallas_kernel(tree, case):
    child, area = tree
    if case == "area_ties":
        area = np.floor(area * 0.25).astype(np.float32)   # a few values
    nw_pad = 64
    if case == "overflow":
        full = collapse_area(torch.from_numpy(child),
                             torch.from_numpy(area), 64)[2]
        nw_pad = int(full) // 2
    want, got = _both(child, area, nw_pad)
    _assert_equal(want, got)
    if case == "overflow":
        assert want[2] > nw_pad
    else:
        assert want[2] <= nw_pad


def test_frontier_rows_follow_the_greedy_rule(tree):
    """Each wide row's internal refs are BFS positions, and its slots are
    greedy_slots of its binary root with those refs mapped back."""
    child, area = tree
    tc, ta = torch.from_numpy(child), torch.from_numpy(area)
    front, src, count = collapse_area(tc, ta, 64)
    n = int(count)
    slots = greedy_slots(tc, ta, src[:n])
    mapped = torch.where(front[:n] >= 0,
                         src[front[:n].clamp(0, 63).long()], front[:n])
    assert torch.equal(mapped, slots)
    internal = front[:n][front[:n] >= 0]
    assert torch.equal(torch.sort(internal).values, torch.arange(1, n,
                                                                  dtype=torch.int32))
    assert bool((front[n:] == EMPTY).all())


def test_cuda_wrapper_refuses_cpu_tensors(tree):
    child, area = tree
    with pytest.raises(ValueError, match="CUDA tensors"):
        collapse_area_cuda(torch.from_numpy(child), torch.from_numpy(area),
                           64)
