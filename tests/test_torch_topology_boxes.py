"""The port's topology with node boxes (``topology_and_boxes``, whose plain
version ``topology_and_boxes_reference`` is ``topology_reference`` plus
``lbvh._assemble_node_boxes``) against the JAX package's:
``topology_and_boxes_pallas`` in interpret mode at up to 200 leaves (n = 2
and 3, all-equal deltas, heavy ties, distinct codes), and
``karras_topology_scan`` + ``_assemble_node_boxes`` at 20k leaves. Every
output is equal exactly: the topology's tie rules are part of the result,
and a box union is a min and a max, which round nothing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.bvh.lbvh import _assemble_node_boxes as jassemble
from tpurt.bvh.lbvh import adjacent_deltas as jadjacent_deltas
from tpurt.bvh.lbvh import karras_topology_scan
from tpurt.kernels.build import topology_and_boxes_pallas
from tpurt_torch.bvh.lbvh import adjacent_deltas
from tpurt_torch.kernels.build import (topology, topology_and_boxes,
                                       topology_and_boxes_cuda)

from test_torch_topology import _codes
from test_torch_native import ensure_native_libraries

torch.set_num_threads(1)
ensure_native_libraries()

NAMES = ("child", "first", "last", "nodes_box", "root_min", "root_max")


def _leaf_boxes(n: int, seed: int):
    """Leaf boxes f32[n, 3] (min, max) from a seed, some of them
    degenerate (min = max) and some with negative coordinates."""
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(n, 3)).astype(np.float32)
    ext = rng.random((n, 3)).astype(np.float32)
    ext[::7] = 0.0
    return lo, lo + ext


def _check(got, want):
    for a, b, what in zip(got, want, NAMES):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, what
        assert a.dtype == (torch.int32 if b.dtype == np.int32
                           else torch.float32), what
        np.testing.assert_array_equal(a.numpy(), b, err_msg=what)


@pytest.mark.parametrize("name", ["n2", "n3", "all_equal", "heavy_ties",
                                  "distinct"])
def test_equals_pallas_kernel(name):
    c = _codes(name)
    lmin, lmax = _leaf_boxes(c.shape[0], c.shape[0])
    d = adjacent_deltas(torch.from_numpy(c))
    jd = jadjacent_deltas((jnp.asarray(c.astype(np.uint32)), None))
    want = topology_and_boxes_pallas(jd, jnp.asarray(lmin),
                                     jnp.asarray(lmax), interpret=True)
    got = topology_and_boxes(d, torch.from_numpy(lmin),
                             torch.from_numpy(lmax))
    _check(got, want)


def test_equals_scan_and_range_boxes():
    c = _codes("large_ties")
    lmin, lmax = _leaf_boxes(c.shape[0], 3)
    child, first, last = karras_topology_scan(
        (jnp.asarray(c.astype(np.uint32)), None))
    nbox, rmin, rmax = jassemble(jnp.asarray(lmin), jnp.asarray(lmax),
                                 child, first, last)
    got = topology_and_boxes(adjacent_deltas(torch.from_numpy(c)),
                             torch.from_numpy(lmin), torch.from_numpy(lmax))
    _check(got, (child, first, last, nbox, rmin, rmax))


def test_topology_part_is_topology():
    """The first three outputs are ``topology``'s, and each node's record
    holds its children's boxes: a child node's own union, a leaf's box."""
    c = _codes("heavy_ties")
    lmin, lmax = _leaf_boxes(c.shape[0], 11)
    d = adjacent_deltas(torch.from_numpy(c))
    child, first, last, nbox, rmin, rmax = topology_and_boxes(
        d, torch.from_numpy(lmin), torch.from_numpy(lmax))
    for a, b in zip((child, first, last), topology(d)):
        assert torch.equal(a, b)
    nb = nbox.numpy()
    union = np.concatenate([np.minimum(nb[:, 0:3], nb[:, 6:9]),
                            np.maximum(nb[:, 3:6], nb[:, 9:12])], axis=1)
    for x in range(child.shape[0]):
        for side in (0, 1):
            r = int(child[x, side])
            box = np.concatenate([lmin[-r - 1], lmax[-r - 1]]) if r < 0 \
                else union[r]
            np.testing.assert_array_equal(nb[x, 6 * side:6 * side + 6], box)
    np.testing.assert_array_equal(np.concatenate([rmin, rmax]), union[0])


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        topology_and_boxes_cuda(torch.zeros(4, dtype=torch.int32),
                                torch.zeros((5, 3)), torch.zeros((5, 3)))
