"""The port's Karras topology (``topology_reference``, the plain version of
the CUDA kernel) against the JAX package's: ``topology_pallas`` in
interpret mode at up to 200 leaves and ``karras_topology_scan`` at about
20k leaves. child, first and last must be equal exactly: the tie rules
are part of the result."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.bvh.lbvh import adjacent_deltas as jadjacent_deltas
from tpurt.bvh.lbvh import karras_topology_scan
from tpurt.kernels.build import topology_pallas
from tpurt_torch.bvh.lbvh import adjacent_deltas
from tpurt_torch.kernels.build import topology, topology_cuda

torch.set_num_threads(1)


def _codes(name: str) -> np.ndarray:
    """Sorted 30-bit leaf codes (int32) of one case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "n2":
        c = np.array([5, 9])
    elif name == "n3":
        c = np.array([5, 5, 9])
    elif name == "all_equal":
        c = np.full(97, 12345)
    elif name == "heavy_ties":
        c = rng.integers(0, 16, 200)          # every code ~12 times
    elif name == "distinct":
        c = rng.choice(1 << 30, 150, replace=False)
    else:                                     # ~20k leaves, 64 values
        c = rng.choice(rng.integers(0, 1 << 30, 64), 20_000)
    return np.sort(c).astype(np.int32)


def _eq(got, want, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


@pytest.mark.parametrize("name", ["n2", "n3", "all_equal", "heavy_ties",
                                  "distinct"])
def test_equals_pallas_kernel(name):
    c = _codes(name)
    d = adjacent_deltas(torch.from_numpy(c))
    jd = jadjacent_deltas((jnp.asarray(c.astype(np.uint32)), None))
    _eq(d, jd, "deltas")
    want = topology_pallas(jd, interpret=True)
    got = topology(d)
    for a, b, what in zip(got, want, ("child", "first", "last")):
        assert a.dtype == torch.int32
        _eq(a, b, what)


@pytest.mark.parametrize("name", ["heavy_ties", "large_ties"])
def test_equals_scan_formulation(name):
    c = _codes(name)
    want = karras_topology_scan((jnp.asarray(c.astype(np.uint32)), None))
    got = topology(adjacent_deltas(torch.from_numpy(c)))
    for a, b, what in zip(got, want, ("child", "first", "last")):
        _eq(a, b, what)


def test_tree_is_a_partition():
    """Every leaf and every non-root node is some node's child exactly
    once, and each node's range is its children's."""
    c = _codes("large_ties")
    child, first, last = topology(adjacent_deltas(torch.from_numpy(c)))
    ch = child.numpy()
    ni = ch.shape[0]
    flat = np.sort(ch.reshape(-1))
    np.testing.assert_array_equal(
        flat, np.concatenate([-np.arange(ni + 1, 0, -1), np.arange(1, ni)]))
    assert first[0] == 0 and last[0] == ni

    def lo(r):
        return -r - 1 if r < 0 else int(first[r])

    def hi(r):
        return -r - 1 if r < 0 else int(last[r])
    for x in range(0, ni, 97):
        assert lo(ch[x, 0]) == first[x] and hi(ch[x, 1]) == last[x]
        assert hi(ch[x, 0]) + 1 == lo(ch[x, 1])


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        topology_cuda(torch.zeros(4, dtype=torch.int32))
