"""The binary kernels' layout (``tpurt_torch/kernels/pack.py``) against the
JAX package's ``tpurt/kernels/pack.py``: ``pack_bvh`` on the same LBVH
(``tpurt``'s, carried across with ``convert.lbvh``) equal bit for bit at
leaf 1, 4, 8 and 14; both refuse a 15-triangle leaf and a sub-leaf
clustered tree; ``packed_shapes`` and ``binary_vmem_bytes`` equal; the
port's ``tree_depth`` against a walk of the tree, and the Karras bound the
binary rebuild checks its stack against."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.bvh.lbvh as jlbvh
import tpurt.kernels.pack as jpack
import tpurt.scenes as jscenes
import tpurt_torch.bvh.lbvh as tlbvh
import tpurt_torch.convert as convert
import tpurt_torch.kernels.pack as tpack
from tpurt_torch.app import KARRAS_DEPTH_BOUND
from tpurt_torch.kernels.traverse import (STACK_CAPACITY,
                                          check_binary_stack_bound)

torch.set_num_threads(1)


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


N_TRIS = 400
_build = jax.jit(jlbvh.build_lbvh, static_argnames=("leaf_size",
                                                     "split_blocks"))


@functools.lru_cache(maxsize=None)
def _tpurt_tree(leaf: int, split_blocks: int = 0):
    """tpurt's on-device build of the teapot (its CPU search builder)."""
    mesh = jscenes.teapot_scene(N_TRIS)
    return _build(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices),
                  leaf_size=leaf, split_blocks=split_blocks)


@pytest.mark.parametrize("leaf", [1, 4, 8, 14])
def test_pack_bvh_equals_tpurt_bit_for_bit(leaf):
    jb = _tpurt_tree(leaf)
    jp = jpack.pack_bvh(jb)
    tp = tpack.pack_bvh(convert.lbvh(convert.numpy_fields(jb), "cpu"))
    for name in ("nodes", "tris", "tri_id"):
        a, b = _bits(getattr(jp, name)), _bits(getattr(tp, name).numpy())
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert (tp.num_internal, tp.num_leaves, tp.leaf_size) == \
        (jp.num_internal, jp.num_leaves, jp.leaf_size)
    np.testing.assert_array_equal(tp.root_min.numpy(),
                                  np.asarray(jb.root_min))
    # Child refs ride as float values, exact integers.
    refs = tp.nodes.reshape(-1, 16)[:tp.num_internal, 12:14]
    assert torch.equal(refs, refs.round())


def test_pack_refuses_a_leaf_wider_than_a_row():
    jb = _tpurt_tree(15)
    with pytest.raises(ValueError, match="leaf_size 15"):
        jpack.pack_bvh(jb)
    with pytest.raises(ValueError, match="leaf_size 15"):
        tpack.pack_bvh(convert.lbvh(convert.numpy_fields(jb), "cpu"))


def test_pack_refuses_a_clustered_tree():
    """A sub-leaf clustered tree has more leaves than triangle blocks:
    tpurt's leaf-row reshape fails, and the port says why."""
    jb = _tpurt_tree(4, split_blocks=40)
    assert jb.leaf_block is not None
    with pytest.raises(TypeError, match="reshape"):
        jpack.pack_bvh(jb)
    with pytest.raises(ValueError, match="clustered"):
        tpack.pack_bvh(convert.lbvh(convert.numpy_fields(jb), "cpu"))


@pytest.mark.parametrize("ntris,leaf", [(1, 4), (7, 4), (700, 1),
                                        (287_176, 14), (287_176, 4),
                                        (100_003, 8)])
def test_packed_shapes_and_budget_equal_tpurt(ntris, leaf):
    assert tpack.packed_shapes(ntris, leaf) == \
        jpack.packed_shapes(ntris, leaf)
    assert tpack.binary_vmem_bytes(ntris, leaf) == \
        jpack.binary_vmem_bytes(ntris, leaf)


def test_packed_shapes_match_a_build():
    jb = _tpurt_tree(8)
    tp = tpack.pack_bvh(convert.lbvh(convert.numpy_fields(jb), "cpu"))
    ntris = jscenes.teapot_scene(N_TRIS).num_triangles
    ni, nl, rows = tpack.packed_shapes(ntris, 8)
    assert (ni, nl, rows) == (tp.num_internal, tp.num_leaves,
                              tp.nodes.shape[0])
    assert tpack.binary_vmem_bytes(ntris, 8) == \
        (tp.nodes.numel() + tp.tris.numel()) * 4


def _depth_by_recursion(child: np.ndarray) -> int:
    best, todo = 0, [(0, 0)]
    while todo:
        node, d = todo.pop()
        best = max(best, d)
        todo += [(int(c), d + 1) for c in child[node] if c >= 0]
    return best


@pytest.mark.parametrize("bits", [30, 60])
def test_tree_depth_and_the_karras_bound(bits):
    """tree_depth is the deepest internal node (root = 0); a Morton tree
    of either key width stays inside the bound the rebuild checks (the
    deltas grow from a node to its children and lie below 96)."""
    mesh = jscenes.teapot_scene(1500)
    tb = tlbvh.build_lbvh(torch.from_numpy(np.array(mesh.vertices)),
                          torch.from_numpy(np.array(mesh.indices)),
                          leaf_size=4, morton_bits=bits)
    depth = tpack.tree_depth(tb.nodes_child)
    assert depth == _depth_by_recursion(tb.nodes_child.numpy())
    assert 0 < depth <= KARRAS_DEPTH_BOUND
    check_binary_stack_bound(KARRAS_DEPTH_BOUND)
    check_binary_stack_bound(STACK_CAPACITY - 1)
    with pytest.raises(ValueError, match="per-ray stack"):
        check_binary_stack_bound(STACK_CAPACITY)


def test_convert_packed_bvh_carries_tpurts_rows():
    jp = jpack.pack_bvh(_tpurt_tree(8))
    tp = convert.packed_bvh(convert.numpy_fields(jp), "cpu")
    np.testing.assert_array_equal(_bits(tp.nodes.numpy()), _bits(jp.nodes))
    np.testing.assert_array_equal(tp.tri_id.numpy(), np.asarray(jp.tri_id))
    assert tp.root_min is None and tp.num_internal == jp.num_internal
