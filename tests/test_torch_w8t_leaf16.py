"""The port's w8t walks against the JAX package's transposed-leaf kernels
in interpret mode at leaf 16, the only leaf size above 14 that either
package can walk (two groups of 8 triangles a leaf, 7 leaves a block):
tests/test_torch_w8t.py's checks on ``tpurt``'s own leaf-16 WideBVHT,
without textures (the textured walk is held at leaf 8), and against
``tpurt.bvh.traverse`` at 96x64.
"""

import pytest
import torch

from test_torch_native import ensure_native_libraries
from test_torch_w8t import (check_against_traverse, check_any, check_attrs,
                            check_closest, jax_results, w8t_scene)

torch.set_num_threads(1)
ensure_native_libraries()


@pytest.fixture(scope="module")
def leaf16():
    s = w8t_scene(16)
    assert s.acc.leaf_size == 16 and s.acc.tris_t.shape[1:] == (8, 128)
    return s, jax_results(s)


def test_w8t_closest_matches_pallas_leaf16(leaf16):
    check_closest(*leaf16)


def test_w8t_any_matches_pallas_leaf16(leaf16):
    check_any(*leaf16)


def test_w8t_attrs_match_pallas_leaf16(leaf16):
    s, jres = leaf16
    check_attrs(s, jres["attrs"], s.tat, textured=False)


def test_w8t_walks_match_the_portable_traversal_leaf16():
    check_against_traverse(16)
