"""The w8t accel's layout (``WideBVHT``, ``tpurt``'s transposed-leaf
8-wide BVH) against the JAX package's, with no interpret mode: on trees
from ``tpurt``'s ``build_lbvh`` (teapot 1500, leaf 8 and 16) carried
across with ``tpurt_torch.convert``,

- ``transpose_leaf_rows``, ``build_wide_t``'s ``tris_t`` and
  ``make_leaf_attr_rows_t`` (untextured, and textured on a copy of the
  teapot with uv and layers from a seed) equal ``tpurt``'s bit for bit;
- the port's ``build_wide`` on the carried LBVH gives ``tpurt``'s nodes;
- ``widen_lbvh`` at leaf 16 keeps ``tpurt``'s f32[1, 128] row placeholder,
  and the row kernels' launcher refuses that accel's leaf size, while the
  w8t launchers take 8 and 16 and refuse the rest;
- ``convert.wide_bvh_t`` carries a ``tpurt`` WideBVHT field for field;
- csrc/transposed.cu's modes mirror ``traverse.W8T_*``.
"""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.bvh.lbvh as jlbvh
import tpurt.bvh.wide as jwide
import tpurt.passes.shading as jshading
import tpurt.scenes as jscenes
import tpurt.types as jtypes
import tpurt_torch.convert as convert
import tpurt_torch.kernels.traverse as tr
from tpurt_torch.bvh.wide import (WideBVHT, build_wide, build_wide_t,
                                  leaves_per_block, transpose_leaf_rows,
                                  widen_lbvh)
from tpurt_torch.passes.shading import make_leaf_attr_rows_t

from test_torch_multi_shadow import jax_checks_off
from test_torch_native import ensure_native_libraries

torch.set_num_threads(1)
ensure_native_libraries()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def textured_copy(mesh, seed: int = 0):
    """The mesh with per-vertex uv and per-triangle layers (-1..2) from a
    seed and a 3-layer 4x4 atlas (``tpurt``'s Mesh)."""
    rng = np.random.default_rng(seed)
    return jtypes.Mesh(
        vertices=mesh.vertices, normals=mesh.normals, indices=mesh.indices,
        albedo=mesh.albedo,
        uv=rng.uniform(-2.0, 3.0, (mesh.vertices.shape[0], 2))
        .astype(np.float32),
        tex_atlas=rng.uniform(0.0, 1.0, (3, 4, 4, 3)).astype(np.float32),
        tri_tex=rng.integers(-1, 3, mesh.indices.shape[0]).astype(np.int32))


@functools.lru_cache(maxsize=None)
def case(leaf: int):
    """tpurt's tree, wide accel and WideBVHT at ``leaf``, and the port's
    copy of the tree."""
    mesh = jscenes.teapot_scene(1500)
    with jax_checks_off():
        jb = jlbvh.build_lbvh(jnp.asarray(mesh.vertices),
                              jnp.asarray(mesh.indices), leaf_size=leaf)
        jw = jwide.build_wide(jb)
        jt = jwide.build_wide_t(jw, jb)
    return dict(mesh=mesh, jb=jb, jw=jw, jt=jt,
                tb=convert.lbvh(convert.numpy_fields(jb), "cpu"))


@pytest.mark.parametrize("leaf", [8, 16])
def test_transpose_leaf_rows_matches_tpurt(leaf):
    rng = np.random.default_rng(leaf)
    lpb = leaves_per_block(leaf)
    for nl in (1, lpb, 3 * lpb + 2):
        rows = rng.normal(size=(nl * leaf, 9)).astype(np.float32)
        want = np.asarray(jwide.transpose_leaf_rows(jnp.asarray(rows), leaf))
        got = transpose_leaf_rows(torch.from_numpy(rows), leaf).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.shape == (-(-nl // lpb), 8, 128)


def test_leaves_per_block_refuses_other_leaf_sizes():
    assert (leaves_per_block(8), leaves_per_block(16)) == (14, 7)
    for k in (4, 14):
        with pytest.raises(ValueError, match="leaf_size 8 or 16"):
            leaves_per_block(k)


@pytest.mark.parametrize("leaf", [8, 16])
def test_build_wide_and_build_wide_t_match_tpurt(leaf):
    """The port's build_wide on the carried LBVH gives tpurt's nodes; its
    WideBVHT gives tpurt's transposed blocks, and convert carries tpurt's
    WideBVHT to the same arrays."""
    c = case(leaf)
    wide = build_wide(c["tb"])
    np.testing.assert_array_equal(wide.nodes.numpy(), np.asarray(c["jw"].nodes))
    assert wide.num_wide == c["jw"].num_wide
    acc = build_wide_t(wide, c["tb"])
    carried = convert.wide_bvh_t(convert.numpy_fields(c["jt"]), "cpu")
    assert isinstance(acc, WideBVHT) and isinstance(carried, WideBVHT)
    for name in ("nodes", "tris_t", "tri_id", "root_min", "root_max"):
        np.testing.assert_array_equal(getattr(acc, name).numpy(),
                                      np.asarray(getattr(c["jt"], name)))
        assert torch.equal(getattr(acc, name), getattr(carried, name))
    for name in ("num_wide", "num_leaves", "leaf_size"):
        assert getattr(acc, name) == getattr(c["jt"], name) \
            == getattr(carried, name)


@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("leaf", [8, 16])
def test_make_leaf_attr_rows_t_matches_tpurt(leaf, textured):
    c = case(leaf)
    mesh = textured_copy(c["mesh"]) if textured else c["mesh"]
    with jax_checks_off():
        want = jshading.make_leaf_attr_rows_t(c["jb"], mesh)
    got = make_leaf_attr_rows_t(c["tb"], convert.mesh(
        convert.numpy_fields(mesh)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    at0 = got[0].numpy()
    if textured:
        assert got[1].shape == got[0].shape
        assert set(np.unique(at0[:, :, 5:126:9])) >= {-1.0, 0.0, 2.0}
    else:
        assert got[1].shape == (1, 8, 128) and not got[1].any()
    # A real triangle's id field is its original id (an exact float).
    ids = at0[:, :, 4:126:9].reshape(-1)
    assert set(np.unique(ids)) <= set(range(c["mesh"].indices.shape[0]))


def test_widen_lbvh_at_leaf16_keeps_the_row_placeholder():
    """tpurt stores a (1, 128) zero row for leaves of more than 14
    triangles; the port's widen does the same, and the row kernels'
    launcher refuses that accel's leaf size."""
    c = case(16)
    wide = widen_lbvh(c["tb"], c["jw"].num_wide)
    np.testing.assert_array_equal(wide.tris.numpy(), np.asarray(c["jw"].tris))
    assert wide.tris.shape == (1, 128) and not wide.tris.any()
    rays = torch.zeros((1, 10, 8, 128))
    kw = dict(leaf_size=16, t_min=0.0, max_iters=64, stack_size=256)
    for fn in (tr.closest_cuda, tr.any_cuda):
        before = fn.launches
        with pytest.raises(ValueError, match="leaf_size 16 outside 1..14"):
            fn(rays, wide.nodes, wide.tris, **kw)
        assert fn.launches == before


@pytest.mark.parametrize("leaf", [4, 14])
def test_w8t_launchers_refuse_other_leaf_sizes(leaf):
    acc = build_wide_t(build_wide(case(8)["tb"]), case(8)["tb"])
    kw = dict(leaf_size=leaf, t_min=0.0, max_iters=64, stack_size=256)
    for fn in (tr.w8t_any_cuda, tr.w8t_closest_cuda):
        with pytest.raises(ValueError, match="leaf_size 8 or 16"):
            fn(torch.zeros((1, 10, 8, 128)), acc.nodes, acc.tris_t, **kw)
    with pytest.raises(ValueError, match="leaf_size 8 or 16"):
        tr.w8t_closest_reference(torch.zeros((1, 10, 8, 128)), acc.nodes,
                                 acc.tris_t, **kw)


def test_transposed_modes_mirror_the_cuda_source():
    """csrc/transposed.cu's Mode numbers are traverse.W8T_*; the library's
    queries stay in fused_shadows.cu alone."""
    with open(os.path.join(ROOT, "tpurt_torch", "kernels", "csrc",
                           "transposed.cu")) as f:
        src = f.read()
    body = re.search(r"enum Mode \{(.*?)\};", src, re.S).group(1)
    modes = {m.split("=")[0].strip(): int(m.split("=")[1])
             for m in body.split(",")}
    assert modes == {"W8T_ANY": tr.W8T_ANY, "W8T_CLOSEST": tr.W8T_CLOSEST}
    for q in ("tpurt_stack_capacity", "tpurt_params_size"):
        assert q not in src
    assert "tpurt_transposed_launch" in src
