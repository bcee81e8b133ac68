"""The port's fused closest+shadow traversal (plain PyTorch version, which
the wrapper takes for CPU tensors) against the JAX package's Pallas kernel
in interpret mode, on the SAME accel carried across by tpurt_torch.convert,
and against the NumPy brute-force oracle on hand-made rays.

Tolerances: t to rtol 1e-6 (the per-ray walk and the packet walk run the
same arithmetic); u and v to 1e-4, because XLA's CPU compiler contracts
the Möller–Trumbore products of the reference into fused multiply-adds
while the port evaluates them unfused, as its CUDA kernel does
(``--fmad=false``), and barycentrics amplify that rounding by 1/det;
the other attribute channels to 1e-6 where the winning triangle agrees;
tri_id on >= 99.9% of valid pixels (ties on shared edges may pick
another triangle); occlusion mismatches <= 1e-3 of valid pixels (biased
origins sitting on a shadow boundary), as in tests/test_fused_shadow.py.
sidx is not compared: SBVH splits reference one triangle from several
leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.bvh.sah as jsah
import tpurt.bvh.wide as jwide
import tpurt.scenes as jscenes
from tpurt.bvh.reference import brute_force_any, brute_force_closest
from tpurt.camera import generate_rays as jgenerate_rays
from tpurt.kernels.traverse import trace_closest_shadow_pallas
from tpurt.passes.shading import make_leaf_attr_rows as jmake_leaf_attr_rows
import tpurt_torch.convert as convert
import tpurt_torch.scenes as tscenes
from tpurt_torch.bvh.sah import build_sah_lbvh
from tpurt_torch.bvh.wide import (count_wide, leaf_boxes_from_nodes,
                                  make_wide_plan, round_up_bucket,
                                  widen_from_plan)
from tpurt_torch.kernels.traverse import (_ray_packets_packed,
                                          check_stack_bound,
                                          check_walk_counts,
                                          closest_shadow_reference,
                                          trace_closest_shadow)
from tpurt_torch.passes.shading import make_leaf_attr_rows
from tpurt_torch.types import Mesh

torch.set_num_threads(1)

LIGHT_DIR = np.float32([0.45, 0.8, 0.3]) / np.float32(
    np.linalg.norm([0.45, 0.8, 0.3]))
LIGHT_POS = np.float32([2.0, 6.0, 1.0])
BIAS = 1e-3


def _parity_case(leaf: int):
    """tpurt's fused kernel (interpret mode) and the port's plain version
    on one accel, 64x32 camera rays, directional and point light. JAX's
    internal consistency checks (on in conftest) are off while the
    reference runs: they double its tracing time and check jax, not the
    port."""
    checks = jax.config.jax_enable_checks
    jax.config.update("jax_enable_checks", False)
    try:
        return _parity_outputs(leaf)
    finally:
        jax.config.update("jax_enable_checks", checks)


def _parity_outputs(leaf: int):
    mesh = jscenes.teapot_scene(1500)
    cam = jscenes.default_camera_for(mesh)
    bvh = jsah.build_sah_lbvh(mesh, leaf)
    wide = jwide.build_wide(bvh, from_node_boxes=True)
    at = jmake_leaf_attr_rows(bvh, mesh)
    acc = jwide.order_children_for_point(wide, cam.position)
    o, d = jgenerate_rays(cam, 64, 32)
    twide = convert.wide_bvh(convert.numpy_fields(acc), "cpu")
    tat = convert.attr_tables(at[0], at[1], "cpu")
    to, td = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))
    out = {}
    for kind, lpos in (("directional", None), ("point", LIGHT_POS)):
        ch, occ = trace_closest_shadow_pallas(
            acc, o, d, jnp.asarray(LIGHT_DIR), BIAS,
            light_pos=None if lpos is None else jnp.asarray(lpos),
            attr_tables=at, interpret=True)
        tch, tocc, counts = trace_closest_shadow(
            twide, to, td, LIGHT_DIR, BIAS, light_pos=lpos, attr_tables=tat)
        out[kind] = ({k: np.asarray(v) for k, v in ch.items()},
                     np.asarray(occ),
                     {k: v.numpy() for k, v in tch.items()}, tocc.numpy(),
                     counts.numpy())
    return out


def _check_hits(res):
    jch, _, tch, _, counts = res
    np.testing.assert_array_equal(counts, [0, 0])
    valid = jch["sidx"] >= 0
    np.testing.assert_array_equal(tch["sidx"] >= 0, valid)
    assert valid.any() and not valid.all()
    np.testing.assert_allclose(tch["t"][valid], jch["t"][valid],
                               rtol=1e-6, atol=1e-6)
    assert np.isinf(tch["t"][~valid]).all()


def _check_attrs(res):
    jch, _, tch, _, _ = res
    valid = jch["sidx"] >= 0
    same = (tch["tri_id"] == jch["tri_id"]) & valid
    assert same.sum() >= 0.999 * valid.sum()
    for k in ("u", "v"):
        np.testing.assert_allclose(tch[k][same], jch[k][same], atol=1e-4)
    for k in ("kd", "oct", "gn", "uv", "layer"):
        np.testing.assert_allclose(tch[k][same], jch[k][same], atol=1e-6,
                                   err_msg=k)


def _check_occlusion(res):
    jch, jocc, _, tocc, _ = res
    valid = jch["sidx"] >= 0
    mism = (tocc != jocc) & valid
    assert mism.sum() <= 1e-3 * valid.sum(), f"{mism.sum()} mismatches"
    assert not tocc[~valid].any()
    assert tocc[valid].any() and not tocc[valid].all()


@pytest.fixture(scope="module")
def leaf8():
    return _parity_case(8)


KINDS = ["directional", "point"]


@pytest.mark.parametrize("kind", KINDS)
def test_hits_match_pallas_leaf8(leaf8, kind):
    _check_hits(leaf8[kind])


@pytest.mark.parametrize("kind", KINDS)
def test_attributes_match_pallas_leaf8(leaf8, kind):
    _check_attrs(leaf8[kind])


@pytest.mark.parametrize("kind", KINDS)
def test_occlusion_matches_pallas_leaf8(leaf8, kind):
    _check_occlusion(leaf8[kind])


def test_ray_block_layout_matches_pallas():
    from tpurt.kernels.traverse import _ray_packets_packed as jpack
    mesh = jscenes.teapot_scene(1500)
    o, d = jgenerate_rays(jscenes.default_camera_for(mesh), 40, 70)
    jr, jp, _ = jpack(o, d, 3.4e38, 8)
    tr, tp, _ = _ray_packets_packed(torch.from_numpy(np.array(o)),
                                    torch.from_numpy(np.array(d)), 3.4e38, 8)
    assert jp == tp
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())


# ---------------------------------------------------------------------------
# Hand-made rays against the brute-force oracle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def oracle_scene():
    """Random soup + ground + one degenerate (collinear) triangle, leaf 4:
    small enough that the 8-wide collapse leaves empty slots."""
    soup = tscenes.random_soup(300, seed=3, extent=8.0, tri_size=0.5)
    ground = tscenes.make_plane(center=(0, -5, 0), size=(30, 30), subdiv=2)
    v = np.float32([[-3, 0, -3], [0, 0, 0], [3, 0, 3]])
    degen = tscenes.make_mesh(v, np.int32([[0, 1, 2]]))
    mesh = tscenes.merge_meshes([soup, ground, degen])
    bvh = build_sah_lbvh(mesh, "cpu", 4)
    plan = make_wide_plan(bvh, round_up_bucket(count_wide(bvh)))
    wide = widen_from_plan(plan, bvh, leaf_boxes_from_nodes(bvh))
    return mesh, wide, make_leaf_attr_rows(bvh, mesh)


def _axis_rays(axis: int, sign: float, n: int = 24):
    """n x n rays parallel to one axis, from outside the scene."""
    g = np.linspace(-6.0, 6.0, n, dtype=np.float32)
    # Unequal offsets keep the grid off the ground's shared diagonals,
    # where two triangles tie on t.
    a, b = np.meshgrid(g + np.float32(0.0137), g + np.float32(0.0291),
                       indexing="ij")
    o = np.zeros((n, n, 3), np.float32)
    others = [c for c in range(3) if c != axis]
    o[..., others[0]] = a
    o[..., others[1]] = b
    o[..., axis] = -20.0 * sign
    d = np.zeros((n, n, 3), np.float32)
    d[..., axis] = sign
    return o, d


def _oracle_mesh(mesh: Mesh):
    from tpurt.types import Mesh as JMesh
    return JMesh(vertices=mesh.vertices, normals=mesh.normals,
                 indices=mesh.indices, albedo=mesh.albedo)


@pytest.mark.parametrize("axis,sign", [(1, -1.0), (0, 1.0), (2, -1.0)])
def test_axis_parallel_rays_match_oracle(oracle_scene, axis, sign):
    mesh, wide, at = oracle_scene
    o, d = _axis_rays(axis, sign)
    ch, occ, counts = trace_closest_shadow(
        wide, torch.from_numpy(o), torch.from_numpy(d), LIGHT_DIR, BIAS,
        attr_tables=at)
    check_walk_counts(counts)
    jm = _oracle_mesh(mesh)
    bt, bid = brute_force_closest(jm, o.reshape(-1, 3), d.reshape(-1, 3))
    valid = ch["sidx"].numpy().reshape(-1) >= 0
    np.testing.assert_array_equal(valid, np.isfinite(bt))
    t = ch["t"].numpy().reshape(-1)
    np.testing.assert_allclose(t[valid], bt[valid], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ch["tri_id"].numpy().reshape(-1)[valid],
                                  bid[valid])
    # The degenerate triangle (last id) is never hit.
    assert not (bid == mesh.num_triangles - 1).any()

    # Shadows: rebuild the kernel's biased origin and scene-exit cap in
    # float64 and ask the oracle.
    gn = ch["gn"].numpy().reshape(-1, 3).astype(np.float64)[valid]
    dd = d.reshape(-1, 3).astype(np.float64)[valid]
    flip = np.where((gn * dd).sum(-1) > 0, -1.0, 1.0)
    un = gn / np.linalg.norm(gn, axis=-1, keepdims=True)
    so = (o.reshape(-1, 3)[valid] + t[valid][:, None] * dd
          + un * (BIAS * flip)[:, None])
    lo, hi = wide.root_min.numpy(), wide.root_max.numpy()
    with np.errstate(divide="ignore"):
        inv = 1.0 / LIGHT_DIR.astype(np.float64)
    ex = np.maximum((lo - so) * inv, (hi - so) * inv).min(-1)
    ref = brute_force_any(jm, so, np.broadcast_to(LIGHT_DIR, so.shape),
                          0.0, np.maximum(ex, 0.0) * 1.0001)
    got = occ.numpy().reshape(-1)[valid]
    assert (got != ref).sum() <= max(1, 1e-3 * valid.sum())
    assert not occ.numpy().reshape(-1)[~valid].any()


def test_oracle_scene_has_empty_slots(oracle_scene):
    """Empty slots carry inverted boxes the slab test alone accepts; the
    walk must skip them (their ref -1 would walk into leaf 0)."""
    _, wide, _ = oracle_scene
    rows = wide.nodes.numpy().reshape(-1, 8, 16)
    rows = rows[(rows[:, :, 0] <= rows[:, :, 3]).any(axis=1)]   # real nodes
    empty = rows[:, :, 0] > rows[:, :, 3]
    assert empty.any()
    assert (rows[:, :, 6][empty] == -1).all()


# ---------------------------------------------------------------------------
# Stack bound and iteration cap
# ---------------------------------------------------------------------------

def test_small_stack_bound_raises(oracle_scene):
    mesh, wide, at = oracle_scene
    o, d = _axis_rays(1, -1.0, 8)
    _, _, counts = trace_closest_shadow(
        wide, torch.from_numpy(o), torch.from_numpy(d), LIGHT_DIR, BIAS,
        attr_tables=at, stack_size=1)
    assert int(counts[0]) > 0
    with pytest.raises(RuntimeError, match="stack overflow"):
        check_walk_counts(counts)


def test_iteration_cap_raises(oracle_scene):
    _, wide, at = oracle_scene
    o, d = _axis_rays(1, -1.0, 8)
    rays, _, _ = _ray_packets_packed(torch.from_numpy(o),
                                     torch.from_numpy(d), 3.4e38, 1)
    scal = torch.cat([torch.from_numpy(LIGHT_DIR),
                      torch.clamp(1.0 / torch.from_numpy(LIGHT_DIR),
                                  -3.4e38, 3.4e38),
                      torch.tensor([BIAS]), wide.root_min, wide.root_max])
    _, _, counts = closest_shadow_reference(
        rays, wide.nodes, wide.tris, at[0], at[1], scal,
        leaf_size=wide.leaf_size, point=False, t_min=0.0, max_iters=1,
        stack_size=256)
    assert int(counts[1]) > 0
    with pytest.raises(RuntimeError, match="iteration cap"):
        check_walk_counts(counts)


def test_stack_bound_check_raises_for_deep_trees():
    check_stack_bound(36)                 # 7*36+1 = 253 fits 256
    with pytest.raises(ValueError, match="stack"):
        check_stack_bound(37)
