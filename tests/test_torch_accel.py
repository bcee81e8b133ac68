"""The port's static accel equals the JAX package's array for array: SAH
LBVH, wide-node count, wide rows, camera-ordered rows and leaf attribute
rows, on a teapot at leaf 8 and a Sponza-class hall at leaf 14."""

import jax
import numpy as np
import pytest
import torch

import tpurt.bvh.sah as jsah
import tpurt.bvh.wide as jwide
import tpurt.passes.shading as jshading
import tpurt.scenes as jscenes
import tpurt_torch.bvh.sah as tsah
import tpurt_torch.convert as convert
import tpurt_torch.bvh.wide as twide
import tpurt_torch.passes.shading as tshading
import tpurt_torch.scenes as tscenes

torch.set_num_threads(1)

CASES = {"teapot": ("teapot_scene", 1500, 8),
         "sponza": ("sponza_scene", 30_000, 14)}


@pytest.fixture(scope="module", params=sorted(CASES))
def built(request):
    name, n, leaf = CASES[request.param]
    jmesh = getattr(jscenes, name)(n)
    tmesh = getattr(tscenes, name)(n)
    cam = tscenes.default_camera_for(tmesh)

    jbvh = jsah.build_sah_lbvh(jmesh, leaf)
    jcount = jwide.count_wide(jbvh)
    nw_pad = jwide.round_up_bucket(max(jcount, 1))
    plan = jax.jit(jwide.make_wide_plan, static_argnames=("nw_pad", "mode"))(
        jbvh, nw_pad=nw_pad)
    jwide_bvh = jax.jit(jwide.widen_from_plan)(
        plan, jbvh, leaf_boxes=jax.jit(jwide.leaf_boxes_from_nodes)(jbvh))
    jordered = jax.jit(jwide.order_children_for_point)(jwide_bvh,
                                                       cam.position)
    jat = jax.jit(jshading.make_leaf_attr_rows)(jbvh, jmesh)

    tbvh = tsah.build_sah_lbvh(tmesh, "cpu", leaf)
    tcount = twide.count_wide(tbvh)
    tplan = twide.make_wide_plan(tbvh, twide.round_up_bucket(max(tcount, 1)))
    twide_bvh = twide.widen_from_plan(tplan, tbvh,
                                      twide.leaf_boxes_from_nodes(tbvh))
    tordered = twide.order_children_for_point(twide_bvh, cam.position)
    tat = tshading.make_leaf_attr_rows(tbvh, tmesh)
    return dict(j=(jbvh, jcount, jwide_bvh, jordered, jat),
                t=(tbvh, tcount, twide_bvh, tordered, tat))


def _eq(a, b, what):
    a = np.asarray(a)
    b = b.numpy()
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def test_sah_lbvh_equal(built):
    jbvh, tbvh = built["j"][0], built["t"][0]
    for f in ("nodes_box", "nodes_child", "nodes_first", "nodes_last",
              "tri_v0", "tri_e1", "tri_e2", "tri_sorted", "tri_id",
              "root_min", "root_max"):
        _eq(getattr(jbvh, f), getattr(tbvh, f), f)
    assert jbvh.leaf_size == tbvh.leaf_size


def test_count_wide_equal(built):
    assert built["j"][1] == built["t"][1] > 0


def test_wide_rows_equal(built):
    jw, tw = built["j"][2], built["t"][2]
    for f in ("nodes", "tris", "tri_id", "root_min", "root_max"):
        _eq(getattr(jw, f), getattr(tw, f), f)
    assert (jw.num_wide, jw.leaf_size) == (tw.num_wide, tw.leaf_size)


def test_camera_ordered_rows_equal(built):
    _eq(built["j"][3].nodes, built["t"][3].nodes, "ordered nodes")


def test_leaf_attr_rows_equal(built):
    (ja0, ja1), (ta0, ta1) = built["j"][4], built["t"][4]
    _eq(ja0, ta0, "at0")
    _eq(ja1, ta1, "at1")


def test_collapse_of_converted_lbvh_equals_jax(built):
    """tpurt's LBVH carried across by convert.lbvh collapses to tpurt's
    wide rows: the collapse is held apart from the build."""
    jbvh, _, jw = built["j"][:3]
    tbvh = convert.lbvh(convert.numpy_fields(jbvh), "cpu")
    plan = twide.make_wide_plan(tbvh, jw.num_wide)
    tw = twide.widen_from_plan(plan, tbvh, twide.leaf_boxes_from_nodes(tbvh))
    _eq(jw.nodes, tw.nodes, "nodes")
    _eq(jw.tris, tw.tris, "tris")


def test_wide_depth_fits_the_stack(built):
    from tpurt_torch.kernels.traverse import STACK_CAPACITY, stack_bound
    depth = twide.wide_depth(built["t"][2])
    assert 1 <= depth and stack_bound(depth) <= STACK_CAPACITY
