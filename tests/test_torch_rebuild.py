"""The port's on-device build and per-frame rebuild against the JAX
package's, array by array.

``tpurt`` on the CPU builds with its binary-search topology
(``karras_topology``), which numbers internal nodes otherwise than the
kernel formulation the port always runs (``topology_pallas``, equal to
``karras_topology_scan``). So the binary arrays are held against
``build_lbvh(builder="kernel")`` in interpret mode, and the sorted
triangle arrays and the rebuilt wide accel (whose rows carry only
breadth-first wide ids and leaf refs) against the default CPU build."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.app as japp
import tpurt.bvh.lbvh as jlbvh
import tpurt.bvh.wide as jwide
import tpurt.passes.shading as jshading
import tpurt.scenes as jscenes
import tpurt_torch.app as tapp
import tpurt_torch.bvh.lbvh as tlbvh
import tpurt_torch.bvh.wide as twide
import tpurt_torch.convert as convert
import tpurt_torch.passes.shading as tshading
import tpurt_torch.scenes as tscenes
from tpurt_torch.types import Light, RenderConfig

from test_torch_native import ensure_native_libraries

torch.set_num_threads(1)
ensure_native_libraries()

LEAF = 14


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _eq(a, b, what):
    a = np.asarray(a)
    b = b.numpy()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=what)


def _mesh_pair(name, n):
    jm = getattr(jscenes, name)(n)
    return jm, convert.mesh(convert.numpy_fields(jm))


# ---------------------------------------------------------------------------
# build_lbvh, clustered, leaf 14, with the attribute payload
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def builds():
    jm, tm = _mesh_pair("teapot_scene", 1500)
    m = jlbvh.auto_split_blocks(jm.num_triangles, LEAF)
    assert m == tlbvh.auto_split_blocks(tm.num_triangles, LEAF) > 0
    jv, ji = jnp.asarray(jm.vertices), jnp.asarray(jm.indices)
    jextra = jshading.attr_payload_columns(jax.device_put(jm))
    textra = tshading.attr_payload_columns(tm, "cpu")
    tv, ti = _t(tm.vertices), _t(tm.indices)
    out = {}
    for boxes in ("full", "defer"):
        out[boxes] = dict(
            kernel=jlbvh.build_lbvh(jv, ji, leaf_size=LEAF, builder="kernel",
                                    boxes=boxes, extra_payload=jextra,
                                    split_blocks=m),
            search=jlbvh.build_lbvh(jv, ji, leaf_size=LEAF, boxes=boxes,
                                    extra_payload=jextra, split_blocks=m),
            port=tlbvh.build_lbvh(tv, ti, leaf_size=LEAF, boxes=boxes,
                                  extra_payload=textra, split_blocks=m))
    out["extras"] = (jextra, textra)
    return out


SORTED = ("tri_v0", "tri_e1", "tri_e2", "tri_sorted", "tri_id", "root_min",
          "root_max", "leaf_block", "leaf_min", "leaf_max")
BINARY = ("nodes_child", "nodes_first", "nodes_last")


def test_attr_payload_columns_equal(builds):
    jextra, textra = builds["extras"]
    for i, (a, b) in enumerate(zip(jextra, textra)):
        _eq(a, b, f"column {i}")


@pytest.mark.parametrize("boxes", ["full", "defer"])
def test_build_equals_kernel_builder(builds, boxes):
    (jb, jcols), (tb, tcols) = builds[boxes]["kernel"], builds[boxes]["port"]
    fields = SORTED + BINARY + (("nodes_box",) if boxes == "full" else ())
    for f in fields:
        _eq(getattr(jb, f), getattr(tb, f), f)
    if boxes == "defer":
        assert jb.nodes_box is None and tb.nodes_box is None
    for i, (a, b) in enumerate(zip(jcols, tcols)):
        _eq(a, b, f"sorted column {i}")
    assert tb.num_leaves == tb.num_blocks + tlbvh.auto_split_blocks(
        tb.num_sorted_tris, LEAF)


def test_search_builder_differs_only_in_node_ids(builds):
    """The default CPU build of tpurt has the same sorted arrays and leaf
    ranges; its internal node ids are another numbering."""
    (jb, _), (tb, _) = builds["full"]["search"], builds["full"]["port"]
    for f in SORTED:
        _eq(getattr(jb, f), getattr(tb, f), f)
    jr = np.stack([np.asarray(jb.nodes_first), np.asarray(jb.nodes_last)], 1)
    tr = np.stack([tb.nodes_first.numpy(), tb.nodes_last.numpy()], 1)
    np.testing.assert_array_equal(np.unique(jr, axis=0),
                                  np.unique(tr, axis=0))


@pytest.mark.parametrize("boxes", ["full", "defer"])
def test_converted_clustered_tree_collapses_alike(builds, boxes):
    """convert.lbvh carries the clustering fields (and a missing
    nodes_box): tpurt's kernel-built tree collapses to the port's rows."""
    jb, tb = builds[boxes]["kernel"][0], builds[boxes]["port"][0]
    cb = convert.lbvh(convert.numpy_fields(jb), "cpu")
    assert (cb.nodes_box is None) == (boxes == "defer")
    for f in ("leaf_block", "leaf_min", "leaf_max"):
        assert torch.equal(getattr(cb, f), getattr(tb, f)), f
    nw_pad = twide.round_up_bucket(twide.count_wide(builds["full"]["port"][0]),
                                   64)
    (cw, cc), (tw, tc) = (twide.widen_area_kernel(b, nw_pad)
                          for b in (cb, tb))
    assert int(cc) == int(tc) <= nw_pad
    assert torch.equal(cw.nodes, tw.nodes) and torch.equal(cw.tris, tw.tris)


def test_count_wide_on_clustered_tree(builds):
    jb, tb = builds["full"]["kernel"][0], builds["full"]["port"][0]
    assert twide.count_wide(tb) == jwide.count_wide(jb, mode="area") > 0


def test_subleaf_split_all_duplicate_block():
    """A block whose codes are all equal scores INT32_MIN; its negated key
    wraps to INT32_MIN, so it ranks FIRST among the split candidates."""
    rng = np.random.default_rng(4)
    k, nb = 4, 12
    codes = np.sort(rng.integers(0, 1 << 30, nb * k)).astype(np.uint32)
    codes[5 * k:6 * k] = codes[5 * k]          # block 5: all equal
    codes[9 * k:10 * k] = codes[9 * k]         # block 9: all equal
    codes = np.sort(codes)
    tmin = rng.uniform(-1, 0, (nb * k, 3)).astype(np.float32)
    tmax = tmin + rng.uniform(0, 1, (nb * k, 3)).astype(np.float32)
    for m in (1, 2, 5):
        want = jlbvh._subleaf_split(jnp.asarray(codes), jnp.asarray(tmin),
                                    jnp.asarray(tmax), k, m)
        got = tlbvh._subleaf_split(_t(codes.astype(np.int32)), _t(tmin),
                                   _t(tmax), k, m)
        for a, b, what in zip(want, got, ("leaf_block", "sub_codes",
                                          "sub_min", "sub_max")):
            _eq(a, b, f"m={m} {what}")
    # With m = 2 exactly the two all-equal blocks split.
    lb = tlbvh._subleaf_split(_t(codes.astype(np.int32)), _t(tmin),
                              _t(tmax), k, 2)[0].numpy()
    assert sorted(set(int(b) for b in lb if (lb == b).sum() == 2)) == [5, 9]


# ---------------------------------------------------------------------------
# _rebuild_fused, the per-frame rebuild
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leaf", [4, 14])
def test_rebuild_fused_equals_jax(leaf):
    jm, tm = _mesh_pair("random_soup", 250)
    m = jlbvh.auto_split_blocks(250, leaf)
    jv, ji = jnp.asarray(jm.vertices), jnp.asarray(jm.indices)
    nw_pad = jwide.round_up_bucket(max(jwide.count_wide(
        jlbvh.build_lbvh(jv, ji, leaf_size=leaf, split_blocks=m),
        mode="area"), 1), 64)
    _, jw, _, _, jat, jcnt = japp._rebuild_fused(
        jv, ji, jax.device_put(jm), leaf, nw_pad, tables="attr",
        collapse="area", split_blocks=m)
    dm = tm.on("cpu")
    tb, tw, tat, tcnt = tapp._rebuild_fused(dm.vertices, dm.indices, dm,
                                            leaf, nw_pad, split_blocks=m)
    assert int(tcnt) == int(jcnt) <= nw_pad
    assert twide.count_wide(tlbvh.build_lbvh(
        dm.vertices, dm.indices, leaf_size=leaf, split_blocks=m)) \
        == int(tcnt)
    for f in ("nodes", "tris", "tri_id", "root_min", "root_max"):
        _eq(getattr(jw, f), getattr(tw, f), f)
    _eq(jat[0], tat[0], "at0")
    _eq(jat[1], tat[1], "at1")
    assert tw.num_wide == jw.num_wide == nw_pad


def test_leaf_attr_rows_from_sorted_equal_gathered():
    """The rebuild's attribute rows (from sorted payload columns) equal the
    static gather's on the same tree."""
    tm = tscenes.teapot_scene(1500)
    dm = tm.on("cpu")
    bvh, cols = tlbvh.build_lbvh(
        dm.vertices, dm.indices, leaf_size=LEAF,
        extra_payload=tshading.attr_payload_columns(dm, "cpu"),
        split_blocks=27)
    a = tshading.leaf_attr_rows_from_sorted(cols, bvh.tri_id,
                                            bvh.num_blocks, LEAF)
    b = tshading.make_leaf_attr_rows(bvh, tm)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_smooth_normals_device_close_to_jax():
    jm = jscenes.teapot_scene(1500)
    v = jscenes.deform(jm, 0.4)
    want = np.asarray(jax.jit(jshading.smooth_normals_device)(
        jnp.asarray(v), jnp.asarray(jm.indices)))
    got = tshading.smooth_normals_device(_t(v), _t(jm.indices)).numpy()
    # The cross products round otherwise where XLA fuses multiply-adds.
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


# ---------------------------------------------------------------------------
# Static accel from the on-device build (sah=False, gbuffer="ray")
# ---------------------------------------------------------------------------

def test_static_morton_accel_equals_jax():
    """Renderer(sah=False, gbuffer="ray"): build_lbvh and the static area
    collapse, equal to tpurt's on the kernel-built tree (its wide ids
    follow the binary node ids, so the search builder's would differ)."""
    jm, tm = _mesh_pair("teapot_scene", 1500)
    jb = jlbvh.build_lbvh(jnp.asarray(jm.vertices), jnp.asarray(jm.indices),
                          leaf_size=8, builder="kernel")
    nw_pad = jwide.round_up_bucket(max(jwide.count_wide(jb), 1))
    plan = jax.jit(jwide.make_wide_plan, static_argnames=("nw_pad", "mode"))(
        jb, nw_pad=nw_pad)
    jw = jax.jit(jwide.widen_from_plan)(
        plan, jb, leaf_boxes=jax.jit(jwide.leaf_boxes_from_nodes)(jb))
    jat = jax.jit(jshading.make_leaf_attr_rows)(jb, jm)
    r = tapp.Renderer(tm, tscenes.default_camera_for(tm),
                      Light.directional((0.45, 0.8, 0.3)),
                      RenderConfig(width=32, height=32, leaf_size=8,
                                   sah=False, gbuffer="ray"), device="cpu")
    for f in ("nodes", "tris", "tri_id", "root_min", "root_max"):
        _eq(getattr(jw, f), getattr(r.accel, f), f)
    _eq(jat[0], r.attr_tables[0], "at0")
    assert "lbvh_build_ms" in r.stats
