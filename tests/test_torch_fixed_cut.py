"""The rebuild's fixed depth-3 cut (``rebuild_collapse="fixed"``) against
the JAX package's: the topology's depth output (the plain version,
``topology_depth_reference``, against ``topology_pallas(want_depth=True)``
in interpret mode and against ``node_depths``), ``widen_lbvh(mode=
"fixed")`` with and without the depths on full- and deferred-box,
plain and clustered builds against ``tpurt``'s on its kernel-builder
tree (``tpurt``'s CPU search builder numbers the nodes otherwise, and the
fixed cut's wide ids follow them), ``count_wide`` and
``wide_count_device``, and a whole rebuilt frame against ``tpurt``'s
Renderer. Arrays equal exactly; the frame as tests/test_torch_app.py
holds frames (at most 2e-3 of pixels off by more than 1e-3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.bvh.lbvh as jlbvh
import tpurt.bvh.wide as jwide
import tpurt.scenes as jscenes
from tpurt.bvh.lbvh import adjacent_deltas as jadjacent_deltas
from tpurt.kernels.build import topology_pallas
from tpurt.types import Light as JLight
from tpurt.types import RenderConfig as JRenderConfig
import tpurt_torch.bvh.lbvh as tlbvh
import tpurt_torch.bvh.wide as twide
import tpurt_torch.convert as convert
from tpurt_torch.app import (FIXED_CUT_DEPTH_BOUND, KARRAS_DEPTH_BOUND,
                             Renderer, check_slice)
from tpurt_torch.kernels.build import (node_depths, topology,
                                       topology_depth_reference)
from tpurt_torch.kernels.traverse import STACK_CAPACITY, stack_bound
from tpurt_torch.types import Light, RenderConfig

from test_torch_app import _assert_close_frames, _jax_frame
from test_torch_native import ensure_native_libraries
from test_torch_topology import _codes

torch.set_num_threads(1)
ensure_native_libraries()

DIRECTION = (0.45, 0.8, 0.3)


def _eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


@pytest.mark.parametrize("name", ["n2", "n3", "all_equal", "heavy_ties",
                                  "distinct"])
def test_depth_equals_pallas_kernel(name):
    c = _codes(name)
    jd = jadjacent_deltas((jnp.asarray(c.astype(np.uint32)), None))
    want = topology_pallas(jd, interpret=True, want_depth=True)
    d = tlbvh.adjacent_deltas(torch.from_numpy(c))
    got = topology(d, want_depth=True)
    assert len(got) == 4 and got[3].dtype == torch.int32
    for a, b, what in zip(got, want, ("child", "first", "last", "depth")):
        _eq(a.numpy(), b, what)
    assert int(got[3][0]) == 0


@pytest.mark.parametrize("name", ["heavy_ties", "large_ties"])
def test_depth_equals_node_depths(name):
    c = _codes(name)
    child, _, _, depth = topology_depth_reference(
        tlbvh.adjacent_deltas(torch.from_numpy(c)))
    _eq(depth.numpy(), node_depths(child).numpy(), "port node_depths")
    _eq(depth.numpy(), jwide.node_depths(jnp.asarray(child.numpy())),
        "tpurt node_depths")
    assert int(depth.max()) <= KARRAS_DEPTH_BOUND


@pytest.fixture(scope="module")
def trees():
    """tpurt's kernel-builder trees and the port's, with depths, on a
    600-triangle soup at leaf 4: plain and clustered, full and deferred
    boxes."""
    jm = jscenes.random_soup(600)
    tm = convert.mesh(convert.numpy_fields(jm))
    jv, ji = jnp.asarray(jm.vertices), jnp.asarray(jm.indices)
    tv = torch.from_numpy(np.asarray(tm.vertices))
    ti = torch.from_numpy(np.asarray(tm.indices))
    out = {}
    for split in (0, jlbvh.auto_split_blocks(600, 4)):
        for boxes in ("full", "defer"):
            out[split > 0, boxes] = (
                jlbvh.build_lbvh(jv, ji, leaf_size=4, builder="kernel",
                                 boxes=boxes, want_depth=True,
                                 split_blocks=split),
                tlbvh.build_lbvh(tv, ti, leaf_size=4, boxes=boxes,
                                 want_depth=True, split_blocks=split))
    return out


CASES = [(c, b) for c in (False, True) for b in ("full", "defer")]


@pytest.mark.parametrize("clustered,boxes", CASES)
@pytest.mark.parametrize("with_depths", [True, False])
def test_widen_fixed_equals_jax(trees, clustered, boxes, with_depths):
    (jb, jd), (tb, td) = trees[clustered, boxes]
    _eq(td.numpy(), jd, "depth")
    jcount = int(jwide.wide_count_device(jb, mode="fixed", depths=jd))
    tcount = twide.wide_count_device(tb, mode="fixed",
                                     depths=td if with_depths else None)
    assert tcount.dtype == torch.int32 and int(tcount) == jcount
    nw = jwide.round_up_bucket(jcount, 64)
    jw = jwide.widen_lbvh(jb, nw_pad=nw, mode="fixed",
                          depths=jd if with_depths else None)
    tw = twide.widen_lbvh(tb, nw, mode="fixed",
                          depths=td if with_depths else None)
    for f in ("nodes", "tris", "tri_id", "root_min", "root_max"):
        _eq(getattr(tw, f).numpy(), getattr(jw, f), f)
    assert tw.num_wide == jw.num_wide == nw
    # Internal refs sit exactly 3 levels below their wide node, so at most
    # ceil(96 / 3) wide levels: the bound every fixed rebuild relies on.
    assert twide.wide_depth(tw) <= FIXED_CUT_DEPTH_BOUND


@pytest.mark.parametrize("clustered", [False, True])
def test_count_wide_fixed_equals_jax(trees, clustered):
    jb, tb = trees[clustered, "full"][0][0], trees[clustered, "full"][1][0]
    assert twide.count_wide(tb, mode="fixed") \
        == jwide.count_wide(jb, mode="fixed")
    # A deferred-box build has no node areas: "area" counts the fixed cut.
    jdb, tdb = (t[0] for t in trees[clustered, "defer"])
    assert int(twide.wide_count_device(tdb, mode="area")) \
        == int(jwide.wide_count_device(jdb, mode="area")) \
        == int(twide.wide_count_device(tdb, mode="fixed"))


def test_overflowed_cut_is_counted_and_clamped(trees):
    """A pad below the count: the count says so, and the rows stay
    in range (such an accel is never rendered)."""
    _, (tb, td) = trees[True, "defer"]
    count = int(twide.wide_count_device(tb, mode="fixed", depths=td))
    tw = twide.widen_lbvh(tb, count // 2, mode="fixed", depths=td)
    refs = tw.nodes.reshape(-1, 8, 16)[:, :, 6]
    assert tw.nodes.shape == (count // 2, 128)
    assert int(refs.max()) < count // 2


def test_build_lbvh_returns_in_tpurt_order():
    jm = jscenes.random_soup(120)
    tv = torch.from_numpy(np.asarray(jm.vertices))
    ti = torch.from_numpy(np.asarray(jm.indices))
    extra = (torch.arange(120, dtype=torch.float32),)
    bvh, cols, depth = tlbvh.build_lbvh(tv, ti, leaf_size=4,
                                        extra_payload=extra, want_depth=True)
    assert isinstance(bvh, tlbvh.LBVH) and len(cols) == 1
    _eq(depth.numpy(), node_depths(bvh.nodes_child).numpy(), "depth")
    bvh2, depth2 = tlbvh.build_lbvh(tv, ti, leaf_size=4, want_depth=True)
    _eq(depth2.numpy(), depth.numpy(), "depth without payload")


def test_fixed_cut_bound_fits_the_stack():
    assert FIXED_CUT_DEPTH_BOUND == 32
    assert stack_bound(FIXED_CUT_DEPTH_BOUND) == 225 <= STACK_CAPACITY


@pytest.mark.parametrize("splits", [-1, 0])
def test_fixed_rebuild_frame_matches_jax_renderer(splits):
    fields = dict(width=64, height=48, leaf_size=8, rebuild_collapse="fixed",
                  rebuild_splits=splits, gbuffer="ray")
    jmesh = jscenes.teapot_scene(1500)
    jimg = _jax_frame(jmesh, jscenes.default_camera_for(jmesh),
                      JLight.directional(DIRECTION), JRenderConfig(**fields),
                      mode="rebuild")
    tmesh = convert.mesh(convert.numpy_fields(jmesh))
    r = Renderer(tmesh, jscenes.default_camera_for(jmesh),
                 Light.directional(DIRECTION), RenderConfig(**fields),
                 mode="rebuild", device="cpu")
    out = r.render_frame()
    assert out["walk_counts"].tolist() == [0, 0]
    _assert_close_frames(jimg, out["image"].numpy())
    # The rebuilt accel is the fixed cut of the frame's tree.
    bvh, depth = tlbvh.build_lbvh(r.mesh.vertices, r.mesh.indices,
                                  leaf_size=8, boxes="defer",
                                  want_depth=True,
                                  split_blocks=r._rebuild_splits)
    want = twide.widen_lbvh(bvh, r._nw_pad, mode="fixed", depths=depth)
    assert torch.equal(r.accel.nodes, want.nodes)


def test_check_slice_takes_fixed_and_refuses_others():
    mesh = jscenes.teapot_scene(200)
    lights = [Light.directional(DIRECTION)]
    check_slice(RenderConfig(rebuild_collapse="fixed", gbuffer="ray"),
                "rebuild", lights, mesh, None)
    with pytest.raises(NotImplementedError, match="rebuild_collapse"):
        check_slice(RenderConfig(rebuild_collapse="bfs", gbuffer="ray"),
                    "rebuild", lights, mesh, None)
    # top_sah is taken on the plain tree and refused with sub-leaf
    # clustering, where tpurt fails (tests/test_torch_sweep_sah.py).
    check_slice(RenderConfig(rebuild_collapse="fixed", top_sah=True,
                             gbuffer="ray"), "rebuild", lights, mesh, None)
    with pytest.raises(NotImplementedError, match="top_sah"):
        check_slice(RenderConfig(rebuild_collapse="fixed", top_sah=True,
                                 gbuffer="ray"), "rebuild", lights, mesh,
                    None, 4)
