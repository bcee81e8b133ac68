"""The work counts of the port's plain walks, from which chip_smoke.py
computes each kernel's operation bound, and the CUDA launch boundary
that this box can check without a card.

The counts must be those of the work the kernels do: a node pop slab-tests
only its non-empty child boxes, the closest walk tests every triangle of a
leaf it visits, and an any-hit walk stops at the first occluding triangle
(csrc/walk.cuh ``child_hits``, ``leaf_closest``, ``leaf_occluded``).
"""

import functools
import os
import re

import pytest
import torch

import tpurt_torch.kernels.traverse as tr
from tpurt_torch.app import Renderer
from tpurt_torch.kernels._variants import VARIANT_KERNELS
from tpurt_torch.kernels.build import topology_and_boxes_cuda
from tpurt_torch.kernels.raster import rasterize_tiles_cuda
from tpurt_torch.bvh.wide import order_children_for_point
from tpurt_torch.camera import generate_rays
from tpurt_torch.scenes import default_camera_for, teapot_scene
from tpurt_torch.types import Light, RenderConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 4


def one_leaf_tree():
    """A root row whose child 0 is leaf 0 (box [-1, 30]^2 x [0.5, 2.5]) and
    whose other 7 slots are empty (inverted boxes); leaf 0 holds K
    triangles: two far off the rays, then two unit right triangles in the
    planes z = 1 and z = 2 over [0, 1]^2."""
    nodes = torch.zeros((1, 128), dtype=torch.float32)
    rows = nodes.view(8, 16)
    rows[:, 0:3] = 1.0
    rows[:, 3:6] = -1.0
    rows[0, 0:6] = torch.tensor([-1.0, -1.0, 0.5, 30.0, 30.0, 2.5])
    rows[0, 6] = -1.0                      # leaf 0
    tris = torch.zeros((1, 128), dtype=torch.float32)
    e1, e2 = [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]
    for j, v0 in enumerate(([10.0, 10.0, 1.0], [20.0, 20.0, 1.0],
                            [0.0, 0.0, 1.0], [0.0, 0.0, 2.0])):
        tris[0, 9 * j:9 * j + 9] = torch.tensor(v0 + e1 + e2)
    return nodes, tris


def rays_up(xy):
    """Rays along +z from (x, y, 0), t_max 10."""
    n = len(xy)
    o = (torch.tensor([p[0] for p in xy]), torch.tensor([p[1] for p in xy]),
         torch.zeros(n))
    d = (torch.zeros(n), torch.zeros(n), torch.ones(n))
    inv = tuple(torch.clamp(1.0 / c, -3.4e38, 3.4e38) for c in d)
    return o, d, inv, torch.full((n,), 10.0)


def test_anyhit_counts_stop_at_the_first_occluder():
    """Ray A hits triangles 2 and 3 and stops at 2 (3 tests); ray B enters
    the leaf's box and hits nothing (K tests)."""
    nodes, tris = one_leaf_tree()
    o, d, inv, tmax = rays_up([(0.2, 0.2), (5.0, 5.0)])
    stats = {}
    occ, ovf, cap = tr._anyhit_walk(nodes, tris, K, o, d, inv, tmax, 0.0,
                                    100, 8, stats)
    assert occ.tolist() == [True, False]
    assert (int(ovf), int(cap)) == (0, 0)
    counts = {k: int(v) for k, v in stats.items()}
    assert counts == {"pops": 2, "slab_tests": 2, "anyhit_tris": 3 + K,
                      "anyhit_leaf_tris": 2 * K}


def test_closest_counts_every_triangle_of_a_visited_leaf():
    nodes, tris = one_leaf_tree()
    o, d, inv, tmax = rays_up([(0.2, 0.2), (5.0, 5.0)])
    stats = {}
    best_t, best_i, _, _, _ = tr._closest_walk(
        nodes, tris, tris, tris[:1], K, o, d, inv, tmax, 0.0, 100, 8, stats)
    assert best_i.tolist() == [2, -1]
    assert float(best_t[0]) == 1.0
    assert {k: int(v) for k, v in stats.items()} == {
        "pops": 2, "slab_tests": 2, "closest_tris": 2 * K}


@pytest.fixture(scope="module")
def teapot():
    mesh = teapot_scene(1500)
    cam = default_camera_for(mesh)
    r = Renderer(mesh, cam, Light.directional((0.45, 0.8, 0.3)),
                 RenderConfig(width=64, height=32, leaf_size=8),
                 device="cpu")
    acc = order_children_for_point(r.accel, cam.position)
    o, d = generate_rays(cam, 64, 32, "cpu")
    return acc, r.attr_tables, o, d


def _gbuf(acc, at, o, d):
    """The plain G-buffer of the teapot rays, for the shadow-ray kernels."""
    from tpurt_torch.passes.gbuffer import gbuf_from_attr_channels
    mesh = teapot_scene(1500)
    ch, _ = tr.trace_closest_attrs(acc, o, d, at)
    return gbuf_from_attr_channels(ch, o, d, default_camera_for(mesh), mesh)


@functools.lru_cache(maxsize=None)
def _w8t_accel():
    """The WideBVHT of the port's own leaf-8 Morton tree of the teapot and
    its transposed attribute rows."""
    from tpurt_torch.bvh.lbvh import build_lbvh
    from tpurt_torch.bvh.wide import build_wide, build_wide_t
    from tpurt_torch.passes.shading import make_leaf_attr_rows_t
    m = teapot_scene(1500)
    dm = m.on("cpu")
    bvh = build_lbvh(dm.vertices, dm.indices, leaf_size=8)
    return build_wide_t(build_wide(bvh), bvh), make_leaf_attr_rows_t(bvh, m)


def kernel_inputs(name, acc, at, o, d):
    """(args, kwargs) of each *_cuda / *_reference pair on the teapot (the
    w8t walks on ``_w8t_accel``)."""
    if name.startswith("w8t_closest"):
        acc_t, at_t = _w8t_accel()
        if name.startswith("w8t_closest_attrs"):
            return tr.closest_attrs_inputs(acc_t, o, d, at_t)[:2]
        return tr.closest_inputs(acc_t, o, d)[:2]
    if name == "w8t_any":
        # The row accel's shadow rays, walked over the WideBVHT.
        (rays, _, _), kw = kernel_inputs("any", acc, at, o, d)
        acc_t = _w8t_accel()[0]
        return ((rays, acc_t.nodes, acc_t.tris_t),
                dict(kw, max_iters=tr.iter_cap(acc_t.num_wide)))
    if name.endswith("_tex"):
        # The attrs=2 variant: the attrs=1 inputs (the tables hold the
        # texture lanes; the variant decides whether the walk reads them).
        name = name[:-len("_tex")]
    fused = {
        "closest_shadow": dict(light_dir=(0.45, 0.8, 0.3)),
        "closest_multi_shadow": dict(lights=[((0.45, 0.8, 0.3), None),
                                             ((-0.5, 0.7, 0.2), None)]),
        "closest_soft_shadow": dict(axis_dir=(0.45, 0.8, 0.3),
                                    cone_cos=0.99, spp=2, seed=3),
        "closest_point_soft_shadow": dict(light_pos=(0.0, 5.0, 0.0),
                                          radius=0.2, spp=2, seed=3),
        "closest_soft_multi_shadow": dict(
            light0=("cone", (0.45, 0.8, 0.3), 0.99),
            extra_dirs=[(-0.5, 0.7, 0.2)], spp=2, seed=3),
    }
    if name in fused:
        return getattr(tr, f"{name}_inputs")(
            acc, o, d, bias=1e-3, attr_tables=at, **fused[name])[:2]
    if name.endswith("_st") and name[:-3] in fused:
        # The attrs=0 variant: the same inputs without attribute tables.
        return getattr(tr, f"{name[:-3]}_inputs")(
            acc, o, d, bias=1e-3, attr_tables=None, **fused[name[:-3]])[:2]
    if name == "closest_attrs":
        return tr.closest_attrs_inputs(acc, o, d, at)[:2]
    if name in ("closest", "first_hit"):
        return tr.closest_inputs(acc, o, d)[:2]
    if name == "any_stats":
        # The stats walk takes the any hit's shadow rays, per packet.
        (rays, _, _), kw = kernel_inputs("any", acc, at, o, d)
        return (rays, acc.nodes, acc.tris), kw
    if name == "topology_and_boxes":
        return (torch.zeros(4, dtype=torch.int32), torch.zeros((5, 3)),
                torch.zeros((5, 3))), {}
    if name == "rasterize_tiles":
        from tpurt_torch.raster.setup import bin_triangles
        m = teapot_scene(1500).on("cpu")
        return (bin_triangles(default_camera_for(m), m, 64, 32, 1 << 17),
                64, 32), {}
    if name in ("binary_closest", "binary_any"):
        # The binary walks take the packed Morton tree of the same mesh.
        from tpurt_torch.bvh.lbvh import build_lbvh
        from tpurt_torch.kernels.pack import pack_bvh
        m = teapot_scene(1500).on("cpu")
        packed = pack_bvh(build_lbvh(m.vertices, m.indices, leaf_size=8))
        return tr.binary_closest_inputs(packed, o, d)[:2]
    gb = _gbuf(acc, at, o, d)
    so = gb["position"] + gb["gnormal"] * 1e-3
    if name == "any":
        ld = torch.tensor([0.45, 0.8, 0.3]) / torch.tensor(
            [0.45, 0.8, 0.3]).norm()
        return tr.any_inputs(acc, so, ld.expand(so.shape).contiguous(),
                             torch.where(gb["valid"], 50.0, 0.0))[:2]
    if name == "any_soft":
        return tr.any_soft_inputs(acc, so, gb["valid"], (0.45, 0.8, 0.3),
                                  0.99, 2, 3, light=1)[:2]
    return tr.any_point_soft_inputs(acc, so, gb["valid"], (0.0, 5.0, 0.0),
                                    0.2, 2, 3, light=1)[:2]


@pytest.mark.parametrize("name", ["closest_shadow", "closest_multi_shadow",
                                  "closest_soft_shadow", "any", "any_soft",
                                  "closest_shadow_st",
                                  "closest_soft_multi_shadow_st", "w8t_any"])
def test_counting_leaves_the_result_alone(teapot, name):
    """The same outputs with and without stats; the early exits are taken
    (fewer any-hit tests than whole leaves, fewer slab tests than slots)."""
    acc, at, o, d = teapot
    args, kw = kernel_inputs(name, acc, at, o, d)
    plain = getattr(tr, f"{name}_reference")
    stats = {}
    counted = plain(*args, stats=stats, **kw)
    for a, b in zip(plain(*args, **kw), counted):
        assert torch.equal(a, b)
    n = {k: int(v) for k, v in stats.items()}
    assert 0 < n["slab_tests"] < 8 * n["pops"]
    assert 0 < n["anyhit_tris"] < n["anyhit_leaf_tris"]
    assert n.get("closest_tris", 0) % acc.leaf_size == 0


def test_closest_attrs_counts_only_the_closest_walk(teapot):
    acc, at, o, d = teapot
    args, kw = kernel_inputs("closest_attrs", acc, at, o, d)
    stats = {}
    tr.closest_attrs_reference(*args, stats=stats, **kw)
    assert stats["closest_tris"] > 0 and "anyhit_tris" not in stats


def test_closest_counts_only_the_closest_walk(teapot):
    """The plain closest hit counts the same walk as the attribute-tracked
    one: the same pops, slab tests and triangle tests."""
    acc, at, o, d = teapot
    plain, attrs = {}, {}
    args, kw = kernel_inputs("closest", acc, at, o, d)
    tr.closest_reference(*args, stats=plain, **kw)
    args, kw = kernel_inputs("closest_attrs", acc, at, o, d)
    tr.closest_attrs_reference(*args, stats=attrs, **kw)
    assert {k: int(v) for k, v in plain.items()} == \
        {k: int(v) for k, v in attrs.items()}
    assert plain["closest_tris"] > 0 and "anyhit_tris" not in plain


def _struct_fields(src: str, name: str):
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = re.sub(r"^\s*(const\s+)?\w+\s*\*?", "", decl.strip())
        names += [n.strip(" *") for n in decl.split(",") if n.strip()]
    return names


def _modes(src: str):
    body = re.search(r"enum Mode \{(.*?)\};", src, re.S).group(1)
    return {m.split("=")[0].strip(): int(m.split("=")[1])
            for m in body.split(",")}


def _csrc(name: str) -> str:
    with open(os.path.join(ROOT, "tpurt_torch", "kernels", "csrc",
                           name)) as f:
        return f.read()


def test_params_mirror_the_cuda_struct():
    """traverse.Params has the fields of csrc/walk.cuh's Params, in order
    (the loader also compares the sizes on the card), and the mode numbers
    are those of csrc/fused_shadows.cu and csrc/shadow_rays.cu."""
    assert [f[0] for f in tr.Params._fields_] == _struct_fields(
        _csrc("walk.cuh"), "Params")
    assert _modes(_csrc("fused_shadows.cu")) == {
        "HARD": tr.HARD, "MULTI": tr.MULTI, "SOFT": tr.SOFT,
        "PSOFT": tr.PSOFT, "SOFT_MULTI": tr.SOFT_MULTI,
        "CLOSEST": tr.CLOSEST, "NEAREST": tr.NEAREST,
        "FIRST_HIT": tr.FIRST_HIT}
    assert _modes(_csrc("shadow_rays.cu")) == {
        "ANY": tr.ANY, "ANY_SOFT": tr.ANY_SOFT, "ANY_PSOFT": tr.ANY_PSOFT}


@pytest.mark.parametrize("name", list(tr.WALK_KERNELS))
def test_walk_table_row(name):
    """A row of the walk-launch table: its launcher and plain version under
    their public names, the mode its launcher's doc names numbered as in
    its source's ``enum Mode``, and the fused pair lookup picking the row
    by mode and attrs variant, its name suffixed as the variant's."""
    w = tr.WALK_KERNELS[name]
    assert getattr(tr, f"{name}_cuda") is w.launch
    assert w.launch.__name__ == f"{name}_cuda" and w.launch in tr.CUDA_KERNELS
    assert getattr(tr, f"{name}_reference") is w.reference
    mode = re.match(r"Mode (\w+)", w.launch.__doc__).group(1)
    assert _modes(_csrc(w.source))[mode] == w.mode
    if w.entry != tr._FUSED or w.mode in (tr.NEAREST, tr.FIRST_HIT):
        return
    assert re.sub(r"_(st|tex)$", "", name) + ("_st", "", "_tex")[w.attrs] \
        == name
    tables = None if w.attrs == 0 else ("at0", "at1")
    for dev, fn in (("cuda", w.launch), ("cpu", w.reference)):
        assert tr._fused_pair(w.mode, tables, w.attrs == 2,
                              torch.device(dev)) is fn


def test_only_one_source_defines_the_queries():
    """Both sources link into one library: the extern "C" queries live in
    fused_shadows.cu alone, and every device function of walk.cuh is
    inlined, so no symbol is defined twice."""
    fused, rays = _csrc("fused_shadows.cu"), _csrc("shadow_rays.cu")
    for q in ("tpurt_stack_capacity", "tpurt_params_size"):
        assert q in fused and q not in rays
    walk = _csrc("walk.cuh")
    assert walk.count("__device__ __forceinline__") == walk.count(
        "__device__")


@pytest.mark.parametrize("fn", tr.CUDA_KERNELS + VARIANT_KERNELS + (
    topology_and_boxes_cuda, rasterize_tiles_cuda), ids=lambda f: f.__name__)
def test_cuda_launchers_refuse_cpu_tensors(teapot, fn):
    """No fallback: a *_cuda launcher given CPU tensors raises and counts
    no launch."""
    acc, at, o, d = teapot
    args, kw = kernel_inputs(fn.__name__[:-len("_cuda")], acc, at, o, d)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*args, **kw)
    assert fn.launches == before
