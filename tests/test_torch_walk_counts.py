"""The work counts of the port's plain walks, from which chip_smoke.py
computes each kernel's operation bound, and the CUDA launch boundary
that this box can check without a card.

The counts must be those of the work the kernels do: a node pop slab-tests
only its non-empty child boxes, the closest walk tests every triangle of a
leaf it visits, and an any-hit walk stops at the first occluding triangle
(csrc/walk.cuh ``child_hits``, ``leaf_closest``, ``leaf_occluded``).
"""

import os
import re

import pytest
import torch

import tpurt_torch.kernels.traverse as tr
from tpurt_torch.app import Renderer
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


@pytest.mark.parametrize("name,spec", [
    ("closest_shadow", dict(light_dir=(0.45, 0.8, 0.3))),
    ("closest_multi_shadow", dict(lights=[((0.45, 0.8, 0.3), None),
                                          ((-0.5, 0.7, 0.2), None)])),
    ("closest_soft_shadow", dict(axis_dir=(0.45, 0.8, 0.3), cone_cos=0.99,
                                 spp=2, seed=3)),
])
def test_counting_leaves_the_result_alone(teapot, name, spec):
    """The same outputs with and without stats; the early exits are taken
    (fewer any-hit tests than whole leaves, fewer slab tests than slots)."""
    acc, at, o, d = teapot
    args, kw, _, _ = getattr(tr, f"{name}_inputs")(
        acc, o, d, bias=1e-3, attr_tables=at, **spec)
    plain = getattr(tr, f"{name}_reference")
    stats = {}
    counted = plain(*args, stats=stats, **kw)
    for a, b in zip(plain(*args, **kw), counted):
        assert torch.equal(a, b)
    n = {k: int(v) for k, v in stats.items()}
    assert 0 < n["slab_tests"] < 8 * n["pops"]
    assert 0 < n["anyhit_tris"] < n["anyhit_leaf_tris"]
    assert n["closest_tris"] % acc.leaf_size == 0


def test_params_mirror_the_cuda_struct():
    """traverse.Params has the fields of csrc/fused_shadows.cu's Params,
    in order (the loader also compares the sizes on the card)."""
    with open(os.path.join(ROOT, "tpurt_torch", "kernels", "csrc",
                           "fused_shadows.cu")) as f:
        src = f.read()
    body = re.search(r"struct Params \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = re.sub(r"^\s*(const\s+)?\w+\s*\*?", "", decl.strip())
        names += [n.strip(" *") for n in decl.split(",") if n.strip()]
    assert [f[0] for f in tr.Params._fields_] == names
    modes = re.search(r"enum Mode \{(.*?)\};", src, re.S).group(1)
    assert [m.split("=")[0].strip() for m in modes.split(",")] == [
        "HARD", "MULTI", "SOFT", "PSOFT", "SOFT_MULTI"]
    assert [tr.HARD, tr.MULTI, tr.SOFT, tr.PSOFT, tr.SOFT_MULTI] == [
        int(m.split("=")[1]) for m in modes.split(",")]


@pytest.mark.parametrize("fn", tr.CUDA_KERNELS, ids=lambda f: f.__name__)
def test_cuda_launchers_refuse_cpu_tensors(teapot, fn):
    """No fallback: a *_cuda launcher given CPU tensors raises and counts
    no launch."""
    acc, at, o, d = teapot
    name = fn.__name__[:-len("_cuda")]
    spec = {
        "closest_shadow": dict(light_dir=(0.45, 0.8, 0.3)),
        "closest_multi_shadow": dict(lights=[((0.45, 0.8, 0.3), None)]),
        "closest_soft_shadow": dict(axis_dir=(0.45, 0.8, 0.3),
                                    cone_cos=0.99, spp=2, seed=3),
        "closest_point_soft_shadow": dict(light_pos=(0.0, 5.0, 0.0),
                                          radius=0.2, spp=2, seed=3),
        "closest_soft_multi_shadow": dict(
            light0=("cone", (0.45, 0.8, 0.3), 0.99),
            extra_dirs=[(-0.5, 0.7, 0.2)], spp=2, seed=3),
    }[name]
    args, kw, _, _ = getattr(tr, f"{name}_inputs")(
        acc, o, d, bias=1e-3, attr_tables=at, **spec)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*args, **kw)
    assert fn.launches == before
