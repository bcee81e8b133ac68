"""The port's binary walks (``binary_closest_reference`` and
``binary_any_reference``, which ``trace_closest`` and ``trace_any`` take
for CPU tensors on a packed binary tree) against the JAX package's
``_closest_hit_kernel`` and ``_any_hit_kernel`` in interpret mode
(``trace_closest_pallas`` / ``trace_any_pallas`` on tpurt's
``pack_bvh`` of a plain LBVH), on the same packed rows carried across
with ``convert.packed_bvh``.

Scenes: the teapot (1500 triangles, leaf 8) and a random soup (600
triangles, leaf 4). Rays: 64x32 camera rays (image-shaped), then flat
(N, 3) rays from random points in the scene box (N not a multiple of
1024); a t_min above 0; a per-ray t_max; inactive rays (t_max <= t_min).
Shadow rays toward a directional and a point light from the teapot's
hit points.

Tolerances (ROADMAP decision 2): t within 1e-6; tri_id equal on >= 99.9%
of valid rays; misses (inf, -1) in the same places; occlusion differing
on at most 1e-3 of active rays and never set on an inactive one. The
walk counters stay at zero.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.bvh.lbvh as jlbvh
import tpurt.kernels.pack as jpack
import tpurt.scenes as jscenes
import tpurt_torch.convert as convert
import tpurt_torch.kernels.traverse as tr
from tpurt.camera import generate_rays as jgenerate_rays
from tpurt.kernels.traverse import trace_any_pallas, trace_closest_pallas

from test_torch_closest import check_closest
from test_torch_multi_shadow import jax_checks_off

torch.set_num_threads(1)

_build = jax.jit(jlbvh.build_lbvh, static_argnames=("leaf_size",))
LIGHT_DIR = np.float32([0.45, 0.8, 0.3]) / np.linalg.norm([0.45, 0.8, 0.3])


@functools.lru_cache(maxsize=None)
def scene(name: str):
    """(tpurt's PackedBVH, the port's PackedBVH, tpurt's LBVH, mesh)."""
    if name == "teapot":
        mesh, leaf = jscenes.teapot_scene(1500), 8
    else:
        mesh, leaf = jscenes.random_soup(600, seed=5), 4
    jb = _build(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices),
                leaf_size=leaf)
    jp = jpack.pack_bvh(jb)
    fields = convert.numpy_fields(jp)
    fields.update(root_min=np.asarray(jb.root_min),
                  root_max=np.asarray(jb.root_max))
    return jp, convert.packed_bvh(fields, "cpu"), jb, mesh


def camera_rays(name):
    mesh = scene(name)[3]
    o, d = jgenerate_rays(jscenes.default_camera_for(mesh), 64, 32)
    return np.array(o), np.array(d)


def flat_rays(name, n=1500, seed=3):
    """Rays from random points of the scene box in random directions."""
    jb = scene(name)[2]
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(jb.root_min), np.asarray(jb.root_max)
    o = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def closest_pair(name, o, d, t_max=tr._BIG, t_min=0.0):
    jp, tp = scene(name)[:2]
    with jax_checks_off():
        jres = trace_closest_pallas(jp, jnp.asarray(o), jnp.asarray(d),
                                    t_max=jnp.asarray(t_max), t_min=t_min,
                                    return_sorted=True, interpret=True)
    tres = tr.trace_closest(tp, torch.from_numpy(o), torch.from_numpy(d),
                            t_max=torch.as_tensor(t_max), t_min=t_min,
                            return_sorted=True)
    return ([np.asarray(x) for x in jres],
            [x.numpy() for x in tres])


def any_pair(name, o, d, t_max, t_min=0.0):
    jp, tp = scene(name)[:2]
    with jax_checks_off():
        jocc = trace_any_pallas(jp, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(t_max), t_min=t_min,
                                interpret=True)
    tocc, counts = tr.trace_any(tp, torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(t_max), t_min=t_min)
    return np.asarray(jocc), tocc.numpy(), counts.numpy()


def check_any(jocc, tocc, counts, active):
    np.testing.assert_array_equal(counts, [0, 0])
    assert tocc.shape == jocc.shape == active.shape
    assert not tocc[~active].any() and not jocc[~active].any()
    assert tocc[active].any() and not tocc[active].all()
    assert (tocc != jocc).sum() <= 1e-3 * active.sum()


@pytest.fixture(scope="module")
def teapot_closest():
    return closest_pair("teapot", *camera_rays("teapot"))


def test_binary_closest_matches_pallas_image_rays(teapot_closest):
    check_closest(*teapot_closest)


def test_binary_closest_per_ray_t_max_and_inactive_rays(teapot_closest):
    """Half the closest t on one checkerboard colour (those rays must
    miss), 1.001 times it on the other, and t_max = 0 (inactive) on every
    fifth column: both packages agree ray for ray."""
    o, d = camera_rays("teapot")
    t0 = teapot_closest[0][0]
    yy, xx = np.indices(t0.shape)
    scale = np.where((yy + xx) % 2 == 0, 0.5, 1.001)
    t_max = np.where(np.isfinite(t0), t0 * scale, 1e3).astype(np.float32)
    t_max[:, ::5] = 0.0
    jres, tres = closest_pair("teapot", o, d, t_max)
    check_closest(jres, tres)
    assert (tres[2][:, ::5] == -1).all()
    capped = (teapot_closest[0][2] >= 0) & ((yy + xx) % 2 == 0)
    assert capped.any() and not (tres[2][capped] >= 0).any()


def test_binary_closest_t_min(teapot_closest):
    """A t_min at the median hit distance: rays whose hit lies nearer find
    the surface behind it or miss."""
    o, d = camera_rays("teapot")
    t0 = teapot_closest[0][0]
    t_min = float(np.median(t0[np.isfinite(t0)]))
    jres, tres = closest_pair("teapot", o, d, t_min=t_min)
    check_closest(jres, tres)
    hit = tres[2] >= 0
    assert (tres[0][hit] > t_min).all()


@pytest.mark.parametrize("name", ["teapot", "soup"])
def test_binary_closest_flat_rays(name):
    o, d = flat_rays(name)
    t_max = np.full(o.shape[0], 1e3, np.float32)
    t_max[::7] = -1.0                                  # inactive
    jres, tres = closest_pair(name, o, d, t_max)
    check_closest(jres, tres)
    assert tres[2].shape == (o.shape[0],)


@pytest.fixture(scope="module")
def teapot_shadow_rays(teapot_closest):
    """Shadow rays from the teapot's hits, pulled back along the view ray:
    a directional light (t_max 1e3) and a point light (t_max its distance),
    t_max = 0 off the hit set."""
    o, d = camera_rays("teapot")
    t, _, sidx = teapot_closest[0]
    valid = sidx >= 0
    pos = (o + d * np.where(valid, t, 0.0)[..., None]
           - 1e-3 * d).astype(np.float32)
    lpos = np.float32([2.0, 6.0, 1.0]) + 0.5 * (
        np.asarray(scene("teapot")[2].root_min)
        + np.asarray(scene("teapot")[2].root_max))
    delta = lpos - pos
    dist = np.linalg.norm(delta, axis=-1)
    return valid, {
        "directional": (pos, np.broadcast_to(LIGHT_DIR, pos.shape).copy(),
                        np.where(valid, 1e3, 0.0).astype(np.float32)),
        "point": (pos, (delta / dist[..., None]).astype(np.float32),
                  np.where(valid, dist * (1 - 1e-4), 0.0).astype(
                      np.float32))}


@pytest.mark.parametrize("kind", ["directional", "point"])
def test_binary_any_matches_pallas_shadow_rays(teapot_shadow_rays, kind):
    valid, rays = teapot_shadow_rays
    check_any(*any_pair("teapot", *rays[kind]), valid)


def test_binary_any_t_min_and_per_ray_t_max():
    """Flat rays with a t_min and t_max drawn per ray (some <= t_min, so
    inactive)."""
    o, d = flat_rays("teapot", seed=7)
    rng = np.random.default_rng(11)
    t_max = rng.uniform(-0.5, 4.0, o.shape[0]).astype(np.float32)
    t_min = 0.05
    active = t_max > t_min
    check_any(*any_pair("teapot", o, d, t_max, t_min), active)


def test_binary_any_flat_rays_soup():
    o, d = flat_rays("soup", seed=9)
    t_max = np.full(o.shape[0], 1e3, np.float32)
    t_max[::9] = 0.0
    check_any(*any_pair("soup", o, d, t_max), t_max > 0)


def test_binary_walks_route_on_an_lbvh_and_count_work():
    """trace_closest and trace_any pack an LBVH per call: the same answers
    as on the packed rows. The plain walks' counts (the kernels' bound)
    are consistent: two slab tests per pop, k triangles per closest leaf,
    the any-hit walk's triangles up to its first occluder."""
    jp, tp, jb, _ = scene("teapot")
    lb = convert.lbvh(convert.numpy_fields(jb), "cpu")
    o, d = (torch.from_numpy(x) for x in camera_rays("teapot"))
    a = tr.trace_closest(lb, o, d, return_sorted=True)
    b = tr.trace_closest(tp, o, d, return_sorted=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    args, kw, _, _ = tr.binary_closest_inputs(lb, o, d)
    assert kw["max_iters"] == 2 * tp.num_internal + 64
    stats = {}
    tr.binary_closest_reference(*args, stats=stats, **kw)
    assert stats["slab_tests"] == 2 * stats["pops"] > 0
    assert stats["closest_tris"] % tp.leaf_size == 0
    stats = {}
    args, kw, _, _ = tr.binary_any_inputs(tp, o, d, 1e3)
    tr.binary_any_reference(*args, stats=stats, **kw)
    assert 0 < stats["anyhit_tris"] <= stats["anyhit_leaf_tris"]


def test_binary_walk_counters_catch_a_small_stack_and_cap():
    """A stack of 2 entries drops pushes on the teapot tree; an iteration
    cap of 3 cuts walks: both show in the counters, as in the kernel."""
    tp = scene("teapot")[1]
    o, d = (torch.from_numpy(x) for x in camera_rays("teapot"))
    args, kw, _, _ = tr.binary_closest_inputs(tp, o, d)
    counts = tr.binary_closest_reference(*args, **dict(kw, stack_size=2))[2]
    assert counts[0] > 0
    counts = tr.binary_any_reference(*args, **dict(kw, max_iters=3))[1]
    assert counts[1] > 0
    with pytest.raises(RuntimeError, match="stack overflows"):
        tr.check_walk_counts(tr.binary_closest_reference(
            *args, **dict(kw, stack_size=2))[2])


def test_binary_cuda_wrappers_refuse_cpu_tensors():
    tp = scene("teapot")[1]
    o, d = (torch.from_numpy(x) for x in camera_rays("teapot"))
    args, kw, _, _ = tr.binary_closest_inputs(tp, o, d)
    for fn in (tr.binary_closest_cuda, tr.binary_any_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*args, **kw)
