"""The seeded G-buffer (``seeded_gbuffer=True``): the first-hit walk
(``first_hit_reference``, which ``trace_closest(seeded=True)`` takes for
CPU tensors) and the seeded closest hit, against the port's unseeded
closest hit and the JAX package's ``trace_closest_pallas(seeded=True)`` in
interpret mode (``_first_hit_kernel_w8_b``, then
``_closest_hit_kernel_w8_b``), and the Renderer's seeded frames against
``tpurt``'s.

Tolerances and why: the seed caps each ray's t_max, so the seeded walk
visits the unseeded walk's boxes in the same order but for those the cap
culls. t and tri_id are therefore equal on every ray; the sorted index
may name another SBVH reference of the same triangle (a clipped leaf box
can lie beyond the hit it holds, and the cap culls it). Against
``tpurt``, decision 2: t to 1e-6, tri_id on >= 99.9% of valid pixels
(tpurt's seed stops a 1024-ray packet, the port's a ray). Frames as
tests/test_torch_app.py holds them (at most 2e-3 of pixels off by more
than 1e-3).
"""

import numpy as np
import pytest
import torch

import tpurt.scenes as jscenes
from tpurt.kernels.traverse import trace_closest_pallas
from tpurt.types import Light as JLight
from tpurt.types import RenderConfig as JRenderConfig
import tpurt_torch.kernels.traverse as tr
import tpurt_torch.scenes as tscenes
from tpurt_torch.app import Renderer
from tpurt_torch.types import Light, RenderConfig

from test_torch_app import _assert_close_frames, _jax_frame
from test_torch_closest import check_closest
from test_torch_multi_shadow import jax_checks_off, parity_scene
from test_torch_native import ensure_native_libraries

torch.set_num_threads(1)
ensure_native_libraries()

DIRECTION = (0.45, 0.8, 0.3)


@pytest.fixture(scope="module")
def scene():
    return parity_scene(8)


def _walks(s, t_max=tr._BIG):
    """The plain first-hit and closest walks on the scene's rays, and the
    seeded and unseeded ``trace_closest``."""
    args, kw, p, meta = tr.closest_inputs(s.twide, s.to, s.td, t_max)
    first, closest = {}, {}
    seed = tr.first_hit_reference(*args, stats=first, **kw)
    near = tr.closest_reference(*args, stats=closest, **kw)
    return dict(seed=seed, near=near, first=first, closest=closest,
                seeded=tr.trace_closest(s.twide, s.to, s.td, t_max,
                                        return_sorted=True, seeded=True),
                plain=tr.trace_closest(s.twide, s.to, s.td, t_max,
                                       return_sorted=True))


def _same_hits(a, b, tri_id):
    t, tid, sidx, counts = a
    t2, tid2, sidx2, counts2 = b
    assert counts.tolist() == [0, 0] and counts2.tolist() == [0, 0]
    assert torch.equal(t, t2) and torch.equal(tid, tid2)
    other = sidx != sidx2
    assert torch.equal(tri_id[sidx[other].long()],
                       tri_id[sidx2[other].long()])


@pytest.mark.parametrize("per_ray", [False, True], ids=["big", "per_ray"])
def test_seeded_equals_unseeded(scene, per_ray):
    """per_ray: each ray's t_max half its closest t on a checkerboard of
    pixels (those rays miss) and 1.001 times it on the others (1e3 where
    nothing was hit)."""
    t_max = tr._BIG
    if per_ray:
        t0 = tr.trace_closest(scene.twide, scene.to, scene.td)[0]
        yy, xx = torch.meshgrid(torch.arange(t0.shape[0]),
                                torch.arange(t0.shape[1]), indexing="ij")
        scale = torch.where((yy + xx) % 2 == 0, 0.5, 1.001)
        t_max = torch.where(torch.isfinite(t0), t0 * scale, 1e3)
    w = _walks(scene, t_max)
    _same_hits(w["seeded"], w["plain"], scene.twide.tri_id)
    hit = w["seeded"][2] >= 0
    assert hit.any() and not hit.all()


def test_the_seed_bounds_the_closest_hit(scene):
    """FIRST_HIT misses exactly where the closest walk misses, its t is
    never below the closest t, it stops early on some rays (fewer node
    pops), and a stopped walk is not counted as capped."""
    w = _walks(scene)
    t1, s1, c1 = w["seed"]
    t, s, c = w["near"]
    assert c1.tolist() == [0, 0] and c.tolist() == [0, 0]
    hit = s >= 0
    assert torch.equal(s1 >= 0, hit) and hit.any()
    assert (t1[hit] >= t[hit]).all() and (t1[hit] > t[hit]).any()
    assert (t1[~hit] == tr._BIG).all() and (s1[~hit] == -1).all()
    assert w["first"]["pops"] < w["closest"]["pops"]
    cap = tr.seed_cap(tr.closest_inputs(scene.twide, scene.to,
                                        scene.td)[0][0], t1, s1)
    assert (cap[hit] > t1[hit]).all()
    assert (cap[~hit] == np.float32(tr._BIG)).all()


def test_first_hit_stops_every_period(scene):
    """An iteration cap of one period: both walks stop after it with the
    same hits, but the first-hit walk counts a capped walk only where the
    ray has no hit yet."""
    args, kw, _, _ = tr.closest_inputs(scene.twide, scene.to, scene.td)
    kw = dict(kw, max_iters=tr.FIRST_HIT_PERIOD)
    t1, s1, c1 = tr.first_hit_reference(*args, **kw)
    t, s, c = tr.closest_reference(*args, **kw)
    assert torch.equal(s1, s) and torch.equal(t1, t)
    assert c1[1] < c[1]


def test_seeded_matches_pallas(scene):
    with jax_checks_off():
        jres = trace_closest_pallas(scene.acc, scene.o, scene.d,
                                    return_sorted=True, seeded=True,
                                    interpret=True)
    tres = tr.trace_closest(scene.twide, scene.to, scene.td,
                            return_sorted=True, seeded=True)
    check_closest([np.asarray(x) for x in jres],
                  [x.numpy() for x in tres])


def test_seeded_refuses_a_binary_accel(scene):
    """A binary accel ignores ``seeded``, as ``tpurt``'s
    ``trace_closest_pallas`` does (only its WideBVH "lanes" branch reads
    it): the seeded call equals the unseeded one and no longer raises."""
    from tpurt_torch.bvh.lbvh import build_lbvh
    mesh = tscenes.teapot_scene(200)
    bvh = build_lbvh(torch.from_numpy(mesh.vertices),
                     torch.from_numpy(mesh.indices), leaf_size=4)
    seeded = tr.trace_closest(bvh, scene.to, scene.td, seeded=True,
                              return_sorted=True)
    plain = tr.trace_closest(bvh, scene.to, scene.td, return_sorted=True)
    for a, b in zip(seeded, plain):
        assert torch.equal(a, b)
    assert bool((seeded[2] >= 0).any())


def test_seeded_frame_matches_jax_renderer():
    fields = dict(width=48, height=32, leaf_size=8, seeded_gbuffer=True,
                  fused_shadow=False)
    jmesh = jscenes.teapot_scene(1500)
    jimg = _jax_frame(jmesh, jscenes.default_camera_for(jmesh),
                      JLight.directional(DIRECTION), JRenderConfig(**fields))
    tmesh = tscenes.teapot_scene(1500)
    r = Renderer(tmesh, tscenes.default_camera_for(tmesh),
                 Light.directional(DIRECTION), RenderConfig(**fields),
                 device="cpu")
    assert r.route == "unfused"
    assert r.attr_tables is None and r.shade_table is not None
    out = r.render_frame()
    assert out["walk_counts"].tolist() == [0, 0]
    _assert_close_frames(jimg, out["image"].numpy())


@pytest.mark.parametrize("fused", [True, False], ids=["fused0", "unfused"])
def test_seeded_route_and_frame(monkeypatch, fused):
    """The flag drops the attribute rows, as tpurt's _use_attrs does. With
    the fused default the frame takes the attrs=0 fused kernel and never
    the seed; unfused it seeds the closest hit once per frame. Either way
    the frame equals the unseeded shade-table frame."""
    calls = []
    real = tr.first_hit_reference
    monkeypatch.setattr(tr, "first_hit_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    mesh = tscenes.teapot_scene(1500)

    def render(**extra):
        r = Renderer(mesh, tscenes.default_camera_for(mesh),
                     Light.directional(DIRECTION),
                     RenderConfig(width=48, height=32, leaf_size=8,
                                  fused_shadow=fused, **extra),
                     device="cpu")
        return r, r.render_frame()
    r, seeded = render(seeded_gbuffer=True)
    assert r.route == ("fused0" if fused else "unfused")
    assert r.attr_tables is None and r.shade_table is not None
    assert len(calls) == (0 if fused else 1)
    _, plain = render(inkernel_attrs=False)
    assert torch.equal(seeded["image"], plain["image"])
    assert torch.equal(seeded["tri_id"], plain["tri_id"])
