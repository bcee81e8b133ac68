"""Frames over the binary tree (``bvh_width=2``, and a plain LBVH handed to
``render_frame_fn``, the route of ``tpurt``'s ``__graft_entry__.entry()``):
the port (CPU, plain versions of the kernels) against the JAX package
(CPU, Pallas interpret mode).

- ``render_frame_fn`` on the binary accel with the shade table, and with
  no tables at all (entry()'s config at 64x48), against ``tpurt``'s on the
  tree ``build_lbvh(builder="kernel")`` builds, which the port's own
  ``build_lbvh`` equals (ROADMAP decision 7). t and depth agree to 1e-6
  relative, tri_id on >= 99.9% of valid pixels and shadows on all but
  1e-3 of them (decision 2); the image as tests/test_torch_app.py holds
  frames. The decode is held to decision 11's bounds (normals 1e-6,
  albedo 2e-7) against ``tpurt``'s decode under ``jit`` of the port's own
  hit positions and triangles, the inputs decision 11 measured it on.
  Across the two frames the hit positions themselves differ by up to
  6.7e-6 (the interpret-mode kernel's FMA-contracted t, and XLA's
  contracted o + d t), which moves the smooth normal interpolated at them
  by up to 9.2e-6: frame to frame, positions are held to 1e-5 and the
  smooth normal to 2e-5; the geometric normal and the albedo, which the
  position does not move, keep 1e-6 and 2e-7.
- A 4 deg sun at spp 4 through the pass's loop over samples, held
  statistically (decision 6): its share of pixels more than 2 levels off
  tpurt's seed-0 frame at most twice that of tpurt's seed-1 frame.
- ``Renderer(bvh_width=2)`` static (ray and raster G-buffer) and
  ``mode="rebuild"`` with ``rebuild_splits=0``; ``check_slice``'s
  refusals; and the four routing repairs a binary config needs (the SBVH
  gate, the table, the route, ``seeded_gbuffer``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.app as japp
import tpurt.bvh.lbvh as jlbvh
import tpurt.passes.gbuffer as jgbuffer
import tpurt.passes.shading as jshading
import tpurt.scenes as jscenes
import tpurt.types as jtypes
import tpurt_torch.app as tapp
import tpurt_torch.bvh.lbvh as tlbvh
import tpurt_torch.convert as convert
import tpurt_torch.kernels.traverse as tr
import tpurt_torch.scenes as tscenes
from tpurt_torch.camera import generate_rays
from tpurt_torch.io.image import to_uint8
from tpurt_torch.kernels.pack import PackedBVH, pack_bvh, tree_depth
from tpurt_torch.passes.shading import make_shade_table
from tpurt_torch.types import Light, RenderConfig

from test_torch_app import _assert_close_frames
from test_torch_multi_shadow import jax_checks_off
from test_torch_native import ensure_native_libraries

torch.set_num_threads(1)
ensure_native_libraries()

DIRECTION = (0.45, 0.8, 0.3)
LAMP = (1.0, 6.0, 2.0)
W, H, LEAF = 64, 48, 8


@functools.lru_cache(maxsize=None)
def trees():
    """The teapot in both packages: tpurt's kernel-builder tree and shade
    table, the port's own build of the same tree, packed, and its
    table."""
    jmesh = jscenes.teapot_scene(1500)
    with jax_checks_off():
        jb = jlbvh.build_lbvh(jnp.asarray(jmesh.vertices),
                              jnp.asarray(jmesh.indices), leaf_size=LEAF,
                              builder="kernel")
        jst = jshading.make_shade_table(jb, jmesh)
    tmesh = convert.mesh(convert.numpy_fields(jmesh)).on("cpu")
    tb = tlbvh.build_lbvh(tmesh.vertices, tmesh.indices, leaf_size=LEAF)
    for name in ("nodes_box", "nodes_child", "tri_id"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    return dict(jmesh=jmesh, jb=jb, jst=jst, tmesh=tmesh, tb=tb,
                packed=pack_bvh(tb), tst=make_shade_table(tb, tmesh),
                jcam=jscenes.default_camera_for(jmesh),
                tcam=tscenes.default_camera_for(tmesh))


def _jax_frame(lights, cfg, shade_table, seed=0):
    s = trees()
    with jax_checks_off():
        out = japp.render_frame_fn(s["jb"], s["jmesh"], s["jcam"],
                                   tuple(lights), jax.random.PRNGKey(seed),
                                   cfg, shade_table=shade_table)
        return {k: np.asarray(v) for k, v in out.items()}


def _flipped(decode, dirs):
    """tpurt's decode turned toward the viewer, as both G-buffers do."""
    gn = np.asarray(decode["gnormal"])
    facing = np.sign(-(gn * dirs).sum(-1, keepdims=True))
    flip = np.where(facing == 0, 1.0, facing)
    return {k: np.asarray(decode[k]) * (flip if k != "albedo" else 1.0)
            for k in ("normal", "gnormal", "albedo")}


def check_frames(j, t, decode):
    """Hold the port's frame dict against tpurt's frame ``j`` and against
    ``decode``, tpurt's decode of the port's hits."""
    tn = {k: v.numpy() for k, v in t.items() if isinstance(v, torch.Tensor)}
    valid = j["valid"]
    np.testing.assert_array_equal(tn["valid"], valid)
    assert valid.any() and not valid.all()
    np.testing.assert_array_equal(tn["walk_counts"], [0, 0])
    same = (tn["tri_id"] == j["tri_id"]) & valid
    assert same.sum() >= 0.999 * valid.sum()
    np.testing.assert_allclose(tn["t"][valid], j["t"][valid], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tn["depth"][valid], j["depth"][valid],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tn["position"][valid], j["position"][valid],
                               atol=1e-5, rtol=0)
    for k, atol in (("normal", 2e-5), ("gnormal", 1e-6), ("albedo", 2e-7)):
        np.testing.assert_allclose(tn[k][same], j[k][same], atol=atol,
                                   rtol=0, err_msg=k)
    dec = _flipped(decode, tn["view_dir"])
    for k, atol in (("normal", 1e-6), ("gnormal", 1e-6), ("albedo", 2e-7)):
        np.testing.assert_allclose(tn[k][valid], dec[k][valid], atol=atol,
                                   rtol=0, err_msg=f"decode {k}")
    assert tn["shadow"].shape == j["shadow"].shape
    for ts, js in zip(tn["shadow"], j["shadow"]):
        assert ((ts != js) & valid).sum() <= 1e-3 * valid.sum()
        assert (ts[~valid] == 1.0).all()
    _assert_close_frames(j["image"], tn["image"])


def test_render_frame_fn_binary_with_the_shade_table():
    """Two lights on the packed accel with the shade table: the binary
    closest hit, the table's row gather, one binary any-hit pass per
    light."""
    s = trees()
    lights = [(Light.directional(DIRECTION), jtypes.Light.directional(
        DIRECTION)), (Light.point(LAMP), jtypes.Light.point(LAMP))]
    fields = dict(width=W, height=H, leaf_size=LEAF, bvh_width=2)
    j = _jax_frame([jl for _, jl in lights], jtypes.RenderConfig(**fields),
                   s["jst"])
    t = tapp.render_frame_fn(s["packed"], s["tmesh"], s["tcam"],
                             [tl for tl, _ in lights], RenderConfig(**fields),
                             shade_table=s["tst"])
    sidx = tr.trace_closest(s["packed"], *generate_rays(s["tcam"], W, H,
                                                        "cpu"),
                            return_sorted=True)[2].numpy()
    rows = s["jst"][np.clip(sidx, 0, s["jst"].shape[0] - 1)]
    decode = jax.jit(jshading.shade_from_table)(
        rows, t["position"].numpy(), t["valid"].numpy())
    check_frames(j, t, decode)


def test_render_frame_fn_entry_route_without_tables():
    """__graft_entry__.entry()'s route at 64x48: a plain LBVH, the default
    RenderConfig (bvh_width 8, leaf 8) and no tables; the G-buffer gathers
    the mesh by tri_id (shade_attributes)."""
    s = trees()
    fields = dict(width=W, height=H, leaf_size=LEAF)
    j = _jax_frame([jtypes.Light.directional(DIRECTION)],
                   jtypes.RenderConfig(**fields), None)
    numpy_mesh = convert.mesh(convert.numpy_fields(s["jmesh"]))
    t = tapp.render_frame_fn(s["tb"], numpy_mesh, s["tcam"],
                             [Light.directional(DIRECTION)],
                             RenderConfig(**fields))
    decode = jax.jit(jgbuffer.shade_attributes)(
        s["jmesh"], t["tri_id"].numpy(), t["position"].numpy(),
        t["valid"].numpy())
    check_frames(j, t, decode)
    assert t["image"].shape == (H, W, 3)


def _off(img, ref) -> float:
    a = to_uint8(img).astype(np.int16)
    b = to_uint8(ref).astype(np.int16)
    return float((np.abs(a - b) > 2).mean())


def test_binary_sun_spp4_held_statistically():
    """tpurt's scan draws jax.random samples, the port its Philox ones:
    the port's seed-0 frame may be no further from tpurt's seed-0 frame
    than twice tpurt's own seed-1 frame is."""
    def jframe(seed):
        cfg = jtypes.RenderConfig(width=96, height=64, leaf_size=LEAF,
                                  bvh_width=2, spp=4, seed=seed)
        m = jscenes.teapot_scene(1500)
        with jax_checks_off():
            return np.asarray(japp.Renderer(
                m, jscenes.default_camera_for(m),
                jtypes.Light.sun(DIRECTION, angular_radius_deg=4.0),
                cfg).render_frame()["image"])
    ref, noise_img = jframe(0), jframe(1)
    mesh = tscenes.teapot_scene(1500)
    r = tapp.Renderer(mesh, tscenes.default_camera_for(mesh),
                      Light.sun(DIRECTION, angular_radius_deg=4.0),
                      RenderConfig(width=96, height=64, leaf_size=LEAF,
                                   bvh_width=2, spp=4, seed=0), device="cpu")
    assert r.route == "unfused"
    out = r.render_frame()
    vis = out["shadow"][0][out["valid"]]
    assert ((vis > 0) & (vis < 1)).any()           # a penumbra was sampled
    assert set(np.unique((vis * 4).numpy())) <= {0.0, 1.0, 2.0, 3.0, 4.0}
    noise = _off(noise_img, ref)
    ours = _off(out["image"].numpy(), ref)
    assert noise > 0.0
    assert ours <= 2.0 * noise, f"port {ours:.4%} vs seed noise {noise:.4%}"


@pytest.mark.parametrize("light", [
    Light.sun(DIRECTION, angular_radius_deg=4.0),
    Light.point(LAMP, radius=0.4)], ids=["sun", "lamp"])
def test_scan_draws_one_any_hit_launch_per_sample(monkeypatch, light):
    """On the binary accel a soft light (cone or disk) takes spp any-hit
    calls; the same seed repeats the frame, another frame index draws
    other samples."""
    s = trees()
    calls = []
    real = tr.binary_any_reference

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(tr, "binary_any_reference", counted)
    cfg = RenderConfig(width=W, height=H, leaf_size=LEAF, bvh_width=2,
                       spp=3)

    def frame(index):
        return tapp.render_frame_fn(s["packed"], s["tmesh"], s["tcam"],
                                    [light], cfg,
                                    seed=tapp.frame_seed(0, index),
                                    shade_table=s["tst"])
    a = frame(0)
    assert len(calls) == 3
    b, c = frame(0), frame(1)
    assert torch.equal(a["shadow"], b["shadow"])
    assert not torch.equal(a["shadow"], c["shadow"])
    vis = a["shadow"][0][a["valid"]]
    assert ((vis > 0) & (vis < 1)).any()


def _renderer(mode="static", lights=None, **fields):
    mesh = tscenes.teapot_scene(1500)
    cfg = RenderConfig(**dict(dict(width=W, height=H, leaf_size=LEAF,
                                   bvh_width=2), **fields))
    return tapp.Renderer(mesh, tscenes.default_camera_for(mesh),
                         lights or Light.directional(DIRECTION), cfg,
                         mode=mode, device="cpu")


@pytest.fixture(scope="module")
def static_binary():
    r = _renderer()
    return r, r.render_frame()


def test_binary_renderer_static_matches_tpurt(static_binary):
    r, out = static_binary
    assert isinstance(r.accel, PackedBVH) and r.route == "unfused"
    assert r.attr_tables is None and r.shade_table is not None
    assert {"lbvh_build_ms", "pack_ms", "shade_table_ms"} <= set(r.stats)
    assert r.depth == tree_depth(r.bvh.nodes_child) > 0
    m = jscenes.teapot_scene(1500)
    with jax_checks_off():
        jimg = np.asarray(japp.Renderer(
            m, jscenes.default_camera_for(m),
            jtypes.Light.directional(DIRECTION),
            jtypes.RenderConfig(width=W, height=H, leaf_size=LEAF,
                                bvh_width=2)).render_frame()["image"])
    _assert_close_frames(jimg, out["image"].numpy())


def test_binary_renderer_raster_gbuffer(static_binary):
    """gbuffer="raster" (what "auto" resolves to on the card): the tile
    rasterizer, no table, the binary any hit; coverage and image against
    the ray-cast frame with tests/test_raster.py's bounds."""
    r, ray = static_binary
    rr = _renderer(gbuffer="raster")
    assert rr.shade_table is None and rr.attr_tables is None
    out = rr.render_frame()
    assert (out["valid"] != ray["valid"]).float().mean() < 0.002
    diff = (out["image"] - ray["image"]).abs().amax(-1)
    assert (diff > 2e-2).float().mean() < 0.01


def test_binary_rebuild_renders_the_static_tree(static_binary):
    """mode="rebuild" with rebuild_splits=0 rebuilds the same Morton tree
    every frame: the frame equals the static one; an animated frame moves
    the shading."""
    _, static = static_binary
    r = _renderer(mode="rebuild", rebuild_splits=0)
    assert r.route == "unfused" and r.shade_table is not None
    out = r.render_frame()
    assert torch.equal(out["image"], static["image"])
    assert r.stats["build_ms"] > 0
    r.set_vertices(tscenes.deform(tscenes.teapot_scene(1500), 0.5))
    moved = r.render_frame()
    assert torch.isfinite(moved["image"]).all()
    assert not torch.equal(moved["image"], static["image"])


def test_binary_rebuild_checks_its_stack_without_a_sync(monkeypatch):
    """Every rebuild checks the binary stack against the Karras depth
    bound, a constant: the check reads nothing back from the device."""
    seen = []
    monkeypatch.setattr(tapp, "check_binary_stack_bound",
                        lambda depth: seen.append(depth))
    r = _renderer(mode="rebuild", rebuild_splits=0)
    r.render_frame()
    r.render_frame()
    assert seen[-2:] == [tapp.KARRAS_DEPTH_BOUND] * 2


def _big_mesh(ntris):
    """A mesh whose triangle count alone matters (check_slice's budget)."""
    m = tscenes.teapot_scene(200)
    return dataclasses.replace(m, indices=np.zeros((ntris, 3), np.int32))


@pytest.mark.parametrize("mode,fields,mesh_tris,what", [
    ("rebuild", dict(), 0, "clustered binary rebuild"),
    ("rebuild", dict(rebuild_splits=5), 0, "clustered binary rebuild"),
    ("static", dict(leaf_size=4), 150_000, "portable traversal"),
    ("static", dict(use_pallas=False), 0, "use_pallas=False"),
    ("static", dict(bvh_width=4), 0, "bvh_width=4"),
])
def test_check_slice_binary_refusals(mode, fields, mesh_tris, what):
    mesh = _big_mesh(mesh_tris) if mesh_tris else tscenes.teapot_scene(200)
    cfg = RenderConfig(**dict(dict(bvh_width=2, gbuffer="ray"), **fields))
    with pytest.raises(NotImplementedError, match=what):
        tapp.check_slice(cfg, mode, [Light.directional(DIRECTION)], mesh,
                         None)


def test_check_slice_budget_edge_is_tpurts():
    """The budget refusal is tpurt's _check_vmem_budget: the Sponza-class
    hall passes at leaf 14 and falls back at leaf 4."""
    lights = [Light.directional(DIRECTION)]
    hall = _big_mesh(287_176)
    tapp.check_slice(RenderConfig(bvh_width=2, leaf_size=14, gbuffer="ray"),
                     "static", lights, hall, None)
    with pytest.raises(NotImplementedError, match="portable traversal"):
        tapp.check_slice(RenderConfig(bvh_width=2, leaf_size=4,
                                      gbuffer="ray"), "static", lights,
                         hall, None)
    jcfg = japp.Renderer._check_vmem_budget(
        jtypes.RenderConfig(bvh_width=2, leaf_size=4), hall)
    assert not jcfg.use_pallas


def test_repair_binary_configs_skip_the_sbvh():
    """tpurt builds the SBVH only for 8-wide Pallas configs: a binary
    config builds the Morton tree on the device, and "auto" then resolves
    to the rasterizer on the card."""
    r = _renderer()
    assert r._use_sah is False and "sah_build_ms" not in r.stats
    cfg = dataclasses.replace(r.config, gbuffer="auto", sah=r._use_sah)
    assert tapp.use_raster_gbuffer(cfg, "static", "cuda", 0)
    assert not tapp.use_raster_gbuffer(cfg, "static", "cpu", 0)


def test_repair_binary_frames_read_the_shade_table():
    """Attribute rows exist for the 8-wide accel alone: with the default
    inkernel_attrs=True a binary frame still reads the shade table."""
    r = _renderer(inkernel_attrs=True)
    assert r._tables == "st" and r.attr_tables is None
    assert r.shade_table is not None


def test_repair_a_binary_accel_routes_unfused():
    """Every fused kernel needs the 8-wide accel: with a light set that
    would take fused0, fusedN or fusedSM, a binary accel (or bvh_width=2)
    routes "unfused", and render_frame_fn takes that route."""
    s = trees()
    cfg = RenderConfig(width=W, height=H, leaf_size=LEAF, spp=2)
    sets = [[Light.directional(DIRECTION)],
            [Light.directional(DIRECTION), Light.directional((-0.5, 0.7,
                                                              0.2))],
            [Light.sun(DIRECTION, angular_radius_deg=4.0),
             Light.directional((-0.5, 0.7, 0.2))]]
    assert [tapp.frame_route(cfg, ls) for ls in sets] == \
        ["fused0", "fusedN", "fusedSM"]
    for ls in sets:
        assert tapp.frame_route(cfg, ls, s["packed"]) == "unfused"
        assert tapp.frame_route(cfg, ls, s["tb"]) == "unfused"
        assert tapp.frame_route(dataclasses.replace(cfg, bvh_width=2),
                                ls) == "unfused"
    out = tapp.render_frame_fn(s["packed"], s["tmesh"], s["tcam"], sets[1],
                               cfg, shade_table=s["tst"])
    assert out["shadow"].shape[0] == 2
    assert out["walk_counts"].tolist() == [0, 0]


def test_repair_seeded_gbuffer_is_ignored_on_a_binary_accel(static_binary):
    """tpurt reads seeded_gbuffer on the 8-wide accel alone."""
    _, out = static_binary
    r = _renderer(seeded_gbuffer=True)
    assert torch.equal(r.render_frame()["image"], out["image"])
