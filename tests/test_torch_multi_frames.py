"""Whole frames of the port's multi-light and soft-shadow paths (CPU, plain
traversals) against the JAX package's Renderer and the checked-in goldens,
and the port's routing against ``tpurt``'s gates."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import tpurt.app as japp
import tpurt.bvh.wide as jwide
import tpurt.scenes as jscenes
import tpurt.types as jtypes
import tpurt_torch.scenes as tscenes
import tpurt_torch.types as ttypes
import tpurt_torch.app as tapp
from tpurt_torch.app import Renderer, frame_route
from tpurt_torch.io.image import read_png, to_uint8
from tpurt_torch.kernels.traverse import trace_closest_multi_shadow

from test_torch_app import GOLDEN, _assert_close_frames, _jax_frame

torch.set_num_threads(1)


def _golden(name):
    return read_png(os.path.join(GOLDEN, f"{name}.png")).astype(np.int16)


def _multilight(mod, mesh):
    """tests/gen_goldens.py's multilight set: directional + point."""
    return [mod.Light.directional((0.45, 0.8, 0.3), color=(1.0, 0.95, 0.85)),
            mod.Light.point(np.asarray(mesh.vertices).mean(0)
                            + np.float32([2.5, 3.0, -1.5]),
                            color=(0.4, 0.5, 1.0), intensity=0.8)]


def test_multilight_frame_matches_golden():
    """gen_goldens' multilight_128x96 config through the port's fused
    attribute path (leaf 8), with the tolerance of tests/test_golden.py."""
    mesh = tscenes.teapot_scene(1500)
    r = Renderer(mesh, tscenes.default_camera_for(mesh),
                 _multilight(ttypes, mesh),
                 ttypes.RenderConfig(width=128, height=96, leaf_size=8,
                                     seed=0), device="cpu")
    assert r.route == "fusedN"
    ours = to_uint8(r.render_frame()["image"].numpy()).astype(np.int16)
    golden = _golden("multilight_128x96")
    assert ours.shape == golden.shape
    frac_off = (np.abs(ours - golden) > 2).mean()
    assert frac_off < 0.005, f"{frac_off:.4%} pixels differ"


def test_multi_light_frame_matches_jax_renderer():
    """Three hard lights (two directional, one point) through both
    Renderers' fused multi-light kernels, 64x48, leaf 8."""
    def lights(mod):
        return [mod.Light.directional((0.45, 0.8, 0.3)),
                mod.Light.directional((-0.5, 0.7, 0.2),
                                      color=(0.4, 0.4, 0.5)),
                mod.Light.point((2.0, 6.0, 1.0), color=(0.3, 0.25, 0.2))]
    jmesh = jscenes.teapot_scene(1500)
    jcfg = jtypes.RenderConfig(width=64, height=48, leaf_size=8)
    jlights = lights(jtypes)
    jimg = _jax_frame(jmesh, jscenes.default_camera_for(jmesh), jlights,
                      jcfg)
    tmesh = tscenes.teapot_scene(1500)
    r = Renderer(tmesh, tscenes.default_camera_for(tmesh), lights(ttypes),
                 ttypes.RenderConfig(width=64, height=48, leaf_size=8),
                 device="cpu")
    assert r.route == "fusedN"
    _assert_close_frames(jimg, r.render_frame()["image"].numpy())


def test_soft_frame_matches_golden_statistically():
    """soft_spp4_128x96 (4 deg sun, spp 4) cannot be matched pixel for
    pixel: the golden's samples come from jax.random, the port's from its
    own generator. The measure is tests/test_golden.py's, the share of
    pixels more than 2 levels off, which absorbs the attribute path's
    12-bit normals (a shift of about 0.3 levels on average) and counts
    shadow samples that disagree. The bound: at most twice the share of
    a tpurt render of the same config with another seed (the golden is
    tpurt's seed-0 render), and within the golden tolerance."""
    jmesh = jscenes.teapot_scene(1500)
    jimg = _jax_frame(jmesh, jscenes.default_camera_for(jmesh),
                      jtypes.Light.sun((0.45, 0.8, 0.3),
                                       angular_radius_deg=4.0),
                      jtypes.RenderConfig(width=128, height=96,
                                          use_pallas=False, leaf_size=4,
                                          spp=4, seed=1))
    mesh = tscenes.teapot_scene(1500)
    r = Renderer(mesh, tscenes.default_camera_for(mesh),
                 ttypes.Light.sun((0.45, 0.8, 0.3), angular_radius_deg=4.0),
                 ttypes.RenderConfig(width=128, height=96, leaf_size=8,
                                     spp=4, seed=0), device="cpu")
    assert r.route == "fused0"
    out = r.render_frame()
    vis = out["shadow"][0][out["valid"]]
    assert ((vis > 0) & (vis < 1)).any()          # a penumbra was sampled
    golden = _golden("soft_spp4_128x96")

    def off(img):
        return (np.abs(to_uint8(img).astype(np.int16) - golden) > 2).mean()
    noise = off(jimg)
    ours = off(out["image"].numpy())
    assert noise > 0.0
    assert ours <= 2.0 * noise, f"port {ours:.4%} vs seed noise {noise:.4%}"
    assert ours < 0.005


def test_soft_frames_repeat_per_seed():
    """The same seed gives the same frame sequence; successive frames
    draw other samples."""
    mesh = tscenes.teapot_scene(1500)

    def frames():
        r = Renderer(mesh, tscenes.default_camera_for(mesh),
                     ttypes.Light.sun((0.45, 0.8, 0.3),
                                      angular_radius_deg=4.0),
                     ttypes.RenderConfig(width=48, height=40, leaf_size=14,
                                         spp=4, seed=3), device="cpu")
        return [r.render_frame()["shadow"] for _ in range(2)]
    a, b = frames(), frames()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])


# ---------------------------------------------------------------------------
# Routing: the port takes the fused path tpurt's gates give a light set
# ---------------------------------------------------------------------------

def _sets(mod):
    sun = mod.Light.sun((0.45, 0.8, 0.3), angular_radius_deg=2.0)
    point = mod.Light.point((2.0, 6.0, 1.0), radius=0.4)
    d0 = mod.Light.directional((0.45, 0.8, 0.3))
    d1 = mod.Light.directional((-0.5, 0.7, 0.2))
    return {"dir": [d0], "sun": [sun], "point": [point],
            "dir+dir": [d0, d1], "dir+dir+point": [d0, d1, point],
            "sun+point": [sun, point], "sun+dir+dir": [sun, d1, d0],
            "point+dir": [point, d1], "dir+sun": [d0, sun],
            "point+point": [point, point]}


# name[:unfused]: the light set, with fused_shadow=False after the colon.
ROUTES = [("dir", 1, "fused0"), ("sun", 1, "fused0"), ("sun", 8, "fused0"),
          ("point", 1, "fused0"), ("point", 4, "fused0"),
          ("dir+dir", 4, "fusedN"), ("dir+dir+point", 1, "fusedN"),
          ("sun+point", 1, "fusedN"), ("sun+dir+dir", 4, "fusedSM"),
          ("point+dir", 4, "fusedSM"), ("sun+point", 4, "fused0"),
          ("dir+sun", 4, "fused0"), ("point+point", 4, "fused0"),
          ("dir:unfused", 1, "unfused"), ("sun+point:unfused", 4, "unfused"),
          ("dir+dir:unfused", 1, "unfused")]
MIXED = [("sun+point", 4), ("dir+sun", 4), ("point+point", 4)]


@pytest.fixture(scope="module")
def jwide_accel():
    """A tpurt WideBVH for the gates, which only ask for its type."""
    return jwide.WideBVH(**{f.name: 0 for f in
                            dataclasses.fields(jwide.WideBVH)})


def _tpurt_route(cfg, accel, lights):
    """tpurt's render_frame_fn routing: fused0 takes light 0 whatever the
    number of lights, and "unfused" where no fused kernel applies."""
    if japp.fused_multi_applicable(cfg, accel, lights):
        return "fusedN"
    if japp.fused_soft_multi_applicable(cfg, accel, lights):
        return "fusedSM"
    if japp.fused_shadow_applicable(cfg, accel, lights):
        return "fused0"
    return "unfused"


@pytest.mark.parametrize("name,spp,route", ROUTES)
def test_routes_follow_tpurt_gates(monkeypatch, jwide_accel, name, spp,
                                   route):
    """tpurt gates the soft kernels on a compiled backend because its
    interpret-mode PRNG is a zero stream; the port's generator is real on
    every device, so the gates are compared as tpurt applies them on the
    chip."""
    import tpurt.kernels.traverse as jtraverse
    monkeypatch.setattr(jtraverse, "_compiled_backend", lambda: True)
    name, _, unfused = name.partition(":")
    fields = dict(width=32, height=32, leaf_size=8, spp=spp, gbuffer="ray",
                  fused_shadow=not unfused)
    jcfg = jtypes.RenderConfig(**fields)
    tcfg = ttypes.RenderConfig(**fields)
    assert _tpurt_route(jcfg, jwide_accel, _sets(jtypes)[name]) == route
    assert frame_route(tcfg, _sets(ttypes)[name]) == route


@pytest.mark.parametrize("name,spp", MIXED)
def test_mixed_light_sets_render(monkeypatch, name, spp):
    """Light sets with a soft light and a point or area extra: fused0 takes
    light 0 and the unfused shadow pass every light after it, as in
    tpurt's render_frame_fn. The frame is finite and has a penumbra."""
    traced = []
    real = tapp.shadow_production

    def spy(bvh, gbuf, light, seed, light_index, cfg):
        traced.append(light_index)
        return real(bvh, gbuf, light, seed, light_index, cfg)
    monkeypatch.setattr(tapp, "shadow_production", spy)
    mesh = tscenes.teapot_scene(1500)
    lights = _sets(ttypes)[name]
    r = Renderer(mesh, tscenes.default_camera_for(mesh), lights,
                 ttypes.RenderConfig(width=48, height=40, leaf_size=8,
                                     spp=spp), device="cpu")
    assert r.route == "fused0"
    out = r.render_frame()
    assert traced == list(range(1, len(lights)))
    assert torch.isfinite(out["image"]).all()
    vis = out["shadow"][:, out["valid"]]
    assert ((vis > 0) & (vis < 1)).any()


def test_more_than_31_mask_lights_raise():
    mesh = tscenes.teapot_scene(1500)
    lights = [ttypes.Light.directional((0.45, 0.8, 0.3))] * 32
    with pytest.raises(NotImplementedError, match="mask holds 31"):
        Renderer(mesh, tscenes.default_camera_for(mesh), lights,
                 ttypes.RenderConfig(width=32, height=32, leaf_size=8),
                 device="cpu")
    o = torch.zeros((32, 32, 3))
    with pytest.raises(ValueError, match="1..31"):
        trace_closest_multi_shadow(None, o, o, [((0.0, 1.0, 0.0), None)] * 32,
                                   1e-3, attr_tables=(o, o))
