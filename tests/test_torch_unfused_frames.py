"""Whole frames of the port's unfused path (``fused_shadow=False``, and the
lights after light 0 that the fused kernels leave over) on the CPU, with
the plain traversals: against the JAX package's Renderer, against the
port's fused frames, and against the checked-in goldens."""

import os

import numpy as np
import pytest
import torch

import tpurt.scenes as jscenes
import tpurt.types as jtypes
import tpurt_torch.app as tapp
import tpurt_torch.scenes as tscenes
import tpurt_torch.types as ttypes
from tpurt.app import Renderer as JRenderer
from tpurt_torch.app import Renderer
from tpurt_torch.io.image import read_png, to_uint8

from test_torch_app import GOLDEN, _assert_close_frames, _jax_frame
from test_torch_multi_frames import _multilight
from test_torch_multi_shadow import jax_checks_off
from test_torch_native import ensure_native_libraries

torch.set_num_threads(1)
ensure_native_libraries()

DIRECTION = (0.45, 0.8, 0.3)


def _render(lights, **fields):
    mesh = tscenes.teapot_scene(1500)
    fields = dict(dict(width=64, height=48, leaf_size=8), **fields)
    r = Renderer(mesh, tscenes.default_camera_for(mesh), lights,
                 ttypes.RenderConfig(**fields), device="cpu")
    return r, r.render_frame()


def _golden_off(img, name):
    golden = read_png(os.path.join(GOLDEN, f"{name}.png")).astype(np.int16)
    ours = to_uint8(img).astype(np.int16)
    assert ours.shape == golden.shape
    return (np.abs(ours - golden) > 2).mean()


def test_unfused_frame_matches_jax_renderer():
    """One directional light through both Renderers' unfused frames (the
    attribute G-buffer kernel, then the any-hit kernel), 64x48, leaf 8."""
    jmesh = jscenes.teapot_scene(1500)
    jimg = _jax_frame(jmesh, jscenes.default_camera_for(jmesh),
                      jtypes.Light.directional(DIRECTION),
                      jtypes.RenderConfig(width=64, height=48, leaf_size=8,
                                          fused_shadow=False))
    r, out = _render(ttypes.Light.directional(DIRECTION), fused_shadow=False)
    assert r.route == "unfused"
    _assert_close_frames(jimg, out["image"].numpy())


@pytest.mark.parametrize("kind", ["directional", "point"])
def test_unfused_and_fused_hard_frames_agree(kind):
    """The same hard light through both paths: the same G-buffer, and the
    shadow differs on at most 1e-3 of valid pixels (the biased origin is
    rounded in tensor code on the unfused path, in the kernel on the
    fused one)."""
    light = ttypes.Light.directional(DIRECTION) if kind == "directional" \
        else ttypes.Light.point((2.0, 6.0, 1.0))
    rf, fused = _render(light)
    ru, unfused = _render(light, fused_shadow=False)
    assert (rf.route, ru.route) == ("fused0", "unfused")
    for k in ("position", "normal", "gnormal", "albedo", "depth", "t",
              "tri_id", "valid"):
        assert torch.equal(fused[k], unfused[k]), k
    valid = fused["valid"]
    mism = (fused["shadow"][0] != unfused["shadow"][0]) & valid
    assert mism.sum() <= 1e-3 * valid.sum()
    assert (unfused["shadow"][0][valid] < 1).any()
    assert unfused["walk_counts"].tolist() == [0, 0]


@pytest.mark.parametrize("light", ["sun", "lamp"])
def test_unfused_soft_frames_draw_the_fused_samples(light):
    """With the real stream, light 0's samples on the unfused path are
    keyed by (frame seed, 0) and counted by ray index, as in the fused
    kernels: the visibility is the same on >= 99.9% of valid pixels (only
    the origin's rounding differs)."""
    lt = ttypes.Light.sun(DIRECTION, angular_radius_deg=4.0) \
        if light == "sun" else ttypes.Light.point((2.0, 6.0, 1.0),
                                                  radius=0.4)
    _, fused = _render(lt, spp=4)
    _, unfused = _render(lt, spp=4, fused_shadow=False)
    valid = fused["valid"]
    vf, vu = fused["shadow"][0][valid], unfused["shadow"][0][valid]
    assert ((vu > 0) & (vu < 1)).any()
    assert (vf == vu).float().mean() >= 0.999


def test_multilight_frame_matches_golden_unfused():
    """gen_goldens' multilight_128x96 config (directional + point) through
    the unfused path, with the tolerance of tests/test_golden.py."""
    mesh = tscenes.teapot_scene(1500)
    r = Renderer(mesh, tscenes.default_camera_for(mesh),
                 _multilight(ttypes, mesh),
                 ttypes.RenderConfig(width=128, height=96, leaf_size=8,
                                     seed=0, fused_shadow=False),
                 device="cpu")
    assert r.route == "unfused"
    assert _golden_off(r.render_frame()["image"].numpy(),
                       "multilight_128x96") < 0.005


def _mixed(mod):
    return [mod.Light.sun(DIRECTION, angular_radius_deg=4.0),
            mod.Light.point((2.0, 6.0, 1.0), color=(0.4, 0.5, 1.0),
                            intensity=0.8, radius=0.4)]


def test_mixed_set_matches_tpurt_statistically():
    """A 4 deg sun + a point light of radius 0.4 at spp 4: the port takes
    the fused cone kernel for the sun and the unfused disk sampler for the
    point light; tpurt (use_pallas=False, leaf 4, seed 0) scans jax.random
    samples, which torch cannot reproduce. The measure of
    test_soft_frame_matches_golden_statistically: the share of pixels more
    than 2 levels off tpurt's frame 0 is at most twice that of tpurt's
    frame 1, which draws other samples."""
    jmesh = jscenes.teapot_scene(1500)
    with jax_checks_off():
        jr = JRenderer(jmesh, jscenes.default_camera_for(jmesh),
                       _mixed(jtypes),
                       jtypes.RenderConfig(width=96, height=72,
                                           use_pallas=False, leaf_size=4,
                                           spp=4, seed=0))
        ref = to_uint8(np.asarray(jr.render_frame()["image"])).astype(
            np.int16)
        other = np.asarray(jr.render_frame()["image"])
    r, out = _render(_mixed(ttypes), width=96, height=72, spp=4)
    assert r.route == "fused0"
    assert list(tapp.unfused_lights(r.route, 2)) == [1]

    def off(img):
        return (np.abs(to_uint8(img).astype(np.int16) - ref) > 2).mean()
    noise = off(other)
    ours = off(out["image"].numpy())
    assert noise > 0.0
    assert ours <= 2.0 * noise, f"port {ours:.4%} vs sample noise {noise:.4%}"


def test_walk_counts_sum_every_launch(monkeypatch):
    """render_frame_fn adds the walk counters of every launch of the frame,
    and the Renderer raises on their sum."""
    real = tapp.trace_any

    def counting(*args, **kw):
        occ, _ = real(*args, **kw)
        return occ, torch.tensor([2, 0], dtype=torch.int32)
    monkeypatch.setattr(tapp, "trace_any", counting)
    lights = [ttypes.Light.directional(DIRECTION),
              ttypes.Light.point((2.0, 6.0, 1.0))]
    mesh = tscenes.teapot_scene(1500)
    r = Renderer(mesh, tscenes.default_camera_for(mesh), lights,
                 ttypes.RenderConfig(width=32, height=32, leaf_size=8,
                                     fused_shadow=False), device="cpu")
    out = tapp.render_frame_fn(r.accel, mesh, r.camera, lights, r.config,
                               r.attr_tables)
    assert out["walk_counts"].tolist() == [4, 0]
    with pytest.raises(RuntimeError, match="4 stack overflows"):
        r.render_frame()


def test_soft_light_without_a_sampler_raises():
    """A soft light without an in-kernel sampler (the binary accel's case)
    takes tpurt's loop over samples, one any-hit call of jittered rays per
    sample; it raises only where the tracer itself does. (Before the binary
    tree was ported it raised NotImplementedError.)"""
    from tpurt_torch.passes.shadow import shadow_pass
    r, out = _render(ttypes.Light.directional(DIRECTION), fused_shadow=False)
    calls = []

    def tracer(o, d, t_max):
        calls.append(d.clone())
        return torch.zeros(t_max.shape, dtype=torch.bool), \
            torch.zeros(2, dtype=torch.int32)
    vis, counts = shadow_pass(tracer, out, ttypes.Light.sun(DIRECTION), 4, 0,
                              0, 1e-3)
    assert len(calls) == 4 and not torch.equal(calls[0], calls[1])
    assert torch.equal(vis, torch.ones_like(vis))
    assert counts.tolist() == [0, 0]

    def failing(o, d, t_max):
        raise RuntimeError("tracer failed")
    with pytest.raises(RuntimeError, match="tracer failed"):
        shadow_pass(failing, out, ttypes.Light.sun(DIRECTION), 4, 0, 0, 1e-3)


def test_sort_rays_with_only_soft_unfused_lights_renders():
    """sort_rays wraps only the hard any-hit tracer in tpurt: a frame whose
    unfused lights are all sampled renders."""
    r, out = _render(ttypes.Light.sun(DIRECTION, angular_radius_deg=4.0),
                     spp=2, fused_shadow=False, sort_rays=True)
    assert r.route == "unfused" and torch.isfinite(out["image"]).all()


@pytest.mark.slow
def test_sponza_frame_matches_golden_unfused():
    """gen_goldens' sponza_160x90 config through the unfused path, with the
    tolerance of tests/test_golden.py."""
    r = Renderer(tscenes.sponza_scene(30_000),
                 tscenes.sponza_interior_camera(),
                 ttypes.Light.directional((0.25, 0.9, 0.2)),
                 ttypes.RenderConfig(width=160, height=90, leaf_size=14,
                                     seed=0, fused_shadow=False),
                 device="cpu")
    assert r.route == "unfused"
    assert _golden_off(r.render_frame()["image"].numpy(),
                       "sponza_160x90") < 0.005
