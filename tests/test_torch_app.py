"""Whole frames of the port's Renderer (CPU, plain traversal) against the
JAX package's Renderer (CPU, Pallas interpret mode) and the checked-in
golden image."""

import os

import jax
import numpy as np
import pytest
import torch

import tpurt.scenes as jscenes
from tpurt.app import Renderer as JRenderer
from tpurt.types import Light as JLight
from tpurt.types import RenderConfig as JRenderConfig
import tpurt_torch.scenes as tscenes
from tpurt_torch.app import Renderer
from tpurt_torch.io.image import read_png, to_uint8
from tpurt_torch.types import Light, RenderConfig

from test_torch_native import ensure_native_libraries

torch.set_num_threads(1)
ensure_native_libraries()

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
DIRECTION = (0.45, 0.8, 0.3)


def _jax_frame(mesh, cam, light, cfg, mode="static"):
    # JAX's internal consistency checks (on in conftest) double the
    # interpret-mode tracing time and check jax, not the port.
    checks = jax.config.jax_enable_checks
    jax.config.update("jax_enable_checks", False)
    try:
        return np.asarray(JRenderer(mesh, cam, light, cfg, mode)
                          .render_frame()["image"])
    finally:
        jax.config.update("jax_enable_checks", checks)


def _frames(scene, n, cam_fn, direction, width, height, leaf):
    jmesh = getattr(jscenes, scene)(n)
    tmesh = getattr(tscenes, scene)(n)
    jimg = _jax_frame(jmesh, getattr(jscenes, cam_fn)(*(
        (jmesh,) if cam_fn == "default_camera_for" else ())),
        JLight.directional(direction),
        JRenderConfig(width=width, height=height, leaf_size=leaf))
    tcam = getattr(tscenes, cam_fn)(*(
        (tmesh,) if cam_fn == "default_camera_for" else ()))
    r = Renderer(tmesh, tcam, Light.directional(direction),
                 RenderConfig(width=width, height=height, leaf_size=leaf),
                 device="cpu")
    timg = r.render_frame()["image"].numpy()
    return jimg, timg


def _assert_close_frames(jimg, timg):
    assert timg.shape == jimg.shape and timg.dtype == np.float32
    assert np.isfinite(timg).all()
    diff = np.abs(timg - jimg).max(axis=-1)
    assert (diff > 1e-3).mean() <= 2e-3, f"{(diff > 1e-3).sum()} pixels"


def test_teapot_frame_matches_jax_renderer():
    _assert_close_frames(*_frames("teapot_scene", 1500, "default_camera_for",
                                  DIRECTION, 64, 48, 8))


def test_teapot_frame_matches_golden():
    """The fused config of tests/gen_goldens.py, with the tolerance of
    tests/test_golden.py."""
    mesh = tscenes.teapot_scene(1500)
    r = Renderer(mesh, tscenes.default_camera_for(mesh),
                 Light.directional(DIRECTION),
                 RenderConfig(width=128, height=96, use_pallas=True,
                              gbuffer="ray", fused_shadow=True, leaf_size=8,
                              seed=0), device="cpu")
    img = r.render_frame()["image"].numpy()
    golden = read_png(os.path.join(GOLDEN, "teapot_128x96.png")
                      ).astype(np.int16)
    ours = to_uint8(img).astype(np.int16)
    assert ours.shape == golden.shape
    frac_off = (np.abs(ours - golden) > 2).mean()
    assert frac_off < 0.005, f"{frac_off:.4%} pixels differ"


def test_frames_repeat_exactly():
    mesh = tscenes.teapot_scene(1500)
    r = Renderer(mesh, tscenes.default_camera_for(mesh),
                 Light.point((2.0, 6.0, 1.0)),
                 RenderConfig(width=48, height=40, leaf_size=14),
                 device="cpu")
    a = r.render_frame()
    b = r.render_frame()
    assert torch.equal(a["image"], b["image"])
    assert a["valid"].any() and (a["shadow"][0][a["valid"]] < 1).any()


@pytest.mark.slow
def test_sponza_frame_matches_jax_renderer():
    _assert_close_frames(*_frames("sponza_scene", 30_000,
                                  "sponza_interior_camera",
                                  (0.25, 0.9, 0.2), 160, 90, 14))
