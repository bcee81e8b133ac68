"""Whole frames through the shade table (``inkernel_attrs=False``): the
port's Renderer (CPU, plain versions of the kernels) against the JAX
package's Renderer with the same flag (CPU, Pallas interpret mode), on a
static scene, fused (fused0: light 0's hard shadow in the attrs=0 kernel)
and unfused (the plain closest hit, then the any-hit pass); the checked-in
goldens through the flag; and the slice check. Rebuild frames are in
test_torch_shade_table_rebuild.py.

Tolerances: tpurt's frames as in tests/test_torch_app.py (at most 2e-3 of
pixels off by more than 1e-3); the goldens as in tests/test_golden.py (at
most 0.5% of pixels more than 2 levels off).
"""

import os

import numpy as np
import pytest
import torch

import tpurt.scenes as jscenes
from tpurt.types import Light as JLight
from tpurt.types import RenderConfig as JRenderConfig
import tpurt_torch.scenes as tscenes
from tpurt_torch.app import Renderer, check_slice
from tpurt_torch.io.image import read_png, to_uint8
from tpurt_torch.types import Light, RenderConfig

from test_torch_app import GOLDEN, _assert_close_frames, _jax_frame
from test_torch_native import ensure_native_libraries

torch.set_num_threads(1)
ensure_native_libraries()

DIRECTION = (0.45, 0.8, 0.3)


@pytest.mark.parametrize("fused", [True, False], ids=["fused0", "unfused"])
def test_shade_table_frame_matches_jax_renderer(fused):
    fields = dict(width=64, height=48, leaf_size=8, inkernel_attrs=False,
                  fused_shadow=fused)
    jmesh = jscenes.teapot_scene(1500)
    jimg = _jax_frame(jmesh, jscenes.default_camera_for(jmesh),
                      JLight.directional(DIRECTION), JRenderConfig(**fields))
    tmesh = tscenes.teapot_scene(1500)
    r = Renderer(tmesh, tscenes.default_camera_for(tmesh),
                 Light.directional(DIRECTION), RenderConfig(**fields),
                 device="cpu")
    assert r.route == ("fused0" if fused else "unfused")
    assert r.attr_tables is None and r.shade_table is not None
    assert "shade_table_ms" in r.stats and "attr_rows_ms" not in r.stats
    out = r.render_frame()
    _assert_close_frames(jimg, out["image"].numpy())
    assert out["walk_counts"].tolist() == [0, 0]


def _golden_off(img, name):
    golden = read_png(os.path.join(GOLDEN, f"{name}.png")).astype(np.int16)
    ours = to_uint8(img.numpy()).astype(np.int16)
    assert ours.shape == golden.shape
    return (np.abs(ours - golden) > 2).mean()


@pytest.mark.parametrize("mode,fused", [("static", True), ("static", False),
                                        ("rebuild", True)])
def test_teapot_golden_through_the_shade_table(mode, fused):
    """gen_goldens' fused teapot config with inkernel_attrs=False: the
    fused frame, the unfused frame and the rebuilt frame."""
    mesh = tscenes.teapot_scene(1500)
    r = Renderer(mesh, tscenes.default_camera_for(mesh),
                 Light.directional(DIRECTION),
                 RenderConfig(width=128, height=96, use_pallas=True,
                              gbuffer="ray", fused_shadow=fused, leaf_size=8,
                              seed=0, inkernel_attrs=False),
                 mode=mode, device="cpu")
    frac_off = _golden_off(r.render_frame()["image"], "teapot_128x96")
    assert frac_off < 0.005, f"{frac_off:.4%} pixels differ"


def test_multilight_golden_through_the_shade_table():
    """gen_goldens' multilight set (directional + point) through the
    attrs=0 multi-light kernel (fusedN)."""
    import tpurt_torch.types as ttypes
    from test_torch_multi_frames import _multilight
    mesh = tscenes.teapot_scene(1500)
    r = Renderer(mesh, tscenes.default_camera_for(mesh),
                 _multilight(ttypes, mesh),
                 RenderConfig(width=128, height=96, leaf_size=8, seed=0,
                              inkernel_attrs=False), device="cpu")
    assert r.route == "fusedN"
    frac_off = _golden_off(r.render_frame()["image"], "multilight_128x96")
    assert frac_off < 0.005, f"{frac_off:.4%} pixels differ"


def test_shade_table_frame_equals_the_attribute_frame_on_the_hit_set():
    """Both tables on one accel: the same hits (t, tri_id, valid) and the
    same shadows; the shading differs only by the attribute rows' 12-bit
    normals against the table's full-precision ones."""
    mesh = tscenes.teapot_scene(1500)
    cam = tscenes.default_camera_for(mesh)
    lights = [Light.sun(DIRECTION, angular_radius_deg=4.0),
              Light.directional((-0.5, 0.7, 0.2))]
    outs = []
    for attrs in (True, False):
        r = Renderer(mesh, cam, lights,
                     RenderConfig(width=64, height=48, leaf_size=8, spp=2,
                                  inkernel_attrs=attrs), device="cpu")
        assert r.route == "fusedSM"
        outs.append(r.render_frame())
    a, b = outs
    for k in ("t", "tri_id", "valid", "shadow"):
        assert torch.equal(a[k], b[k]), k
    assert (a["image"] - b["image"]).abs().max() < 2e-2


def test_check_slice_takes_the_shade_table_and_refuses_seeded():
    """The shade table in both modes; the seeded G-buffer, refused until
    its first-hit kernel was ported, is taken too
    (tests/test_torch_seeded.py renders it)."""
    mesh = tscenes.teapot_scene(200)
    lights = [Light.directional(DIRECTION)]
    check_slice(RenderConfig(inkernel_attrs=False, gbuffer="ray"), "static",
                lights, mesh, None)
    check_slice(RenderConfig(inkernel_attrs=False, gbuffer="ray"),
                "rebuild", lights, mesh, None)
    check_slice(RenderConfig(inkernel_attrs=False, seeded_gbuffer=True,
                             gbuffer="ray"), "static", lights, mesh, None)
