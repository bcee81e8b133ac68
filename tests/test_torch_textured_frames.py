"""Whole frames of a textured scene: the port's Renderer (CPU, plain
versions of the kernels) against the JAX package's Renderer (CPU, Pallas
interpret mode) on the same mesh (test_torch_textured_kernels.py's
textured teapot), 32x32 (the raster frame 64x48), leaf 8, one
directional light: the fused
attribute frame (HARD attrs=2), the unfused frame (CLOSEST attrs=2 and
the any hit), the shade-table frames (``inkernel_attrs=False``, fused and
unfused: the table's uv lanes), the raster frame (the texture pass on
(tri_id, position)), the binary frame and the textured rebuild (the
payload columns carry the layer and uv); and each route's albedo against
the untextured twin's, which it must replace exactly where a texture
lies. The routes are spread over three files for xdist: this one (fused,
unfused, binary), test_torch_textured_frames_table.py (the shade table,
the rebuild) and test_torch_textured_frames_raster.py.

Tolerances (decision 2 of ROADMAP.md): the image as in
tests/test_torch_app.py (at most 2e-3 of pixels off by more than 1e-3),
the valid masks equal, and the textured albedo off by more than 1e-3 on
at most 1e-3 of valid pixels: the bilinear tap moves with uv, which the
two packages interpolate with and without fused multiply-adds. The raster
G-buffer reconstructs its positions from 1/w, held to 2e-4 of the depth
(decision 8), which moves its uv most: at 32x32 (565 valid pixels, where
the share allows none) one pixel's albedo is 1.2e-3 off, so that frame is
64x48 (1472 valid pixels, none off by more than 8.9e-4 when measured).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpurt.app import Renderer as JRenderer
import tpurt.scenes as jscenes
from tpurt.types import Light as JLight
from tpurt.types import RenderConfig as JRenderConfig
import tpurt_torch.convert as convert
from tpurt_torch.app import Renderer
from tpurt_torch.types import Light, RenderConfig

from test_torch_app import _assert_close_frames
from test_torch_native import ensure_native_libraries
from test_torch_textured_kernels import textured_teapot

torch.set_num_threads(1)
ensure_native_libraries()

DIRECTION = (0.45, 0.8, 0.3)
SIZE = dict(width=32, height=32, leaf_size=8)

# (id, config fields, mode, the port's route)
ROUTES = {
    "fused_attr": (dict(), "static", "fused0"),
    "unfused": (dict(fused_shadow=False), "static", "unfused"),
    "shade_table": (dict(inkernel_attrs=False), "static", "fused0"),
    "shade_table_unfused": (dict(inkernel_attrs=False, fused_shadow=False),
                            "static", "unfused"),
    "raster": (dict(gbuffer="raster", width=64, height=48), "static",
               "unfused"),
    "binary": (dict(bvh_width=2), "static", "unfused"),
    "rebuild": (dict(), "rebuild", "fused0"),
}


def jax_outputs(mesh, fields, mode):
    """tpurt's Renderer frame -> {image, albedo, valid} as numpy."""
    checks = jax.config.jax_enable_checks
    jax.config.update("jax_enable_checks", False)
    try:
        out = JRenderer(mesh, jscenes.default_camera_for(mesh),
                        JLight.directional(DIRECTION),
                        JRenderConfig(**{**SIZE, **fields}), mode)
        out = out.render_frame()
        return {k: np.asarray(out[k]) for k in ("image", "albedo", "valid")}
    finally:
        jax.config.update("jax_enable_checks", checks)


def port_renderer(mesh, fields, mode):
    return Renderer(mesh, jscenes.default_camera_for(mesh),
                    Light.directional(DIRECTION),
                    RenderConfig(**{**SIZE, **fields}), mode=mode,
                    device="cpu")


def check_albedo(got, want):
    valid = want["valid"]
    np.testing.assert_array_equal(got["valid"], valid)
    off = np.abs(got["albedo"] - want["albedo"]).max(axis=-1) > 1e-3
    assert (off & valid).sum() <= 1e-3 * valid.sum(), int((off & valid).sum())


@pytest.fixture(scope="module")
def mesh():
    return textured_teapot()


def check_route(mesh, what):
    """One route's frame against tpurt's, and against its untextured
    twin."""
    fields, mode, route = ROUTES[what]
    want = jax_outputs(mesh, fields, mode)
    tmesh = convert.mesh(convert.numpy_fields(mesh))
    r = port_renderer(tmesh, fields, mode)
    assert r.route == route, what
    assert r.mesh.textured and isinstance(r.mesh.tex_atlas, torch.Tensor)
    out = r.render_frame()
    assert out["walk_counts"].tolist() == [0, 0]
    got = {k: out[k].numpy() for k in ("image", "albedo", "valid")}
    check_albedo(got, want)
    _assert_close_frames(want["image"], got["image"])
    # The textured albedo replaces the flat one exactly where a layer is.
    flat = port_renderer(dataclasses.replace(
        tmesh, uv=None, tex_atlas=None, tri_tex=None), fields, mode)
    fout = flat.render_frame()
    assert torch.equal(fout["valid"], out["valid"])
    layer = np.asarray(mesh.tri_tex)[np.maximum(out["tri_id"].numpy(), 0)]
    textured = (layer >= 0) & got["valid"]
    assert textured.any() and (got["valid"] & ~textured).any()
    np.testing.assert_array_equal(got["albedo"][~textured],
                                  fout["albedo"].numpy()[~textured])
    assert not np.allclose(got["albedo"][textured],
                           fout["albedo"].numpy()[textured])


@pytest.mark.parametrize("what", ["fused_attr", "unfused", "binary"])
def test_textured_frame_matches_jax_renderer(mesh, what):
    check_route(mesh, what)
