"""The raster G-buffer frame of the port's Renderer (CPU, plain versions
of the kernels): ``gbuffer_raster_pass`` against ``tpurt``'s, the
"auto" choice of primary visibility, the raster frame against the ray
frame, the plain-Morton rebuild, and the recovery from a pair capacity
the view outgrew.

Tolerances of the G-buffer comparison and why: the binning rounds
differently from XLA's fused multiply-adds (test_torch_raster_setup), so
1/w, and with it depth, t and position, agree to 2e-4 relative; ids to
99.9% of the valid pixels; normals to 1e-4 (measured 4.3e-5), the
geometric normal and view directions to 1e-6; valid masks and albedo are
equal."""

import jax
import numpy as np
import pytest
import torch

import tpurt.scenes as jscenes
from tpurt.passes.gbuffer import gbuffer_raster_pass as jgbuffer_raster
from tpurt_torch import convert
from tpurt_torch.app import Renderer, use_raster_gbuffer
from tpurt_torch.passes.gbuffer import gbuffer_raster_pass
from tpurt_torch.scenes import default_camera_for, deform, teapot_scene
from tpurt_torch.types import Light, RenderConfig

from test_torch_native import ensure_native_libraries

torch.set_num_threads(1)
ensure_native_libraries()

W, H = 96, 64
DIRECTION = (0.45, 0.8, 0.3)


@pytest.fixture(scope="module")
def mesh():
    return teapot_scene(1500)


def _renderer(mesh, mode="static", lights=None, **cfg):
    fields = dict(width=W, height=H, leaf_size=8, gbuffer="raster")
    fields.update(cfg)
    return Renderer(mesh, default_camera_for(mesh),
                    lights or Light.directional(DIRECTION),
                    RenderConfig(**fields), mode=mode, device="cpu")


def test_gbuffer_matches_tpurt(mesh):
    jm = jscenes.teapot_scene(1500)
    jc = jscenes.default_camera_for(jm)
    want = {k: np.asarray(v) for k, v in jgbuffer_raster(
        jax.device_put(jm), jc, W, H, None, interpret=True).items()}
    got = {k: v.numpy() for k, v in gbuffer_raster_pass(
        mesh.on("cpu"), convert.camera(convert.numpy_fields(jc)), W,
        H).items()}
    assert set(got) == set(want)
    assert not got["raster_overflow"] and not want["raster_overflow"]
    valid = want["valid"]
    np.testing.assert_array_equal(got["valid"], valid)
    assert valid.mean() > 0.3
    same = (got["tri_id"] == want["tri_id"]) & valid
    assert same.sum() >= 0.999 * valid.sum()
    np.testing.assert_array_equal(got["tri_id"][~valid], -1)
    depth = want["depth"][same]
    for k in ("depth", "t"):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=2e-4)
        np.testing.assert_array_equal(got[k][~valid], want[k][~valid])
    dp = np.abs(got["position"] - want["position"])[same].max(axis=-1)
    assert (dp <= 2e-4 * depth).all()
    for k, tol in (("normal", 1e-4), ("gnormal", 1e-6), ("view_dir", 1e-6),
                   ("albedo", 0.0)):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=0,
                                   atol=tol, err_msg=k)
    for k in ("normal", "gnormal", "albedo"):
        np.testing.assert_array_equal(got[k][~valid], 0.0, err_msg=k)


# (config fields, mode, device, resolved rebuild splits) -> raster?
AUTO = [
    ("static SBVH", dict(), "static", "cuda", 0, False),
    ("static SBVH", dict(), "static", "cpu", 0, False),
    ("sah=False", dict(sah=False), "static", "cuda", 0, True),
    ("sah=False", dict(sah=False), "static", "cpu", 0, False),
    ("clustered rebuild", dict(), "rebuild", "cuda", 47, False),
    ("clustered rebuild", dict(), "rebuild", "cpu", 47, False),
    ("plain rebuild", dict(rebuild_splits=0), "rebuild", "cuda", 0, True),
    ("plain rebuild", dict(rebuild_splits=0), "rebuild", "cpu", 0, False),
    ("explicit raster", dict(gbuffer="raster"), "static", "cpu", 0, True),
    ("explicit ray", dict(gbuffer="ray", sah=False), "static", "cuda", 0,
     False),
]


@pytest.mark.parametrize("what,fields,mode,device,splits,raster", AUTO)
def test_auto_resolution(what, fields, mode, device, splits, raster):
    """tpurt's strategy by accel and backend: the ray cast on an SBVH and
    on a clustered rebuild, else the rasterizer on the card and the ray
    cast on the CPU (no card is needed: the choice is a pure function)."""
    cfg = RenderConfig(**fields)
    assert use_raster_gbuffer(cfg, mode, device, splits) is raster, what


def test_renderer_resolves_auto_on_the_cpu(mesh):
    r = _renderer(mesh, gbuffer="auto", sah=False)
    assert r.config.gbuffer == "ray" and r.attr_tables is not None
    r = _renderer(mesh)
    assert r.config.gbuffer == "raster" and r.route == "unfused"
    assert r.attr_tables is None and "attr_rows_ms" not in r.stats


def test_raster_frame_matches_ray_frame(mesh):
    """tests/test_raster.py's bound: images agree but at silhouette
    pixels."""
    ray = _renderer(mesh, gbuffer="ray").render_frame()
    out = _renderer(mesh).render_frame()
    assert not bool(out["raster_overflow"])
    img = out["image"].numpy()
    assert np.isfinite(img).all() and int(out["valid"].sum()) > 100
    diff = np.abs(img - ray["image"].numpy()).max(axis=-1)
    assert (diff > 2e-2).mean() < 0.01


def test_raster_frame_every_light_unfused(mesh):
    """A sun at spp 4, a lamp and a directional light: each light's
    visibility comes from the unfused shadow pass on the raster G-buffer;
    the frame agrees with the ray frame of the same light set, whose
    shadow pass draws the same samples."""
    lights = [Light.sun(DIRECTION, angular_radius_deg=4.0),
              Light.point((2.0, 6.0, 1.0), radius=0.4),
              Light.directional((-0.5, 0.7, 0.2))]
    ray = _renderer(mesh, lights=lights, gbuffer="ray", spp=4,
                    fused_shadow=False).render_frame()
    out = _renderer(mesh, lights=lights, spp=4).render_frame()
    assert out["shadow"].shape == (3, H, W)
    diff = np.abs(out["image"].numpy() - ray["image"].numpy()).max(axis=-1)
    assert (diff > 2e-2).mean() < 0.01


def test_shade_table_flags_are_not_read_on_raster(mesh):
    """tpurt reads neither inkernel_attrs nor seeded_gbuffer on the raster
    G-buffer: the frame renders as without them."""
    want = _renderer(mesh).render_frame()["image"]
    got = _renderer(mesh, inkernel_attrs=False,
                    seeded_gbuffer=True).render_frame()["image"]
    assert torch.equal(got, want)


def test_overflow_recovery_grows_the_capacity(mesh):
    """tests/test_raster.py:113-129: a capacity of 256 pair rows overflows,
    the frame is rendered again with a bigger one, and the image equals
    an amply sized first try."""
    r = _renderer(mesh, width=48, height=32, raster_cap_pairs=256)
    out = r.render_frame()
    assert r.config.raster_cap_pairs > 256
    assert r.stats["raster_cap_growths"] == 1 and r.frame_index == 1
    assert not bool(out["raster_overflow"])
    want = _renderer(mesh, width=48, height=32).render_frame()
    assert torch.equal(out["image"], want["image"])


def test_plain_morton_rebuild_raster_frame(mesh):
    """Config 2 with rebuild_splits=0: the raster G-buffer on every
    rebuilt tree (no attribute rows), the same image as the static raster
    frame, and animated frames that stay finite."""
    r = _renderer(mesh, mode="rebuild", rebuild_splits=0)
    assert r.config.gbuffer == "raster" and r._rebuild_splits == 0
    assert r.attr_tables is None and r.bvh.leaf_block is None
    img = r.render_frame()["image"]
    assert r.attr_tables is None and r.stats["build_ms"] > 0
    want = _renderer(mesh).render_frame()["image"]
    diff = (img - want).abs().amax(-1)
    assert float((diff > 1e-3).float().mean()) <= 2e-3
    r.set_vertices(deform(mesh, 0.3))
    out = r.render_frame()
    assert bool(torch.isfinite(out["image"]).all())
    assert r.stats["overflow_recoveries"] == 0


@pytest.mark.slow
def test_frame_matches_tpurt_renderer(mesh):
    """tpurt's Renderer(gbuffer="raster") (interpret-mode rasterizer, pure
    JAX shadow walk) against the port's raster frame: images agree but at
    silhouette and shadow-edge pixels."""
    from tpurt.app import Renderer as JRenderer
    from tpurt.types import Light as JLight
    from tpurt.types import RenderConfig as JConfig
    jm = jscenes.teapot_scene(1500)
    jr = JRenderer(jm, jscenes.default_camera_for(jm),
                   JLight.directional(DIRECTION),
                   JConfig(width=48, height=32, use_pallas=False,
                           gbuffer="raster"))
    want = np.asarray(jr.render_frame()["image"])
    got = _renderer(mesh, width=48, height=32).render_frame()["image"]
    diff = np.abs(got.numpy() - want).max(axis=-1)
    assert (diff > 2e-2).mean() < 0.01
