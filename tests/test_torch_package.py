"""The port's package boundary: it imports neither jax nor tpurt, its
RenderConfig and scenes equal the JAX package's, and it does not fall
back to the CPU when CUDA is asked for."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpurt.scenes as jscenes
import tpurt.types as jtypes
import tpurt_torch.scenes as tscenes
import tpurt_torch.types as ttypes

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import tpurt_torch.app, tpurt_torch.kernels.traverse\n"
            "import tpurt_torch.kernels.sampling, tpurt_torch.kernels._build\n"
            "import tpurt_torch.convert, tpurt_torch.io.image\n"
            "import tpurt_torch.passes.shadow, tpurt_torch.passes.gbuffer\n"
            "import tpurt_torch.kernels.build, tpurt_torch.bvh.morton\n"
            "import tpurt_torch.bvh.lbvh, tpurt_torch.bvh.wide\n"
            "import tpurt_torch.raster.setup, tpurt_torch.kernels.raster\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'tpurt'\n"
            "       or m.startswith(('jax.', 'tpurt.'))]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_render_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jtypes.RenderConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(ttypes.RenderConfig)]
    assert tf == jf
    assert ttypes.LIGHT_DIRECTIONAL == jtypes.LIGHT_DIRECTIONAL
    assert ttypes.LIGHT_POINT == jtypes.LIGHT_POINT
    assert ttypes.LIGHT_AREA_CONE == jtypes.LIGHT_AREA_CONE


@pytest.mark.parametrize("name,arg", [("teapot_scene", 1500),
                                      ("sponza_scene", 30_000)])
def test_scene_arrays_equal(name, arg):
    jm = getattr(jscenes, name)(arg)
    tm = getattr(tscenes, name)(arg)
    for field in ("vertices", "normals", "indices", "albedo"):
        a, b = np.asarray(getattr(jm, field)), getattr(tm, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_cameras_and_lights_equal():
    mesh = tscenes.teapot_scene(1500)
    jc = jscenes.default_camera_for(jscenes.teapot_scene(1500))
    tc = tscenes.default_camera_for(mesh)
    for field in ("position", "target", "up", "fov_y", "znear", "zfar"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, field)),
                                      getattr(tc, field))
    jl = jtypes.Light.point((1.0, 2.0, 3.0), radius=0.5)
    tl = ttypes.Light.point((1.0, 2.0, 3.0), radius=0.5)
    assert jl.kind == tl.kind
    np.testing.assert_array_equal(np.asarray(jl.position), tl.position)


def test_convert_carries_mesh_camera_light():
    import tpurt_torch.convert as convert
    jm = jscenes.teapot_scene(1500)
    tm = convert.mesh(convert.numpy_fields(jm))
    for field in ("vertices", "normals", "indices", "albedo"):
        np.testing.assert_array_equal(getattr(tm, field),
                                      np.asarray(getattr(jm, field)))
    assert not tm.textured
    jc = jscenes.default_camera_for(jm)
    tc = convert.camera(convert.numpy_fields(jc))
    np.testing.assert_array_equal(tc.position, np.asarray(jc.position))
    assert tc.fov_y == np.float32(jc.fov_y)
    for jl in (jtypes.Light.directional((0.45, 0.8, 0.3)),
               jtypes.Light.point((1.0, 2.0, 3.0))):
        tl = convert.light(convert.numpy_fields(jl))
        assert tl.kind == jl.kind
        np.testing.assert_array_equal(tl.direction, np.asarray(jl.direction))
        np.testing.assert_array_equal(tl.position, np.asarray(jl.position))


def test_renderer_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the test checks the CPU-only refusal")
    from tpurt_torch.app import Renderer
    mesh = tscenes.teapot_scene(1500)
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(mesh, tscenes.default_camera_for(mesh),
                 ttypes.Light.directional((0.45, 0.8, 0.3)),
                 ttypes.RenderConfig(width=32, height=32, leaf_size=8),
                 device="cuda")


def test_renderer_defaults_to_the_card():
    """With no device the Renderer asks for the card, and on a box
    without CUDA it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the test checks the CPU-only refusal")
    from tpurt_torch.app import Renderer
    mesh = tscenes.teapot_scene(1500)
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(mesh, tscenes.default_camera_for(mesh),
                 ttypes.Light.directional((0.45, 0.8, 0.3)),
                 ttypes.RenderConfig(width=32, height=32, leaf_size=8))


@pytest.mark.parametrize("kwargs,what", [
    (dict(mode="rebuild", config=dict(rebuild_collapse="bfs")),
     "rebuild_collapse"),
    (dict(mode="rebuild", config=dict(bvh_width=2)),
     "clustered binary rebuild"),
    (dict(mode="rebuild", config=dict(top_sah=True)),
     "top_sah with sub-leaf clustering"),
    (dict(config=dict(use_pallas=False)), "use_pallas"),
    (dict(mode="refit"), "refit"),
    (dict(lights="three", config=dict(sort_rays=True)), "sort_rays"),
    (dict(cache_dir="unused"), "cache_dir"),
])
def test_outside_the_slice_raises(kwargs, what):
    from tpurt_torch.app import Renderer
    mesh = tscenes.teapot_scene(1500)
    # top_sah with the default rebuild_splits=-1 clusters the teapot's
    # rebuild (auto_split_blocks > 0), where tpurt fails.
    # sort_rays wraps the any-hit tracer of the unfused shadow pass: at spp
    # 4 fused0 takes light 0 and the unfused pass the sun and the hard
    # light 2.
    d = ttypes.Light.directional((0.45, 0.8, 0.3))
    lights = {"three": [d, ttypes.Light.sun((0.45, 0.8, 0.3)), d]
              }.get(kwargs.get("lights"), d)
    cfg = ttypes.RenderConfig(width=32, height=32, leaf_size=8, spp=4,
                              **kwargs.get("config", {}))
    with pytest.raises(NotImplementedError, match=what):
        Renderer(mesh, tscenes.default_camera_for(mesh), lights, cfg,
                 mode=kwargs.get("mode", "static"),
                 cache_dir=kwargs.get("cache_dir"), device="cpu")


@pytest.mark.parametrize("kwargs", [
    dict(mode="rebuild", config=dict(rebuild_collapse="fixed")),
    dict(textured=True, config=dict(gbuffer="raster")),
    dict(config=dict(gbuffer="raster", raster_deferred=True)),
    dict(mode="rebuild", config=dict(rebuild_splits=0, gbuffer="raster",
                                     raster_deferred=True)),
    dict(config=dict(sah=False, seeded_gbuffer=True)),
    dict(config=dict(inkernel_attrs=False, seeded_gbuffer=True)),
    dict(config=dict(seeded_gbuffer=True)),
    dict(mode="rebuild", config=dict(top_sah=True, rebuild_splits=0)),
], ids=["fixed_cut", "textured_raster", "raster_deferred",
        "raster_deferred_rebuild", "seeded_sah_false",
        "seeded_inkernel_attrs_false", "seeded", "top_sah_plain_rebuild"])
def test_formerly_refused_configs_render(kwargs):
    """The fixed cut, textured meshes, the deferred raster G-buffer, the
    seeded G-buffer and top_sah on the plain rebuild were refused until
    they were ported: each now renders a finite frame on the CPU."""
    from tpurt_torch.app import Renderer
    mesh = tscenes.teapot_scene(1500)
    if kwargs.get("textured"):
        mesh = dataclasses.replace(
            mesh, uv=np.asarray(mesh.vertices)[:, :2] * 0.3,
            tex_atlas=np.full((1, 4, 4, 3), 0.25, np.float32),
            tri_tex=np.zeros(mesh.num_triangles, np.int32))
    r = Renderer(mesh, tscenes.default_camera_for(mesh),
                 ttypes.Light.directional((0.45, 0.8, 0.3)),
                 ttypes.RenderConfig(width=32, height=32, leaf_size=8,
                                     **kwargs["config"]),
                 mode=kwargs.get("mode", "static"), device="cpu")
    out = r.render_frame()
    assert torch.isfinite(out["image"]).all() and out["valid"].any()
    if kwargs.get("textured"):
        assert torch.allclose(out["albedo"][out["valid"]],
                              torch.tensor(0.25))
