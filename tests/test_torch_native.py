"""The native host library on both sides of the parity tests, and the
Renderer's behaviour without it.

``ensure_native_libraries`` makes every parity test see the same SBVH on
both packages. Under xdist every worker collects ``tests/test_native.py``,
whose ``skipif`` asks ``tpurt.native.available()`` at import: six workers
then run ``make`` on ``native/libtpurt_native.so`` at once, each writing
the file in place. A worker that loads it while another is still writing
it fails, and ``tpurt.native`` remembers the failure for the rest of the
process: its ``build_sah_lbvh`` returns None, so every parity fixture
built on it errors, and its Renderers build on the device instead. The
port's modules that build on the SBVH call this helper when they are
imported, so in every worker it runs after that collection: the port's
loader builds the library into a name of its own and renames it into
place, and ``tpurt``'s loader is made to try again while another worker
may still be writing the file. ``tests/test_sah.py`` and
``tests/test_native.py`` decide their skips at their own import, before
any port module is collected, so a worker that lost the race there still
skips them.
"""

import time

import numpy as np
import pytest
import torch

import tpurt.native as jnative
import tpurt.scenes as jscenes
from tpurt.types import Light as JLight
from tpurt.types import RenderConfig as JRenderConfig
import tpurt_torch.native as tnative
import tpurt_torch.scenes as tscenes
from tpurt_torch.app import Renderer
from tpurt_torch.types import Light, RenderConfig

torch.set_num_threads(1)

DIRECTION = (0.45, 0.8, 0.3)


def ensure_native_libraries(timeout_s: float = 120.0) -> None:
    """Build and load the native library in both packages; raise if either
    still fails after ``timeout_s`` (a load fails while another process
    is writing the file, and succeeds once it is done)."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            tnative.load_library()
            ported = True
        except OSError:
            ported = False
        if jnative._lib is None:
            jnative._lib_failed = False
            jnative.load_library()
        if ported and jnative._lib is not None:
            return
        if time.monotonic() > deadline:
            raise RuntimeError("the native library does not load")
        time.sleep(0.5)


ensure_native_libraries()


def _missing_library(monkeypatch, tmp_path):
    """Point the port's library at a file that does not exist, in a
    directory that does not exist."""
    missing = tmp_path / "absent"
    monkeypatch.setattr(tnative, "_NATIVE_DIR", str(missing))
    monkeypatch.setattr(tnative, "_LIB_PATH",
                        str(missing / "libtpurt_native.so"))
    monkeypatch.setattr(tnative._Library, "handle", None)


def test_available_reports_a_missing_library(monkeypatch, tmp_path):
    assert tnative.available()
    _missing_library(monkeypatch, tmp_path)
    assert not tnative.available()
    with pytest.raises(OSError):
        tnative.load_library()


def test_build_replaces_the_library_atomically(monkeypatch, tmp_path):
    """A first use builds into a name of its own and renames it into
    place: no temporary file is left and the result loads."""
    import shutil
    src = tmp_path / "native"
    src.mkdir()
    for name in ("Makefile", "tpurt_native.cpp"):
        shutil.copy(f"{tnative._NATIVE_DIR}/{name}", src / name)
    monkeypatch.setattr(tnative, "_NATIVE_DIR", str(src))
    monkeypatch.setattr(tnative, "_LIB_PATH", str(src / "libtpurt_native.so"))
    monkeypatch.setattr(tnative._Library, "handle", None)
    assert tnative.available()
    assert sorted(p.name for p in src.iterdir()) == [
        "Makefile", "libtpurt_native.so", "tpurt_native.cpp"]


def test_missing_library_renders_the_device_build(monkeypatch, tmp_path):
    """Without the native library the static scene builds on the device,
    "auto" resolves as for sah=False (the ray cast on the CPU), and the
    frame is tpurt's frame on its own device build."""
    _missing_library(monkeypatch, tmp_path)
    mesh = tscenes.teapot_scene(1500)
    cfg = RenderConfig(width=64, height=48, leaf_size=8)
    r = Renderer(mesh, tscenes.default_camera_for(mesh),
                 Light.directional(DIRECTION), cfg, device="cpu")
    assert "lbvh_build_ms" in r.stats and "sah_build_ms" not in r.stats
    assert r.config.gbuffer == "ray" and r.config.sah
    timg = r.render_frame()["image"].numpy()

    from test_torch_app import _assert_close_frames, _jax_frame
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_failed", True)
    jmesh = jscenes.teapot_scene(1500)
    jimg = _jax_frame(jmesh, jscenes.default_camera_for(jmesh),
                      JLight.directional(DIRECTION),
                      JRenderConfig(width=64, height=48, leaf_size=8))
    _assert_close_frames(jimg, timg)


def test_missing_library_resolves_auto_as_sah_false(monkeypatch, tmp_path):
    """The Renderer resolves "auto" with the effective sah, False without
    the library: on the card that is the rasterizer, tpurt's choice on
    its compiled backend."""
    import dataclasses
    from tpurt_torch import app
    _missing_library(monkeypatch, tmp_path)
    seen = []
    real = app.use_raster_gbuffer

    def spy(cfg, mode, device, split_blocks):
        seen.append(cfg.sah)
        return real(cfg, mode, device, split_blocks)
    monkeypatch.setattr(app, "use_raster_gbuffer", spy)
    mesh = tscenes.teapot_scene(200)
    Renderer(mesh, tscenes.default_camera_for(mesh),
             Light.directional(DIRECTION),
             RenderConfig(width=16, height=16, leaf_size=8), device="cpu")
    assert seen == [False]
    assert real(dataclasses.replace(RenderConfig(), sah=False), "static",
                "cuda", 0)
    assert not real(RenderConfig(), "static", "cuda", 0)


def test_sixth_positional_parameter_is_the_rebuild_threshold():
    """tpurt's Renderer(mesh, camera, lights, config, mode,
    rebuild_threshold, cache_dir): its valid call with a threshold of 1.6
    works in the port, and cache_dir stays seventh."""
    mesh = tscenes.teapot_scene(200)
    cam = tscenes.default_camera_for(mesh)
    cfg = RenderConfig(width=16, height=16, leaf_size=8)
    r = Renderer(mesh, cam, Light.directional(DIRECTION), cfg, "static",
                 1.6, device="cpu")
    assert r.rebuild_threshold == 1.6
    assert np.isfinite(r.render_frame()["image"].numpy()).all()
    with pytest.raises(NotImplementedError, match="cache_dir"):
        Renderer(mesh, cam, Light.directional(DIRECTION), cfg, "static",
                 1.6, "/nonexistent", device="cpu")
