"""The static raster frame as CUDA graphs (``tpurt_torch/graphs.py``,
``Renderer._graph_frame``) on the card, against its eager twin.

Every test here is marked ``cuda``: it needs an NVIDIA card and skips
elsewhere (run them there with ``python -m pytest --noconftest -m cuda
tests/test_torch_raster_graph.py``). On the hall (``sponza_scene(20_000)``)
from its interior camera at 320x192, the cell's settings (Morton LBVH,
``fused_shadow=False``):

- replayed raster frames equal the eager frames bit for bit in every
  output, for the 32-float and the z-only (deferred) G-buffer, with one
  sun and with three, and launch the rasterizer once a frame;
- a new camera under the same capture key replays the same graphs, with
  no new capture, and equals an eager frame at that camera;
- a frame that overflows a small pair capacity grows it once, is
  captured under the new key on the next frame, and equals the eager
  frame;
- traced replays record the binning, rasterizer and shadow-walk spans
  and count the binned pairs and the shadow rays as the eager frames do;
- a resolving ray-cast frame's capture holds its six stages, one graph
  each, as before the raster frame took the graphs.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpurt_torch.app as app
from tpurt_torch.app import Renderer
from tpurt_torch.kernels.raster import (rasterize_rows16_cuda,
                                        rasterize_rows_cuda)
from tpurt_torch.scenes import sponza_interior_camera, sponza_scene
from tpurt_torch.types import Camera, Light, RenderConfig

torch.set_num_threads(1)

W, H = 320, 192
SEED = 2 ** 31 + 22_013
SUNS = [Light.directional((0.25, 0.9, 0.2), intensity=0.8),
        Light.directional((-0.55, 0.65, 0.25), color=(1.0, 0.85, 0.6),
                          intensity=0.5),
        Light.directional((0.1, 0.9, -0.4), color=(0.7, 0.8, 1.0),
                          intensity=0.35)]
RASTER = dict(sah=False, gbuffer="raster", fused_shadow=False)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def hall():
    return sponza_scene(20_000)


def _renderer(mesh, card, lights=1, **fields):
    cfg = RenderConfig(width=W, height=H, leaf_size=14, seed=SEED,
                       **{**RASTER, **fields})
    return Renderer(mesh, sponza_interior_camera(), SUNS[:lights], cfg,
                    device=card)


def _frames(r, n, eager, monkeypatch, cameras=None):
    """n frames of ``r``, eagerly where ``eager``; the camera set to
    ``cameras[i]`` before frame i where given."""
    outs = []
    for i in range(n):
        if cameras is not None:
            r.camera = cameras[i]
        with monkeypatch.context() as mp:
            if eager:
                mp.setattr(app, "takes_graph", lambda *a: False)
            outs.append(r.render_frame())
    torch.cuda.synchronize()
    return outs


def _assert_same(a, b):
    assert set(a) == set(b)
    for k, v in b.items():
        assert a[k].dtype == v.dtype and a[k].shape == v.shape, k
        x, y = a[k], v
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), k


def _moved(i):
    """The interior camera moved along the atrium and turned a little."""
    c = sponza_interior_camera()
    return Camera.look_at(c.position + np.float32([0.6, 0.05, -0.2]) * i,
                          c.target + np.float32([0.0, -0.3, 0.4]) * i,
                          fov_y_deg=65.0 - 3.0 * i, zfar=float(c.zfar))


@pytest.mark.cuda
@pytest.mark.parametrize("deferred", [False, True], ids=["rec32", "z16"])
@pytest.mark.parametrize("lights", [1, 3])
def test_replayed_raster_frame_equals_eager(card, hall, monkeypatch,
                                            deferred, lights):
    graph = _renderer(hall, card, lights, raster_deferred=deferred)
    eager = _renderer(hall, card, lights, raster_deferred=deferred)
    kernel = rasterize_rows16_cuda if deferred else rasterize_rows_cuda
    before = kernel.launches
    outs = _frames(graph, 4, False, monkeypatch)
    assert kernel.launches == before + 4
    assert graph.stats["graph_captures"] == 1
    assert graph.stats["graph_replays"] == 3
    for a, b in zip(outs, _frames(eager, 4, True, monkeypatch)):
        _assert_same(a, b)
    assert outs[-1]["valid"].float().mean() > 0.5


@pytest.mark.cuda
def test_new_camera_replays_the_same_graphs(card, hall, monkeypatch):
    graph = _renderer(hall, card)
    eager = _renderer(hall, card)
    cams = [sponza_interior_camera()] * 2 + [_moved(i) for i in (1, 2, 3)]
    outs = _frames(graph, 2, False, monkeypatch, cams)
    g = graph._graphs
    steps = list(g.steps)
    outs += _frames(graph, 3, False, monkeypatch, cams[2:])
    assert graph._graphs is g and g.steps == steps
    assert graph.stats["graph_captures"] == 1
    assert graph.stats["graph_replays"] == 4
    want = _frames(eager, 5, True, monkeypatch, cams)
    for a, b in zip(outs, want):
        _assert_same(a, b)
    assert not torch.equal(outs[-1]["t"], outs[0]["t"])


@pytest.mark.cuda
def test_overflow_grows_and_captures_under_the_new_key(card, hall,
                                                       monkeypatch):
    graph = _renderer(hall, card, raster_cap_pairs=1024)
    eager = _renderer(hall, card, raster_cap_pairs=1024)
    outs = _frames(graph, 4, False, monkeypatch)
    assert graph.stats["raster_cap_growths"] == 1
    assert graph.config.raster_cap_pairs > 1024
    assert graph._graphs.key[1] == graph.config
    assert graph.stats["graph_captures"] == 1
    assert graph.stats["graph_replays"] == 3
    want = _frames(eager, 4, True, monkeypatch)
    assert eager.stats["raster_cap_growths"] == 1
    for a, b in zip(outs, want):
        _assert_same(a, b)
        assert not bool(a["raster_overflow"])


def _traced(r, n, eager, monkeypatch):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _frames(r, n, eager, monkeypatch)
    return r.spans


@pytest.mark.cuda
@pytest.mark.parametrize("lights", [1, 3])
def test_traced_replays_record_spans_and_counters(card, hall, monkeypatch,
                                                  lights):
    graph = _renderer(hall, card, lights)
    eager = _renderer(hall, card, lights)
    _frames(graph, 2, False, monkeypatch)        # eager, then the capture
    sg = _traced(graph, 3, False, monkeypatch)
    se = _traced(eager, 3, True, monkeypatch)
    assert sg.frames == se.frames == 3
    assert sg.graph_frames == 3 and se.graph_frames == 0
    assert sg.syncs == se.syncs == 3
    assert sg.counts == se.counts
    assert sg.counts["raster_pairs"] > 0 and sg.counts["shadow_rays"] > 0
    tg, te = sg.totals, se.totals
    for name in ("tpurt.gbuffer.bin", "tpurt.gbuffer.raster", "tpurt.walk"):
        assert tg[name]["entries"] == te[name]["entries"] > 0, name
    assert {k: v["entries"] for k, v in tg.items()} == \
        {k: v["entries"] for k, v in te.items()}
    inner = tg["tpurt.gbuffer.bin"]["device_ms"] \
        + tg["tpurt.gbuffer.raster"]["device_ms"]
    assert tg["tpurt.gbuffer"]["self_ms"] == pytest.approx(
        tg["tpurt.gbuffer"]["device_ms"] - inner)


@pytest.mark.cuda
def test_resolving_capture_keeps_its_stages(card, hall, monkeypatch):
    cfg = RenderConfig(width=W, height=H, leaf_size=14, seed=SEED,
                       sah=False, gbuffer="ray")
    r = Renderer(hall, sponza_interior_camera(), SUNS[:1], cfg, device=card)
    assert r.route == "fused0"
    _frames(r, 2, False, monkeypatch)
    stages = ("tpurt.order", "tpurt.rays", "tpurt.walk", "tpurt.gbuffer",
              "tpurt.shadow", "tpurt.composite")
    want = [s for name in stages
            for s in (("open", name), ("graph",), ("close", name))]
    assert [s[:1] if s[0] == "graph" else s for s in r._graphs.steps] \
        == want
