"""The frame's block of constants and the CUDA-graph frames
(``tpurt_torch/frame_block.py``, ``tpurt_torch/graphs.py``), on the CPU:
the block holds, bit for bit, the float32 values a copy of each host
value makes, and the walks' scalar blocks and seed read from it equal
those made from the host values; a raster frame's clip words equal the
host's camera basis and projection, are written only for a raster frame
and only when the camera or the frame size changed, and the clip
transform and the binning fed from them equal those fed host floats, bit
for bit; which frames take the graphs is a function of (mode, device)
alone, whatever the G-buffer and the route; the capture key follows what
the graphs bake in and nothing else; CPU frames and CPU rebuilds capture
and replay nothing; a frame's outputs stay as they were after the next
frame, static or rebuilt.

With CUDA graphs stood in for by graphs that run their code when
captured and do nothing when replayed (``cpu_graphs``), a captured frame
nests its stages as the eager frame does (the raster frames' binning and
rasterizer in ``tpurt.gbuffer``, the shadow walk in ``tpurt.shadow``; a
resolving frame's six stages one graph each, as before), and traced
replays record the eager frame's spans and counters
(``tests/test_torch_raster_graph.py`` holds the frames on the card)."""

import contextlib
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_native import ensure_native_libraries  # noqa: E402

import tpurt_torch.app as app  # noqa: E402
import tpurt_torch.frame_block as fb  # noqa: E402
import tpurt_torch.kernels.traverse as tr  # noqa: E402
from tpurt_torch.app import Renderer, frame_seed  # noqa: E402
from tpurt_torch.bvh.wide import order_children_for_point  # noqa: E402
from tpurt_torch.camera import camera_basis, generate_rays  # noqa: E402
from tpurt_torch.frame_block import FrameBlock  # noqa: E402
from tpurt_torch.graphs import capture_key, takes_graph  # noqa: E402
from tpurt_torch.kernels.sampling import sample_uniforms  # noqa: E402
from tpurt_torch.passes.shadow import cone_cos  # noqa: E402
from tpurt_torch.raster.setup import (RasterRows, _projection, bin_rows,  # noqa: E402,E501
                                      clip_constants, clip_transform,
                                      default_cap_rows)
from tpurt_torch.scenes import (default_camera_for, deform,  # noqa: E402
                                sponza_interior_camera, sponza_scene,
                                teapot_scene)
from tpurt_torch.spans import to_device  # noqa: E402
from tpurt_torch.types import Camera, Light, RenderConfig  # noqa: E402

ensure_native_libraries()
torch.set_num_threads(1)

W, H = 40, 24
SEED = 2 ** 31 + 977
SUN = Light.directional((0.45, 0.8, 0.3))
SOFT_SUN = Light.sun((0.2, 0.5, -0.8), angular_radius_deg=4.0)
FILL = Light.directional((-0.5, 0.7, 0.2), color=(1.0, 0.8, 0.6),
                         intensity=0.5)
SKY = Light.directional((0.1, 0.9, -0.4), color=(0.7, 0.8, 1.0),
                        intensity=0.35)


@pytest.fixture(scope="module")
def mesh():
    return teapot_scene(1200)


def _lamp(mesh, radius):
    c = 0.5 * sum(mesh.bounds())
    return Light.point(c + np.float32([0.3, 1.2, 0.4]), radius=radius,
                       intensity=2.0)


# route name -> (lights, config fields, the route the Renderer takes)
ROUTES = {
    "hard": (lambda m: [SUN], {}, "fused0"),
    "soft": (lambda m: [SOFT_SUN], dict(spp=4, accumulate=True), "fused0"),
    "psoft": (lambda m: [_lamp(m, 0.15)], dict(spp=4), "fused0"),
    "point_hard": (lambda m: [_lamp(m, 0.0)], {}, "fused0"),
    "multi": (lambda m: [SUN, FILL, SKY], {}, "fusedN"),
    "soft_multi": (lambda m: [SOFT_SUN, FILL], dict(spp=4), "fusedSM"),
    "psoft_multi": (lambda m: [_lamp(m, 0.15), FILL], dict(spp=4),
                    "fusedSM"),
    "unfused": (lambda m: [SOFT_SUN, _lamp(m, 0.15), SUN],
                dict(fused_shadow=False, spp=4), "unfused"),
    "shade_table": (lambda m: [SUN, FILL], dict(inkernel_attrs=False),
                    "fusedN"),
    "binary": (lambda m: [SOFT_SUN], dict(bvh_width=2, sah=False, spp=4),
               "unfused"),
    "raster": (lambda m: [SUN], dict(gbuffer="raster"), "unfused"),
    "raster_deferred": (lambda m: [SUN, FILL, SKY],
                        dict(gbuffer="raster", raster_deferred=True),
                        "unfused"),
}


def _renderer(mesh, route, mode="static", **more):
    lights, fields, _ = ROUTES[route]
    cfg = RenderConfig(width=W, height=H, leaf_size=8, seed=SEED,
                       **{**fields, **more})
    return Renderer(mesh, default_camera_for(mesh), lights(mesh), cfg,
                    mode=mode, device="cpu")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(_bits(a), _bits(b)))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_block_holds_the_copied_values(mesh, route):
    """Every view equals the copy of its host value that the frame made
    before the block (``spans.to_device``), bit for bit and in shape; the
    seed view holds the frame seed's bits; the near-first order from the
    block's camera position is the order from the host's."""
    r = _renderer(mesh, route)
    assert r.route == ROUTES[route][2]
    cam, cfg = r.camera, r.config
    k = r._block.write(cam, r.lights, cfg, frame_seed(cfg.seed, 5))
    for f in ("position", "target", "up", "fov_y", "zfar"):
        assert _same(getattr(k.camera, f), to_device(getattr(cam, f),
                                                     "cpu")), f
    for view, light in zip(k.lights, r.lights):
        assert view.kind == light.kind
        for f in ("direction", "position", "color", "intensity", "radius"):
            assert _same(getattr(view, f), to_device(getattr(light, f),
                                                     "cpu")), f
        assert _same(cone_cos(view), to_device(cone_cos(light), "cpu"))
    assert _same(k.bias, to_device(cfg.shadow_bias, "cpu"))
    assert _same(k.background, to_device(cfg.background, "cpu"))
    assert k.seed.dtype == torch.int32 and k.seed.shape == (1,)
    assert int(k.seed[0]) & 0xFFFFFFFF == frame_seed(cfg.seed, 5)
    if route != "binary":
        assert torch.equal(
            order_children_for_point(r.accel, k.camera.position).nodes,
            order_children_for_point(r.accel, cam.position).nodes)


def _host_and_views(mesh):
    r = _renderer(mesh, "unfused")
    lights = r.lights + [FILL]
    k = FrameBlock(len(lights), "cpu").write(r.camera, lights, r.config,
                                             frame_seed(SEED, 2))
    o, d = generate_rays(r.camera, W, H, "cpu")
    return r, lights, k, o, d


# Each walk's inputs from (light set, bias, seed) -> (args, kwargs).
INPUTS = {
    "hard_dir": lambda r, ls, b, s, o, d: tr.closest_shadow_inputs(
        r.accel, o, d, ls[3].direction, b, r.attr_tables),
    "hard_point": lambda r, ls, b, s, o, d: tr.closest_shadow_inputs(
        r.accel, o, d, None, b, r.attr_tables, light_pos=ls[1].position),
    "multi": lambda r, ls, b, s, o, d: tr.closest_multi_shadow_inputs(
        r.accel, o, d, [(ls[2].direction, None), (None, ls[1].position),
                        (ls[3].direction, None)], b, r.attr_tables),
    "soft": lambda r, ls, b, s, o, d: tr.closest_soft_shadow_inputs(
        r.accel, o, d, ls[0].direction, cone_cos(ls[0]), 4, s, b,
        r.attr_tables),
    "psoft": lambda r, ls, b, s, o, d: tr.closest_point_soft_shadow_inputs(
        r.accel, o, d, ls[1].position, ls[1].radius, 4, s, b,
        r.attr_tables),
    "soft_multi_cone": lambda r, ls, b, s, o, d:
        tr.closest_soft_multi_shadow_inputs(
            r.accel, o, d, ("cone", ls[0].direction, cone_cos(ls[0])),
            [ls[2].direction, ls[3].direction], 4, s, b, r.attr_tables),
    "soft_multi_disk": lambda r, ls, b, s, o, d:
        tr.closest_soft_multi_shadow_inputs(
            r.accel, o, d, ("disk", ls[1].position, ls[1].radius),
            [ls[3].direction], 4, s, b, r.attr_tables),
    "any_soft": lambda r, ls, b, s, o, d: tr.any_soft_inputs(
        r.accel, o, torch.ones(o.shape[:2], dtype=torch.bool),
        ls[0].direction, cone_cos(ls[0]), 4, s, light=1),
    "any_point_soft": lambda r, ls, b, s, o, d: tr.any_point_soft_inputs(
        r.accel, o, torch.ones(o.shape[:2], dtype=torch.bool),
        ls[1].position, ls[1].radius, 4, s, light=2),
}


@pytest.mark.parametrize("walk", sorted(INPUTS))
def test_walk_scalars_from_the_block(mesh, walk):
    """A walk's scalar block (light, bias and the root box) and its seed,
    made from the block's views, equal those made from the host values
    (the float bias and the int seed), bit for bit."""
    r, lights, k, o, d = _host_and_views(mesh)
    host = INPUTS[walk](r, lights, r.config.shadow_bias,
                        frame_seed(SEED, 2), o, d)
    views = INPUTS[walk](r, k.lights, k.bias, k.seed, o, d)
    scal_h, scal_v = host[0][-1], views[0][-1]
    assert _same(scal_v, scal_h)
    if walk == "hard_dir":      # dir(3), clamped 1/dir(3), bias, the box
        assert torch.equal(scal_v[7:10], r.accel.root_min)
        assert torch.equal(scal_v[10:13], r.accel.root_max)
    if "seed" in host[1]:
        assert host[1]["seed"] == int(views[1]["seed"][0]) & 0xFFFFFFFF


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1,
                                  frame_seed(SEED, 3)])
def test_generator_takes_the_block_seed(seed):
    """The plain walks' generator keyed by the block's int32 seed view
    draws what the int seed draws."""
    bits = torch.tensor([seed - (1 << 32) if seed >= 1 << 31 else seed],
                        dtype=torch.int32)
    ray = torch.arange(3000)
    for s in (0, 5):
        a = sample_uniforms(seed, 2, ray, s)
        b = sample_uniforms(bits, 2, ray, s)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_t_max_filled_as_copied():
    """A Python t_max filled on the device equals its copy."""
    for t_max in (3.4e38, 1.0, 0.1, 7):
        assert _same(tr.t_max_tensor(t_max, "cpu"), to_device(t_max, "cpu"))


GRAPH_CASES = (
    [("static", "ray", "cuda", route, True)
     for route in ("fusedN", "fusedSM", "fused0", "unfused")]
    + [("static", "ray", "cuda:0", "fusedN", True),
       ("rebuild", "ray", "cuda", "fused0", False),
       ("rebuild", "ray", "cuda", "unfused", False),
       ("static", "raster", "cuda", "unfused", True),
       ("static", "raster_deferred", "cuda", "unfused", True),
       ("static", "raster_textured", "cuda:0", "unfused", True),
       ("rebuild", "raster", "cuda", "unfused", False),
       ("rebuild", "raster_deferred", "cuda", "unfused", False),
       ("static", "raster", "cpu", "unfused", False),
       ("static", "ray", "cpu", "fused0", False),
       ("static", "ray", "cpu", "fusedN", False),
       ("rebuild", "ray", "cpu", "fused0", False),
       ("static", "ray", "cuda", "a route of later", True)])


@pytest.mark.parametrize("mode,gbuffer,device,route,graph", GRAPH_CASES)
def test_graph_rule(mode, gbuffer, device, route, graph):
    """The static frames on the card take the graphs, whatever their
    G-buffer and route (the rule reads neither: every route takes its
    per-frame values from the block, the raster binning its camera's
    clip words too); the rebuild and the CPU stay eager."""
    assert takes_graph(mode, device) is graph


def _key(r, **over):
    parts = dict(route=r.route, config=r.config, lights=r.lights,
                 device="cuda", accel=r.accel, attr_tables=r.attr_tables,
                 shade_table=r.shade_table, mesh=r.mesh)
    parts.update(over)
    return capture_key(parts["route"], parts["config"], parts["lights"],
                       parts["device"], parts["accel"], parts["attr_tables"],
                       parts["shade_table"], parts["mesh"])


def test_capture_key(mesh):
    """The key changes with the config, the lights' count and kinds, the
    accel, its tables, the mesh and the device; not with the camera or
    the lights' values."""
    import copy
    r = _renderer(mesh, "multi")
    base = _key(r)
    assert _key(r) == base
    moved = [dataclasses.replace(l, direction=l.direction[::-1].copy(),
                                 color=l.color * 0.5, intensity=0.1)
             for l in r.lights]
    assert _key(r, lights=moved) == base
    r.camera = Camera.look_at((1.0, 2.0, 3.0), (0.0, 0.0, 0.0))
    assert _key(r) == base
    changed = {
        "config": dataclasses.replace(r.config, spp=2),
        "lights": r.lights[:2],
        "accel": copy.copy(r.accel),
        "attr_tables": tuple(t.clone() for t in r.attr_tables),
        "mesh": copy.copy(r.mesh),
        "device": "cuda:1",
    }
    for name, value in changed.items():
        assert _key(r, **{name: value}) != base, name
    kinds = [_lamp(mesh, 0.0)] + r.lights[1:]
    assert _key(r, lights=kinds) != base


@pytest.mark.parametrize("mode,route", [("static", "soft"),
                                        ("static", "multi"),
                                        ("rebuild", "soft")])
def test_cpu_frames_capture_nothing(mesh, mode, route):
    """CPU frames run eagerly: no capture, no replay, no traced frame
    marked as replayed."""
    r = _renderer(mesh, route, mode=mode)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(3):
            if mode == "rebuild":
                r.set_vertices(deform(mesh, 0.1 * (i + 1)))
            r.render_frame()
    assert r.stats["graph_captures"] == 0 == r.stats["graph_replays"]
    assert r.spans.frames == 3 and r.spans.graph_frames == 0


@pytest.mark.parametrize("route,more", [
    ("soft", {}), ("shade_table", {}),
    ("binary", dict(rebuild_splits=0, gbuffer="ray"))])
def test_cpu_rebuilds_capture_nothing(mesh, route, more):
    """A CPU rebuild runs eagerly on every route: no rebuild graph, no
    traced frame marked as having replayed one."""
    r = _renderer(mesh, route, mode="rebuild", **more)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(3):
            r.set_vertices(deform(mesh, 0.1 * (i + 1)))
            r.render_frame()
    assert r._rebuild_graph is None
    assert r.spans.frames == 3 and r.spans.rebuild_graph_frames == 0
    built = r.spans.totals.get("tpurt.rebuild.build", {"entries": 0})
    assert built["entries"] == (0 if route == "binary" else 3)


@pytest.mark.parametrize("route,mode", [
    ("soft", "static"), ("multi", "static"), ("unfused", "static"),
    ("soft", "rebuild"), ("multi", "rebuild")],
    ids=["soft", "multi", "unfused", "rebuild-soft", "rebuild-multi"])
def test_outputs_stay_after_the_next_frame(mesh, route, mode):
    """What a frame returns is not changed by later frames: soft spp 4
    with accumulation, the three-light frame, the unfused frame; in
    rebuild mode, posed frames, whose accel the next rebuild replaces."""
    r = _renderer(mesh, route, mode=mode)
    pose = (lambda i: r.set_vertices(deform(mesh, 0.2 * i))) \
        if mode == "rebuild" else (lambda i: None)
    pose(1)
    first = r.render_frame()
    kept = {k: v.clone() for k, v in first.items()}
    later = []
    for i in (2, 3):
        pose(i)
        later.append(r.render_frame())
    assert set(first) == set(kept)
    for name, v in kept.items():
        assert torch.equal(first[name], v), name
    if route == "soft":     # the next frame drew other samples
        assert not torch.equal(later[0]["shadow"], first["shadow"])


# ---------------------------------------------------------------------------
# The raster binning's camera, from the block
# ---------------------------------------------------------------------------

BW, BH = 96, 64     # the binning's frame: 3 x 2 tiles


@pytest.fixture(scope="module")
def hall():
    return sponza_scene(3000)


def _cameras(mesh):
    """The raster cells' camera (in the hall), and views of ``mesh``:
    tilted (its up off the vertical), looking straight down the y axis, a
    wide fov_y, and one from inside it, whose triangles cross the eye
    plane."""
    bmin, bmax = mesh.bounds()
    c = 0.5 * (bmin + bmax)
    d = float(np.linalg.norm(bmax - bmin))
    return {
        "cell": sponza_interior_camera(),
        "tilted": Camera.look_at(c + d * np.float32([0.3, 0.9, -0.6]), c,
                                 up=(0.35, 0.8, 0.5), fov_y_deg=48.0),
        "down_axis": Camera.look_at(c + np.float32([0.0, 1.2 * d, 0.0]), c,
                                    up=(0.0, 0.0, -1.0)),
        "wide": Camera.look_at(c + d * np.float32([-0.5, 0.2, 0.4]), c,
                               fov_y_deg=120.0),
        "inside": Camera.look_at(c + np.float32([0.01, 0.05, 0.01]),
                                 c + np.float32([1.2, 0.2, 0.4]),
                                 fov_y_deg=70.0),
    }


CAMERAS = ("cell", "tilted", "down_axis", "wide", "inside")


def _raster_cfg(**more) -> RenderConfig:
    return RenderConfig(**{"width": BW, "height": BH, "gbuffer": "raster",
                           **more})


def _copy_camera(cam: Camera) -> Camera:
    """An equal camera in new arrays."""
    return dataclasses.replace(cam, position=cam.position.copy(),
                               target=cam.target.copy(), up=cam.up.copy())


@pytest.mark.parametrize("name", CAMERAS)
def test_block_holds_the_clip_words(mesh, name):
    """A raster frame's clip words are the host's camera basis
    (``camera_basis`` on the CPU) and ``_projection``'s four scales, bit
    for bit; the resolve kernel's view of the block ends before them."""
    cam = _cameras(mesh)[name]
    k = FrameBlock(1, "cpu").write(cam, [SUN], _raster_cfg(), 3)
    proj = torch.from_numpy(np.float32(_projection(cam, BW, BH)))
    assert _same(k.camera.clip, torch.cat([*camera_basis(cam, "cpu"), proj]))
    assert k.block.shape == (fb.LIGHTS + fb.LIGHT_WORDS,)
    assert _same(k.camera.position, to_device(cam.position, "cpu"))


def test_clip_words_follow_the_camera_and_size(mesh, monkeypatch):
    """A ray-cast frame writes no clip words; a raster frame writes them
    where the camera's words or the frame size changed, and else keeps
    the last ones."""
    made = []

    def counted(cam, width, height):
        made.append((width, height))
        return clip_constants(cam, width, height)
    monkeypatch.setattr(fb, "clip_constants", counted)
    cams = _cameras(mesh)
    block = FrameBlock(1, "cpu")
    k = block.write(cams["tilted"], [SUN], RenderConfig(width=BW, height=BH),
                    0)
    assert not made and not k.camera.clip.any()
    wide = _raster_cfg(width=2 * BW)
    same = _copy_camera(cams["wide"])
    frames = [(cams["tilted"], _raster_cfg()), (cams["tilted"], _raster_cfg()),
              (cams["wide"], _raster_cfg()), (same, _raster_cfg()),
              (cams["wide"], wide), (cams["tilted"], wide),
              (cams["tilted"], wide)]
    for cam, cfg in frames:
        k = block.write(cam, [SUN], cfg, 0)
        assert _same(k.camera.clip, torch.from_numpy(
            clip_constants(cam, cfg.width, cfg.height)))
    assert made == [(BW, BH), (BW, BH), (2 * BW, BH), (2 * BW, BH)]


def _same_tensor(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.is_floating_point():
        return _same(a, b)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("fmt", ["full", "z16"])
@pytest.mark.parametrize("name", CAMERAS)
def test_binning_from_the_block(mesh, hall, name, fmt):
    """The clip transform and ``bin_rows`` fed the block camera's clip
    words equal those fed the host camera's floats, bit for bit, in every
    field; each view bins pairs."""
    m = (hall if name == "cell" else mesh).on("cpu")
    cam = _cameras(mesh)[name]
    k = FrameBlock(1, "cpu").write(cam, [SUN], _raster_cfg(), 0)
    assert _same(clip_transform(k.camera, BW, BH, m.vertices),
                 clip_transform(cam, BW, BH, m.vertices))
    cap = default_cap_rows(m.num_triangles)
    got = bin_rows(k.camera, m, BW, BH, cap, fmt=fmt)
    want = bin_rows(cam, m, BW, BH, cap, fmt=fmt)
    for f in RasterRows._fields:
        assert _same_tensor(getattr(got, f), getattr(want, f)), f
    assert int(want.pairs) > 0
    if name == "inside":
        assert int(want.big_nrows) > 0


# ---------------------------------------------------------------------------
# Captured frames with graphs that run on the CPU
# ---------------------------------------------------------------------------

class _CPUGraph:
    """A CUDA graph's stand-in: its capture runs the code as it comes,
    its replay does nothing, so a replay returns the capture's outputs."""

    def replay(self) -> None:
        pass


@contextlib.contextmanager
def _cpu_capture(graph, pool=None):
    yield


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Frames of the static mode on the CPU take the graphs, with
    ``_CPUGraph`` in the place of CUDA's."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _CPUGraph)
    monkeypatch.setattr(torch.cuda, "graph", _cpu_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    return lambda mode, device: mode == "static"


def _outline(steps):
    """A capture's steps without its graphs; and whether every graph lies
    inside a span."""
    depth, inside, out = 0, True, []
    for step in steps:
        if step[0] == "graph":
            inside = inside and depth > 0
            continue
        depth += {"open": 1, "close": -1}.get(step[0], 0)
        out.append(step[:2])
    return out, inside


def _stage(name, *inner):
    return [("open", name), *inner, ("close", name)]


RASTER_OUTLINE = (
    _stage("tpurt.gbuffer",
           *_stage("tpurt.gbuffer.bin", ("count", "raster_pairs")),
           *_stage("tpurt.gbuffer.raster"))
    + _stage("tpurt.gbuffer")
    + _stage("tpurt.shadow", ("count", "shadow_rays"),
             *_stage("tpurt.walk"))
    + _stage("tpurt.composite"))
RESOLVED_STAGES = ("tpurt.order", "tpurt.rays", "tpurt.walk",
                   "tpurt.gbuffer", "tpurt.shadow", "tpurt.composite")


@pytest.mark.parametrize("route", ["raster", "raster_deferred", "hard",
                                   "unfused"])
def test_traced_replays_keep_spans_and_counters(mesh, cpu_graphs, route):
    """Two traced frames of each Renderer, after one untraced: the one
    that takes the graphs captures on the first traced frame and replays
    on both; its spans (entries, and each parent's self ms its device ms
    less its children's), counters and host reads are the eager twin's,
    and so are the capture frame's outputs. The capture nests its stages
    as the eager frame does: the raster frames' binning and rasterizer
    inside ``tpurt.gbuffer`` and their walk inside ``tpurt.shadow`` (each
    light's, unfused); a resolving frame's six stages each one graph, as
    before."""
    graph, eager = _renderer(mesh, route), _renderer(mesh, route)
    outs = {}
    for name, r in (("graph", graph), ("eager", eager)):
        with pytest.MonkeyPatch.context() as mp:
            if name == "graph":
                mp.setattr(app, "takes_graph", cpu_graphs)
            r.render_frame()
            with profile(activities=[ProfilerActivity.CPU]):
                outs[name] = [r.render_frame() for _ in range(2)]
    assert graph.stats["graph_captures"] == 1
    assert graph.stats["graph_replays"] == 2
    assert eager.stats["graph_replays"] == 0
    sg, se = graph.spans, eager.spans
    assert sg.graph_frames == 2 and se.graph_frames == 0
    assert sg.syncs == se.syncs == 2
    assert sg.counts == se.counts
    tg, te = sg.totals, se.totals
    assert {k: v["entries"] for k, v in tg.items()} == \
        {k: v["entries"] for k, v in te.items()}
    children = {"tpurt.gbuffer": ("tpurt.gbuffer.bin",
                                  "tpurt.gbuffer.raster"),
                "tpurt.shadow": ("tpurt.walk",)}
    for parent, kids in children.items():
        if route.startswith("raster"):      # every walk is a shadow walk
            inner = sum(tg[k]["device_ms"] for k in kids)
            assert tg[parent]["self_ms"] == pytest.approx(
                tg[parent]["device_ms"] - inner), parent
    # The capture's frame (the stand-in's replays compute nothing, so a
    # later frame's samples are not drawn).
    a, b = outs["graph"][0], outs["eager"][0]
    assert set(a) == set(b)
    for k in b:
        assert _same_tensor(a[k], b[k]), k
    outline, inside = _outline(graph._graphs.steps)
    assert inside
    if route == "raster":
        assert outline == RASTER_OUTLINE
        assert sg.counts["raster_pairs"] > 0 and sg.counts["shadow_rays"] > 0
    elif route == "raster_deferred":     # three lights, one walk each
        assert outline[:10] == RASTER_OUTLINE[:10]
        assert outline[9:-2] == RASTER_OUTLINE[9:-2] * 3
    elif route == "hard":
        assert graph._graphs.steps and [s[0] for s in graph._graphs.steps] \
            == ["open", "graph", "close"] * len(RESOLVED_STAGES)
        assert outline == [x for n in RESOLVED_STAGES for x in _stage(n)]
        assert sg.counts == {}
    else:
        assert outline.count(("open", "tpurt.walk")) == 4   # camera + 3
        assert outline.count(("count", "shadow_rays")) == 3
