"""The per-frame rebuild as one CUDA graph (``tpurt_torch/graphs.py``
``RebuildGraph``, ``Renderer._rebuild_step``) and the pose buffers it
reads (``Renderer.set_vertices``).

On the CPU: which rebuilds take the graph is a pure function of (mode,
device); the capture key follows the pad, the rebuild's route, the
device and the pose buffers' identity, and not the pose's values;
``set_vertices`` copies the pose into the Renderer's own vertex buffer
(a later change to the caller's array or tensor leaves the frame as it
is), the normals follow at the next rebuild, and a pose of another shape
raises; ``rebuild_graph_share`` reads the program's counter.

The tests marked ``cuda`` need an NVIDIA card and skip elsewhere (run them
there with ``python -m pytest --noconftest -m cuda
tests/test_torch_rebuild_graph.py``): over four poses, on every rebuild
route, the replayed rebuild (wide or packed rows, leaf rows, ``tri_id``,
attribute rows or shade table, count) and the frame (image, shadow, t,
tri_id, valid) equal the eager rebuild of the same vertices and normals
and its frame, bit for bit; the replayed normals lie within 1e-6 of
``smooth_normals_device`` of the pose; a frame's outputs stay after the
next frames; a pose that outgrows the pad recovers and the graph is
captured again at the new pad; a change to the caller's pose tensor
after ``set_vertices`` leaves the frame as it was; traced replays count
as such, keep two host syncs a frame and the count read's span, record
no inner build spans, and count the build kernels' launches.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpurt_torch.app as app
import tpurt_torch.kernels.build as B
from tpurt_torch.app import Renderer, frame_seed, render_frame_fn
from tpurt_torch.bvh.wide import round_up_bucket
from tpurt_torch.graphs import rebuild_key, rebuild_takes_graph
from tpurt_torch.passes.shading import smooth_normals_device
from tpurt_torch.scenes import (default_camera_for, deform, sponza_scene,
                                sponza_interior_camera, teapot_scene)
from tpurt_torch.types import Light, RenderConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
W, H = 48, 32
SEED = 2 ** 31 + 6151
SUN = Light.directional((0.45, 0.8, 0.3))
OUTPUTS = ("image", "shadow", "t", "tri_id", "valid")

# name -> the config fields of one rebuild route
ROUTES = {
    "area": {},
    "fixed": dict(rebuild_collapse="fixed"),
    "shade_table": dict(inkernel_attrs=False),
    "top_sah": dict(top_sah=True, rebuild_splits=0, gbuffer="ray"),
    "binary": dict(bvh_width=2, rebuild_splits=0, gbuffer="ray"),
    "raster_deferred": dict(rebuild_splits=0, gbuffer="raster",
                            raster_deferred=True),
}


@pytest.fixture(scope="module")
def teapot():
    return teapot_scene(1200)


def _renderer(mesh, device="cpu", camera=None, **fields):
    cfg = RenderConfig(width=W, height=H, leaf_size=8, seed=SEED, **fields)
    return Renderer(mesh, camera or default_camera_for(mesh), [SUN], cfg,
                    mode="rebuild", device=device)


def _poses(mesh, n=4):
    return [deform(mesh, 0.15 * (i + 1)) for i in range(n)]


def _reader(name: str):
    path = ROOT / "bench_torch" / "metrics" / name / "read.py"
    spec = importlib.util.spec_from_file_location(f"rebuild_graph_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _share(renderer):
    ctx = SimpleNamespace(cell=SimpleNamespace(renderer=renderer))
    return _reader("rebuild_graph_share").read(ctx)


def _traced(r, poses):
    with profile(activities=[ProfilerActivity.CPU]):
        for p in poses:
            r.set_vertices(p)
            r.render_frame()
    return r


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,device,graph", [
    ("rebuild", "cuda", True), ("rebuild", "cuda:0", True),
    ("rebuild", torch.device("cuda", 1), True), ("rebuild", "cpu", False),
    ("static", "cuda", False), ("static", "cpu", False),
    ("refit", "cuda", False)])
def test_rebuild_graph_rule(mode, device, graph):
    """Rebuild mode on the card replays its rebuild, whatever the route
    (the rule reads none); the CPU and the other modes do not."""
    assert rebuild_takes_graph(mode, device) is graph


ROUTE = (False, "area", "attr", False, 40, 8, True)


def test_rebuild_key():
    """The key changes with the pad, each part of the route, the device
    and the identity of each object it holds; two keys of the same parts
    are equal."""
    objects = (object(), torch.zeros(3), torch.zeros(3))
    base = rebuild_key(1024, ROUTE, "cuda", *objects)
    assert rebuild_key(1024, ROUTE, "cuda:1", *objects) != base
    assert rebuild_key(1024, tuple(ROUTE), torch.device("cuda"),
                       *objects) == base
    assert rebuild_key(2048, ROUTE, "cuda", *objects) != base
    others = (True, "fixed", "st", True, 0, 14, False)
    for i, value in enumerate(others):
        route = ROUTE[:i] + (value,) + ROUTE[i + 1:]
        assert rebuild_key(1024, route, "cuda", *objects) != base, i
    for i in range(len(objects)):
        swapped = objects[:i] + (torch.zeros(3),) + objects[i + 1:]
        assert rebuild_key(1024, ROUTE, "cuda", *swapped) != base, i


def test_set_vertices_copies_the_pose(teapot):
    """The pose is copied into the Renderer's vertex buffer, which keeps
    its identity; changing the caller's tensor afterwards leaves the frame
    equal to one of the unchanged pose; the normals buffer holds the
    pose's normals after the frame; a pose of another shape raises."""
    r = _renderer(teapot)
    fresh = _renderer(teapot)
    buffers = (r.mesh.vertices, r.mesh.normals)
    for p in _poses(teapot, 2):
        pose = torch.from_numpy(p.copy())
        r.set_vertices(pose)
        pose.add_(0.5)
        got = r.render_frame()
        fresh.set_vertices(p)
        want = fresh.render_frame()
        assert r.mesh.vertices is buffers[0]
        assert r.mesh.normals is buffers[1]
        assert torch.equal(r.mesh.vertices, torch.from_numpy(p))
        assert torch.equal(r.mesh.normals, smooth_normals_device(
            torch.from_numpy(p), r.mesh.indices))
        for k in OUTPUTS:
            assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="shape"):
        r.set_vertices(p[:-1])


def test_share_reads_the_programs_counter(teapot):
    """rebuild_graph_share: 0 on traced CPU rebuilds, None without traced
    frames and where the program keeps no such counter."""
    r = _renderer(teapot)
    assert _share(r) is None
    _traced(r, _poses(teapot, 2))
    assert r.spans.frames == 2 and _share(r) == 0.0
    older = SimpleNamespace(spans=SimpleNamespace(frames=2))
    assert _share(older) is None
    assert _share(SimpleNamespace()) is None


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _eager(r):
    """The Renderer's rebuild run eagerly on its pose buffers as they
    are -> (bvh, accel, table, count or None)."""
    m = r.mesh
    if r._binary:
        return app._rebuild_binary(m.vertices, m.indices, m,
                                   r.config.leaf_size, tables=r._tables,
                                   top_sah=r._top_sah) + (None,)
    return app._rebuild_fused(m.vertices, m.indices, m, r.config.leaf_size,
                              r._nw_pad, split_blocks=r._rebuild_splits,
                              tables=r._tables,
                              collapse=r.config.rebuild_collapse,
                              top_sah=r._top_sah)


TABLE_ARGS = {"attr": "attr_tables", "st": "shade_table",
              "sto": "shade_table_orig"}


def _table(r):
    """The table the Renderer's frames read, None on the raster G-buffer
    without one."""
    return getattr(r, TABLE_ARGS[r._tables]) if r._tables else None


def _same(a, b, what):
    if isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _same(x, y, f"{what}[{i}]")
        return
    assert (a is None) == (b is None), what
    if a is not None:
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b), what


def _check_against_eager(r, out, index):
    """The Renderer's accel, table and count, and its frame ``out``
    (rendered as frame ``index``), against the eager rebuild of its pose
    buffers and that rebuild's frame."""
    _, accel, table, count = _eager(r)
    for f in ("nodes", "tris", "tri_id"):
        _same(getattr(r.accel, f), getattr(accel, f), f)
    _same(_table(r), table, "table")
    g = r._rebuild_graph
    if count is not None and g.captured:
        _same(g.out[3], count, "count")
    want = render_frame_fn(accel, r.mesh, r.camera, r.lights, r.config,
                           seed=frame_seed(r.config.seed, index),
                           **({TABLE_ARGS[r._tables]: table}
                              if r._tables else {}))
    for k in OUTPUTS:
        _same(out[k], want[k], k)


@pytest.mark.cuda
@pytest.mark.parametrize("scene,route", [
    ("teapot", name) for name in ROUTES] + [("hall", "area")])
def test_replayed_rebuild_equals_eager(card, teapot, scene, route):
    """Four poses: the first rebuild of the key runs eagerly, the second
    captures, every one equals the eager rebuild of the same buffers, and
    so does its frame."""
    mesh = teapot if scene == "teapot" else sponza_scene(20_000)
    cam = None if scene == "teapot" else sponza_interior_camera()
    r = _renderer(mesh, card, cam, **ROUTES[route])
    for i, p in enumerate(_poses(mesh)):
        r.set_vertices(p)
        index = r.frame_index
        out = r.render_frame()
        assert r._rebuild_graph.captured == (i > 0)
        _check_against_eager(r, out, index)
    assert r.stats.get("overflow_recoveries", 0) == 0


@pytest.mark.cuda
def test_replayed_normals_follow_the_pose(card, teapot):
    r = _renderer(teapot, card)
    for p in _poses(teapot):
        r.set_vertices(p)
        r.render_frame()
        want = smooth_normals_device(torch.as_tensor(p, device=card),
                                     r.mesh.indices)
        assert float((r.mesh.normals - want).abs().max()) <= 1e-6
    assert r._rebuild_graph.captured


@pytest.mark.cuda
def test_outputs_stay_after_the_next_frame(card, teapot):
    """A replay writes the accel in place; the frames' outputs are their
    own."""
    r = _renderer(teapot, card)
    outs, kept = [], []
    for p in _poses(teapot):
        r.set_vertices(p)
        outs.append(r.render_frame())
        kept.append({k: v.clone() for k, v in outs[-1].items()})
    assert r._rebuild_graph.captured
    for out, copy in zip(outs, kept):
        for k, v in copy.items():
            assert torch.equal(out[k], v), k
    assert not torch.equal(outs[-1]["image"], outs[-2]["image"])


def _count(r, pose, card) -> int:
    v = torch.as_tensor(pose, device=card)
    _, _, _, count = app._rebuild_fused(
        v, r.mesh.indices, r.mesh, r.config.leaf_size, 4 * r._nw_pad,
        split_blocks=r._rebuild_splits, tables=None)
    return int(count)


@pytest.mark.cuda
def test_overflow_recaptures_at_the_new_pad(card, teapot):
    """A pad that fits one pose exactly: its rebuild is captured; a pose
    with more wide nodes overflows the replay, the pad is recounted, the
    frame rebuilt eagerly at it, the graph captured again at the new pad
    on the next frame, and every frame equals the eager one."""
    r = _renderer(teapot, card)
    rng = np.random.default_rng(5)
    v = np.asarray(teapot.vertices, np.float32)
    candidates = _poses(teapot, 8) + [
        (v + rng.normal(0.0, 0.05, v.shape)).astype(np.float32)]
    counts = [_count(r, p, card) for p in candidates]
    low = candidates[int(np.argmin(counts))]
    high = candidates[int(np.argmax(counts))]
    assert max(counts) > min(counts), counts
    r._nw_pad = min(counts)
    for _ in range(3):
        r.set_vertices(low)
        index = r.frame_index
        _check_against_eager(r, r.render_frame(), index)
    assert r._rebuild_graph.captured and r._rebuild_graph.key[0] == min(
        counts) and r.stats["overflow_recoveries"] == 0
    r.set_vertices(high)
    index = r.frame_index
    out = r.render_frame()
    assert r.stats["overflow_recoveries"] == 1
    assert r._nw_pad == round_up_bucket(r._nw_pad) >= max(counts)
    g = r._rebuild_graph
    assert g.key[0] == r._nw_pad and g.warm and not g.captured
    _check_against_eager(r, out, index)
    for p in (high, low):
        r.set_vertices(p)
        index = r.frame_index
        _check_against_eager(r, r.render_frame(), index)
        assert r._rebuild_graph is g and g.captured
    assert r.stats["overflow_recoveries"] == 1


@pytest.mark.cuda
def test_changed_pose_tensor_leaves_the_frame(card, teapot):
    """The caller's pose tensor, changed on the device after
    ``set_vertices``, changes neither the buffer nor the replayed
    frame."""
    r = _renderer(teapot, card)
    for p in _poses(teapot):
        pose = torch.as_tensor(p, device=card)
        r.set_vertices(pose)
        pose.mul_(2.0).add_(1.0)
        index = r.frame_index
        out = r.render_frame()
        assert torch.equal(r.mesh.vertices, torch.as_tensor(p, device=card))
        _check_against_eager(r, out, index)
    assert r._rebuild_graph.captured


@pytest.mark.cuda
def test_traced_replays(card, teapot):
    """Four traced posed frames: three replay the rebuild (the second
    captures, then replays); each keeps its two host reads and its
    count read's span; the inner build spans record the eager frame
    alone; every frame counts one launch of each build kernel."""
    r = _renderer(teapot, card)
    kernels = (B.morton_codes_cuda, B.topology_cuda, B.collapse_area_cuda)
    before = [fn.launches for fn in kernels]
    _traced(r, _poses(teapot))
    torch.cuda.synchronize()
    sp = r.spans
    assert sp.frames == 4 and sp.rebuild_graph_frames == 3
    assert sp.syncs == 8 and _share(r) == 75.0
    totals = sp.totals
    for name in ("build", "collapse", "tables"):
        assert totals[f"tpurt.rebuild.{name}"]["entries"] == 1, name
    for name in ("tpurt.rebuild", "tpurt.rebuild.count_read"):
        assert totals[name]["entries"] == 4, name
    assert [fn.launches - n for fn, n in zip(kernels, before)] == [4] * 3
    assert r.stats["build_ms"] > 0
