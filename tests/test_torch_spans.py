"""The stage spans and the host-sync count inside ``Renderer.render_frame``
(``tpurt_torch/spans.py``), on the CPU at a small size: tracing is off
without a recording profiler and leaves no trace; under ``torch.profiler``
every stage appears in the profiler's events inside ``tpurt.frame`` and is
folded into ``Renderer.spans``; the frame's host syncs are counted;
``stats`` keeps its set-up keys and ``build_ms``, beside the CUDA graphs'
counters."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_native import ensure_native_libraries  # noqa: E402

from tpurt_torch import spans as S  # noqa: E402
from tpurt_torch.app import Renderer  # noqa: E402
from tpurt_torch.scenes import default_camera_for, deform, teapot_scene  # noqa: E402,E501
from tpurt_torch.types import Light, RenderConfig  # noqa: E402

ensure_native_libraries()

W, H = 48, 32
FRAMES = 3
STATIC = {"tpurt.frame", "tpurt.order", "tpurt.rays", "tpurt.walk",
          "tpurt.gbuffer", "tpurt.shadow", "tpurt.composite", "tpurt.read"}
REBUILD = STATIC | {"tpurt.rebuild", "tpurt.rebuild.build",
                    "tpurt.rebuild.collapse", "tpurt.rebuild.tables",
                    "tpurt.rebuild.count_read"}
STAGES = ("tpurt.order", "tpurt.rays", "tpurt.walk", "tpurt.gbuffer",
          "tpurt.shadow", "tpurt.composite")
OUT_KEYS = ("image", "shadow", "t", "tri_id", "valid", "normal", "albedo")


@pytest.fixture(scope="module")
def mesh():
    return teapot_scene(1200)


def _renderer(mesh, mode="static", **fields):
    cfg = dict(width=W, height=H, leaf_size=8, spp=4, accumulate=True)
    cfg.update(fields)
    return Renderer(mesh, default_camera_for(mesh),
                    Light.sun((0.45, 0.8, 0.3), angular_radius_deg=4.0),
                    RenderConfig(**cfg), mode=mode, device="cpu")


def _frames(r, mesh, n, traced):
    """n frames (posed first in rebuild mode), under a recording profiler
    where ``traced`` -> (outputs, the profiler or None)."""
    def run():
        outs = []
        for i in range(n):
            if r.mode == "rebuild":
                r.set_vertices(deform(mesh, 0.1 * (i + 1)))
            out = r.render_frame()
            outs.append({k: out[k].clone() for k in OUT_KEYS})
        return outs
    if not traced:
        return run(), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = run()
    return outs, prof


@pytest.fixture(scope="module")
def static_runs(mesh):
    """A static Renderer's frames with tracing off, its twin's under the
    profiler."""
    off = _renderer(mesh)
    on = _renderer(mesh)
    return dict(off=off, on=on, off_out=_frames(off, mesh, FRAMES, False)[0],
                **dict(zip(("on_out", "prof"),
                           _frames(on, mesh, FRAMES, True))))


@pytest.fixture(scope="module")
def rebuild_runs(mesh):
    off = _renderer(mesh, "rebuild", spp=1, accumulate=False)
    on = _renderer(mesh, "rebuild", spp=1, accumulate=False)
    off_out, _ = _frames(off, mesh, 2, False)
    on_out, prof = _frames(on, mesh, 2, True)
    return dict(off=off, on=on, off_out=off_out, on_out=on_out, prof=prof)


def test_tracing_off_records_nothing(mesh, monkeypatch):
    """Without a profiler no span is made, no record_function opened, no
    CUDA event or clock read taken, and ``spans`` stays empty."""
    def refuse(*a, **k):
        raise AssertionError("tracing work with tracing off")
    r = _renderer(mesh)
    monkeypatch.setattr(S, "_Span", refuse)
    monkeypatch.setattr(S, "_Frame", refuse)
    monkeypatch.setattr(S, "Stopwatch", refuse)
    monkeypatch.setattr(S, "time", SimpleNamespace(perf_counter=refuse))
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    for _ in range(FRAMES):
        r.render_frame()
    monkeypatch.undo()
    assert r.spans.frames == 0 and r.spans.totals == {}
    assert r.spans.syncs == 0 and r.spans.pool == []


@pytest.mark.parametrize("runs", ["static_runs", "rebuild_runs"])
def test_outputs_equal_with_tracing_on_and_off(runs, request):
    got = request.getfixturevalue(runs)
    assert got["off"].spans.frames == 0
    for a, b in zip(got["off_out"], got["on_out"]):
        for k in OUT_KEYS:
            assert torch.equal(a[k], b[k]), k


def _spans(prof):
    """The profiler's ``tpurt.*`` events as (name, start ns, end ns), read
    from its raw results."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("tpurt.")]


def _parent(span, spans):
    """The innermost other span around ``span``."""
    around = [s for s in spans if s is not span
              and s[1] <= span[1] and span[2] <= s[2]]
    return min(around, key=lambda s: s[2] - s[1])[0] if around else None


@pytest.mark.parametrize("runs,names,n", [("static_runs", STATIC, FRAMES),
                                          ("rebuild_runs", REBUILD, 2)])
def test_spans_nest_in_the_frame(runs, names, n, request):
    """Every span of the frame is in the profiler's events, inside
    ``tpurt.frame`` (the rebuild's parts inside ``tpurt.rebuild``), at
    least once a frame; ``Renderer.spans`` has the same names and counts
    the frames."""
    got = request.getfixturevalue(runs)
    spans = _spans(got["prof"])
    seen = {}
    for s in spans:
        seen[s[0]] = seen.get(s[0], 0) + 1
        parent = _parent(s, spans)
        if s[0] == "tpurt.frame":
            assert parent is None
        elif s[0].startswith("tpurt.rebuild."):
            assert parent == "tpurt.rebuild", s[0]
        else:
            assert parent == "tpurt.frame", s[0]
    assert set(seen) == names
    assert seen["tpurt.frame"] == n and min(seen.values()) >= n
    sp = got["on"].spans
    assert sp.frames == n
    totals = sp.totals
    assert set(totals) == names
    assert all(totals[k]["entries"] == seen[k] for k in names)


@pytest.mark.parametrize("runs", ["static_runs", "rebuild_runs"])
def test_stage_times_fit_in_the_frame(runs, request):
    got = request.getfixturevalue(runs)
    sp = got["on"].spans
    totals = sp.totals
    frame = totals["tpurt.frame"]
    stages = [sp.per_frame(k) for k in STAGES]
    assert all(v > 0 for v in stages)
    assert all(totals[k]["host_ms"] > 0 for k in totals)
    children = sum(totals[k]["device_ms"] for k in totals
                   if k != "tpurt.frame" and "." not in k[6:])
    assert children <= frame["device_ms"]
    assert frame["self_ms"] == pytest.approx(frame["device_ms"] - children)
    assert sum(stages) <= sp.per_frame("tpurt.frame", "device_ms")
    if "tpurt.rebuild" in totals:
        parts = sum(totals[k]["device_ms"] for k in totals
                    if k.startswith("tpurt.rebuild."))
        assert parts <= totals["tpurt.rebuild"]["device_ms"]


@pytest.mark.parametrize("runs,syncs", [("static_runs", 1),
                                        ("rebuild_runs", 2)])
def test_host_syncs_a_frame(runs, syncs, request):
    """On the CPU the frame's host reads: the walk flags, and after
    ``set_vertices`` the rebuild's wide-node count."""
    sp = request.getfixturevalue(runs)["on"].spans
    assert sp.syncs == syncs * sp.frames


def test_unfused_frame_spans(mesh):
    """The unfused G-buffer's own rays, walk and decode, and the shadow
    pass, are the same stages."""
    r = _renderer(mesh, fused_shadow=False, spp=1, accumulate=False)
    assert r.route == "unfused"
    _frames(r, mesh, 1, True)
    assert set(r.spans.totals) == STATIC
    assert r.spans.syncs == 1


def test_build_ms_on_every_rebuild_frame(mesh):
    r = _renderer(mesh, "rebuild", spp=1, accumulate=False)
    for i in range(2):
        r.stats.pop("build_ms", None)
        r.set_vertices(deform(mesh, 0.2 * i))
        r.render_frame()
        assert r.stats["build_ms"] > 0
    assert r.spans.frames == 0


GRAPH_KEYS = {"graph_captures", "graph_replays"}


@pytest.mark.parametrize("runs,keys", [
    ("static_runs", {"raster_cap_growths", "sah_build_ms", "collapse_ms",
                     "attr_rows_ms"} | GRAPH_KEYS),
    ("rebuild_runs", {"raster_cap_growths", "build_and_count_ms",
                      "collapse_ms", "overflow_recoveries", "attr_rows_ms",
                      "build_ms"} | GRAPH_KEYS)])
def test_stats_keys_unchanged(runs, keys, request):
    got = request.getfixturevalue(runs)
    assert set(got["off"].stats) == keys == set(got["on"].stats)
