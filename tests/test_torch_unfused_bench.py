"""The benchmark's unfused ray-cast cell, ``hall_unfused.sun_soft_spp8_1080p``:
its configuration against ``hall_static``'s, the route the Renderer takes
for it (the closest-hit attribute walk for the G-buffer, the origins of the
sun's shadow rays straight from its packets, the in-kernel cone sampler,
the resolve of the frame from both walks' packets:
``app.resolves_unfused``), the cell through the harness on the CPU
at a tiny size (correct, its control not, the traced run's layers), the
readers of the G-buffer walk (``bench_torch/metrics/closest_ms``,
``closest_roofline``) and of the shadow pass on a traced frame of the
cell, the closest walk's count (``bench_torch/closestcount.py``) against
``bench_torch/workcount.py``'s count of the whole frame, and the frame's
spans, ``shadow_rays`` counter and resolved frames on an eager frame and
on a replay (CUDA graphs stood in for by graphs that run their code when
captured, the resolve kernel by its plain version, which counts a launch
and records the frame as the kernel does).

The test marked ``cuda`` needs an NVIDIA card and skips elsewhere (run it
there with ``python -m pytest --noconftest -m cuda
tests/test_torch_unfused_bench.py``): the cell's frame at 1920x1080, spp
8, replayed from its CUDA graphs equal to the eager frame bit for bit on
successive frames, its counter and its walk counters.
"""

import contextlib
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
from test_torch_native import ensure_native_libraries  # noqa: E402

import tpurt_torch.app as app  # noqa: E402
import tpurt_torch.kernels.resolve as rs  # noqa: E402
import tpurt_torch.kernels.traverse as tr  # noqa: E402
from bench_torch import (closestcount, harness, shadowcount,  # noqa: E402
                         workcount)
from tpurt_torch.app import Renderer  # noqa: E402

torch.set_num_threads(1)
ensure_native_libraries()

CELL = "hall_unfused.sun_soft_spp8_1080p"
FRAMES = 2
SEED = 2 ** 31 + 23_023
TINY = dict(tris_target=3000, width=64, height=36, check_pixels=384,
            warmup_frames=1, trace_frames=FRAMES)
SPP = 8
# The walk kernels as the profiler names them on the card: the closest-hit
# attribute walk (mode CLOSEST, 5, attrs 1 and 2), SOFT's fused walk (2),
# the cone sampler of csrc/shadow_rays.cu (mode ANY_SOFT, 1) and NEAREST
# (6).
CLOSEST_NAME = "void fused_shadows_kernel<5, 1>(Params)"
KERNEL_NAMES = {CLOSEST_NAME: True,
                "void fused_shadows_kernel<5, 2>(Params)": True,
                "void fused_shadows_kernel<2, 1>(Params)": False,
                "void fused_shadows_kernel<6, 0>(Params)": False,
                "void shadow_rays_kernel<1>(Params)": False}
# A traced frame's stand-in kernels, in seconds over the FRAMES frames.
KERNELS = [(CLOSEST_NAME, 8e-4), ("void shadow_rays_kernel<1>(Params)",
                                  1.6e-3)]
READERS = ("closest_ms", "closest_roofline", "shadow_mrays",
           "shadow_roofline", "walk_roofline")
# The entries of each stage span a frame: the G-buffer's walk and the
# sampler's; the origins from the walk's packets, then the resolve.
STAGES = {"tpurt.order": 1, "tpurt.rays": 1, "tpurt.walk": 2,
          "tpurt.gbuffer": 2, "tpurt.shadow": 1}


def _run(trace=False, control=False):
    return harness.run(CELL, SEED, 0.3, trace, t_start=time.perf_counter(),
                       device="cpu", control=control, overrides=TINY)


@pytest.mark.parametrize("key", ["scene", "camera", "mode", "render",
                                 "precision"])
def test_unfused_config_is_hall_static_but_the_route(key):
    """The configuration is ``hall_static``'s deployment letter for
    letter, but the fused shadow turned off and the ray-cast G-buffer
    written out; the frames come with the fused spp-8 cell's traffic."""
    cell = harness.find_cell(CELL)
    fused = harness.find_cell("hall_static.sun_soft_spp8_1080p")
    want = dict(fused.config[key]) if key == "render" else fused.config[key]
    if key == "render":
        assert (want["fused_shadow"], want["gbuffer"]) == (True, "auto")
        want.update(fused_shadow=False, gbuffer="ray")
    assert cell.config[key] == want
    assert cell.traffic == fused.traffic
    assert cell.config["name"] != fused.config["name"]
    assert cell.config["source"] != fused.config["source"]
    assert cell.chips == 1


def _stand_in_resolve_kernel(mp) -> None:
    """The resolve kernel's stand-in on the CPU: its plain version, which
    counts a launch and records the frame, as the kernel does."""
    plain = rs.frame_resolve_reference

    def kernel(*args):
        rs.frame_resolve_cuda.launches += 1
        rs.resolve_frame()
        return plain(*args)
    mp.setattr(rs, "frame_resolve_reference", kernel)


@pytest.fixture(scope="module")
def cell():
    """The cell at the tiny size on the CPU, one frame warm, then FRAMES
    traced with the resolve kernel stood in for; the last traced frame's
    outputs kept."""
    c = harness.Cell(harness.find_cell(CELL), SEED, "cpu", TINY)
    c.step()
    with pytest.MonkeyPatch.context() as mp:
        _stand_in_resolve_kernel(mp)
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(FRAMES):
                out = c.step()
    c.out = out
    return c


def test_renderer_takes_the_unfused_route(cell, monkeypatch):
    """The unfused route on the SBVH, resolved from its walks' packets:
    the G-buffer from the closest-hit attribute walk (CLOSEST, attrs=1),
    the sun's shadow origins from its packets, the sun from the in-kernel
    cone sampler (ANY_SOFT), every output from the resolve, and nothing
    else walked."""
    r = cell.renderer
    assert r.route == "unfused" and r.config.gbuffer == "ray"
    assert not r.config.fused_shadow and r.attr_tables is not None
    assert isinstance(r.accel, app.WideBVH)
    assert not app.resolves(r.route, r.attr_tables, r.mesh, len(r.lights))
    assert app.resolves_unfused(r.route, r.config, r.accel, r.attr_tables,
                                r.mesh, r.lights)
    assert r.spans.resolve_frames == FRAMES and r.spans.frames == FRAMES
    picked = []
    pick = tr._pick

    def spy(device, kernel, plain):
        picked.append(kernel.__name__)
        return pick(device, kernel, plain)
    for module in (tr, rs):
        monkeypatch.setattr(module, "_pick", spy)
    r.render_frame()
    assert picked == ["closest_attrs_cuda", "unfused_origins_cuda",
                      "any_soft_cuda", "frame_resolve_cuda"]


def test_unfused_cell_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1


def test_unfused_cell_control_is_not_correct():
    """The reference in bfloat16 in the program's place fails; the
    program's own numbers on the same frames and pixels pass."""
    res = _run(control=True)
    assert not res["correct"], res["checks"]
    limits = harness.find_cell(CELL).limits
    program = res["_info"]["program"]
    assert all(program[k] <= limits[k] for k in harness.CHECKS), program


def test_unfused_traced_run_reads_its_layers():
    """The spans and the unfused pass's counter read on the CPU; the
    device-trace readers read CUDA kernels, which a CPU trace has not."""
    res = _run(trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert {"order_ms", "rays_ms", "walk_ms", "gbuffer_ms", "shadow_ms",
            "composite_ms", "shadow_mrays"} <= set(m)
    assert not {"closest_ms", "closest_roofline", "shadow_roofline"} & set(m)
    assert m["host_syncs_per_frame"]["value"] == 1.0
    assert m["resolve_frame_share"]["value"] == 0.0
    assert m["shadow_mrays"]["value"] * 1e6 \
        == res["_info"]["shadow_rays_per_frame"] > 0


def _ctx(c, kernels):
    return SimpleNamespace(cell=c, trace=SimpleNamespace(
        frames=FRAMES, kernels=kernels),
        last_frame_index=c.renderer.frame_index - 1)


def _read(name, ctx):
    return harness._load_reader(str(ROOT / "bench_torch"), name)(ctx)


def test_readers_read_a_traced_frame_of_the_cell(cell):
    """Each of the cell's walk readers reads the traced frames, under 100%
    where it is a share; ``closest_ms`` the closest walk alone, and
    ``closest_roofline`` the count over it."""
    ctx = _ctx(cell, KERNELS)
    values = {name: _read(name, ctx) for name in READERS}
    assert all(v is not None and v > 0 for v in values.values()), values
    assert all(values[n] <= 100.0 for n in READERS if "roofline" in n)
    assert values["closest_ms"] == pytest.approx(KERNELS[0][1] * 1e3 / FRAMES)
    work = closestcount.frame_closest_work(cell)
    assert values["closest_roofline"] == pytest.approx(
        100.0 * work["bound_ms"] / values["closest_ms"])
    assert values["shadow_mrays"] * 1e6 \
        == int(cell.out["valid"].sum()) * SPP
    assert _read("closest_ms", _ctx(cell, KERNELS[1:])) is None
    assert _read("closest_roofline", _ctx(cell, KERNELS[1:])) is None


@pytest.mark.parametrize("name", list(KERNEL_NAMES))
def test_closest_ms_picks_the_closest_attribute_walk(name):
    assert bool(closestcount.KERNELS.search(name)) == KERNEL_NAMES[name]
    trace = SimpleNamespace(frames=2, kernels=[(name, 1e-3)])
    assert closestcount.closest_seconds(trace) == (
        1e-3 if KERNEL_NAMES[name] else 0)


@pytest.mark.parametrize("key", ["pops", "slab_tests", "tris"])
def test_closest_count_and_shadow_count_make_the_frame_count(cell, key):
    """``closestcount``'s pops, slab tests and triangle tests are the
    closest part of ``workcount.frame_work`` (the part ``shadowcount``
    keeps apart), and with ``shadowcount``'s any-hit walks they make its
    whole frame."""
    i = cell.renderer.frame_index - 1
    whole = workcount.frame_work(cell, i)
    shadow = shadowcount.frame_shadow_work(cell, i)
    closest = closestcount.frame_closest_work(cell)
    assert closest["rays"] == cell.view["width"] * cell.view["height"]
    if key == "tris":
        assert closest["closest_tris"] == whole["closest_tris"] \
            == shadow["closest"]["closest_tris"] > 0
        assert shadow["anyhit_tris"] == whole["anyhit_tris"] > 0
    else:
        assert closest[key] == shadow["closest"][key] > 0
        assert closest[key] + shadow[key] == whole[key]
    assert closest["ops"] + shadow["ops"] == whole["ops"]
    assert closest["bytes"] > 0 and closest["bound_ms"] > 0


class _CPUGraph:
    """A CUDA graph's stand-in: its capture runs the code as it comes,
    its replay does nothing, so a replay returns the capture's outputs."""

    def replay(self) -> None:
        pass


@contextlib.contextmanager
def _cpu_capture(graph, pool=None):
    yield


def _cell_renderer(c, mp, replay):
    """A second Renderer of the tiny cell; with ``replay`` its static
    frames take the graphs on the CPU, with ``_CPUGraph`` in the place
    of CUDA's."""
    if replay:
        mp.setattr(torch.cuda, "CUDAGraph", _CPUGraph)
        mp.setattr(torch.cuda, "graph", _cpu_capture)
        mp.setattr(torch.cuda, "graph_pool_handle", lambda: None)
        mp.setattr(app, "takes_graph", lambda mode, device: True)
    return Renderer(c.mesh, c.camera, c.lights, c.config, mode="static",
                    device="cpu")


@pytest.mark.parametrize("replay", [False, True], ids=["eager", "replay"])
def test_spans_and_counter_of_a_traced_frame(cell, monkeypatch, replay):
    """Two traced frames after one untraced, eager or (from the first
    traced) replayed: each records the unfused frame's stages (the
    G-buffer's walk and the sampler's, the latter inside
    ``tpurt.shadow``; the origins, then the resolve; the composite, and
    the accumulation in it too), counts valid pixels x spp shadow rays and
    counts as resolved."""
    _stand_in_resolve_kernel(monkeypatch)
    r = _cell_renderer(cell, monkeypatch, replay)
    r.render_frame()
    with profile(activities=[ProfilerActivity.CPU]):
        outs = [r.render_frame() for _ in range(FRAMES)]
    s = r.spans
    assert r.stats["graph_replays"] == (FRAMES if replay else 0)
    assert s.frames == FRAMES and s.graph_frames == (FRAMES if replay else 0)
    assert s.syncs == FRAMES and s.resolve_frames == FRAMES
    for name, n in STAGES.items():
        assert s.totals[name]["entries"] == n * FRAMES, name
    assert s.totals["tpurt.composite"]["entries"] == 2 * FRAMES
    want = sum(int(o["valid"].sum()) for o in outs) * SPP
    assert s.counts == {"shadow_rays": want} and want > 0
    assert all(int(o["walk_counts"].abs().sum()) == 0 for o in outs)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _frames(r, n, eager, mp):
    outs = []
    for _ in range(n):
        with mp.context() as m:
            if eager:
                m.setattr(app, "takes_graph", lambda *a: False)
            outs.append(r.render_frame())
    torch.cuda.synchronize()
    return outs


def _same(a, b) -> bool:
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.cuda
def test_cell_frame_replays_as_eager_on_the_card(card, monkeypatch):
    """The cell's frame at 1920x1080, spp 8: the second frame captures,
    and the replays of the two frames after it equal the eager frames bit
    for bit, the accumulated image too; the two differ, so each replay
    samples its own frame's seed. A traced replay records the eager
    frame's stages and counts valid pixels x spp shadow rays; no walk
    overflows or is cut."""
    c = harness.Cell(harness.find_cell(CELL), SEED, card, {})
    graph = c.renderer
    eager = Renderer(c.mesh, c.camera, c.lights, c.config, mode="static",
                     device=card)
    assert graph.route == "unfused"
    og = _frames(graph, 4, False, monkeypatch)
    oe = _frames(eager, 4, True, monkeypatch)
    assert graph.stats["graph_captures"] == 1
    assert graph.stats["graph_replays"] == 3
    assert eager.stats["graph_replays"] == 0
    for i in (2, 3):
        assert set(og[i]) == set(oe[i])
        for k in oe[i]:
            assert _same(og[i][k], oe[i][k]), (i, k)
        assert int(og[i]["walk_counts"].abs().sum()) == 0
    assert not torch.equal(og[2]["shadow"], og[3]["shadow"])
    spans = {}
    for name, r, is_eager in (("graph", graph, False),
                              ("eager", eager, True)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            out = _frames(r, 1, is_eager, monkeypatch)[0]
        spans[name] = r.spans
        assert r.spans.counts["shadow_rays"] \
            == int(out["valid"].sum()) * SPP > 0.5 * SPP * 1920 * 1080
    sg, se = spans["graph"], spans["eager"]
    assert sg.graph_frames == 1 and se.graph_frames == 0
    assert sg.counts == se.counts and sg.syncs == se.syncs == 1
    assert {k: v["entries"] for k, v in sg.totals.items()} == \
        {k: v["entries"] for k, v in se.totals.items()}
    for name, n in STAGES.items():
        assert sg.totals[name]["entries"] == n, name
