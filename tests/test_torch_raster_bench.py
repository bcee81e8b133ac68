"""The benchmark's raster cell, ``hall_raster.sun_1080p``, run through the
harness on the CPU at a tiny size (correct, its control not, the traced
run's raster metrics); its readers (``bench_torch/metrics/bin_ms``,
``raster_ms``, ``raster_pairs``, ``raster_roofline``) on a traced raster
frame of the benchmark's hall and on frames that give them nothing to
read; and the rasterization count (``bench_torch/rastercount.py``)
against a brute-force count of every (triangle, pixel) pair."""

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

from bench_torch import harness, rastercount, scene  # noqa: E402
from tpurt_torch.app import Renderer  # noqa: E402
from tpurt_torch.raster.setup import bin_rows, default_cap_rows  # noqa: E402
from tpurt_torch.types import Light, RenderConfig  # noqa: E402

torch.set_num_threads(1)
ensure_native_libraries()

W, H = 64, 36
FRAMES = 2
SEED = 2 ** 31 + 12345
# The hall's camera, as the benchmark's hall configurations state it.
CAMERA = harness.load_json(str(
    ROOT / "bench_torch" / "configs" / "hall_static.json"))["camera"]
READERS = ("bin_ms", "raster_ms", "raster_pairs", "raster_roofline")
# The kernels as the profiler names them on the card.
KERNELS = [("void (anonymous namespace)::raster_rows_kernel<32>(float "
            "const*, int, int const*, int const*, float const*, int, int "
            "const*, int, int, int, int, float, float, float, float, int*, "
            "float*)", 1.5e-3),
           ("void shadow_rays_kernel<0>(Params)", 4e-4)]


CELL = "hall_raster.sun_1080p"
TINY = dict(tris_target=3000, width=W, height=H, check_pixels=384,
            warmup_frames=1, trace_frames=FRAMES)


def _run(trace=False, control=False):
    return harness.run(CELL, SEED, 0.3, trace, t_start=time.perf_counter(),
                       device="cpu", overrides=TINY, control=control)


def test_raster_cell_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1


def test_raster_cell_control_is_not_correct():
    """The reference in bfloat16 in the program's place fails; the
    program's own numbers on the same frames and pixels pass."""
    res = _run(control=True)
    assert not res["correct"], res["checks"]
    limits = harness.find_cell(CELL).limits
    program = res["_info"]["program"]
    assert all(program[k] <= limits[k] for k in harness.CHECKS), program


def test_raster_cell_traced_run_reads_its_layers():
    """The spans and the counter read on the CPU; the rasterizer's
    roofline reads a CUDA kernel, which a CPU trace has not."""
    res = _run(trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert {"bin_ms", "raster_ms", "raster_pairs", "walk_ms",
            "gbuffer_ms", "shadow_ms"} <= set(m)
    assert "raster_roofline" not in m
    assert m["raster_pairs"]["value"] > 0
    assert m["host_syncs_per_frame"]["value"] == 1.0


def _hall(tris=3000, seed=SEED):
    return scene.make_scene({"generator": "hall", "tris_target": tris}, seed)


def _ctx(gbuffer, kernels):
    """A traced window of FRAMES frames of the hall (the raster G-buffer
    and unfused shadow pass, or the fused ray cast) as the harness hands
    it to the readers, with ``kernels`` standing in for the trace's."""
    mesh, cam = _hall(), scene.camera(CAMERA)
    r = Renderer(mesh, cam, Light.directional((0.25, 0.9, 0.2)),
                 RenderConfig(width=W, height=H, leaf_size=14, sah=False,
                              gbuffer=gbuffer,
                              fused_shadow=gbuffer == "ray"),
                 device="cpu")
    r.render_frame()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(FRAMES):
            r.render_frame()
    cell = SimpleNamespace(renderer=r, mesh=mesh, camera=cam,
                           view={"width": W, "height": H},
                           dev=torch.device("cpu"))
    return SimpleNamespace(cell=cell, trace=SimpleNamespace(
        frames=FRAMES, kernels=kernels))


def _read(name, ctx):
    return harness._load_reader(str(ROOT / "bench_torch"), name)(ctx)


def test_readers_read_a_traced_raster_frame():
    ctx = _ctx("raster", KERNELS)
    r = ctx.cell.renderer
    t = r.spans.totals
    assert _read("bin_ms", ctx) == pytest.approx(
        t["tpurt.gbuffer.bin"]["self_ms"] / FRAMES)
    assert _read("raster_ms", ctx) == pytest.approx(
        t["tpurt.gbuffer.raster"]["self_ms"] / FRAMES)
    bins = bin_rows(r.camera, r.mesh, W, H,
                    default_cap_rows(r.mesh.num_triangles))
    assert _read("raster_pairs", ctx) == int(bins.pairs) / 1e3 > 0
    work = rastercount.frame_raster_work(ctx.cell.mesh, ctx.cell.camera, W,
                                         H)
    assert _read("raster_roofline", ctx) == pytest.approx(
        100.0 * work["bound_ms"] / (KERNELS[0][1] * 1e3 / FRAMES))


def test_readers_find_nothing_without_a_raster_frame():
    """A fused ray-cast frame opens no raster span and counts no pair, a
    trace without the rasterizer gives no roofline, and a program that
    keeps no counters (a tree before them) gives no pair count."""
    ctx = _ctx("ray", KERNELS[1:])
    assert all(_read(name, ctx) is None for name in READERS)
    ctx.cell.renderer = SimpleNamespace(spans=SimpleNamespace(frames=FRAMES))
    assert _read("raster_pairs", ctx) is None


@pytest.mark.parametrize("seed,size", [(7, (40, 24)), (SEED, (33, 19))])
def test_fragment_count_is_the_brute_force_count(seed, size):
    """Every (triangle, pixel centre) pair tested, against the count over
    screen boxes and the eye-plane crossers."""
    w, h = size
    mesh, cam = _hall(1200, seed), scene.camera(CAMERA)
    c = rastercount.clip_coords(cam, w, h, torch.as_tensor(
        mesh.vertices))[torch.as_tensor(mesh.indices).long()]
    t = c.shape[0]
    tri = torch.arange(t).repeat_interleave(w * h)
    pix = torch.arange(w * h).repeat(t)
    hit = rastercount._covered(c, tri, (pix % w).double(),
                               (pix // w).double())
    want = torch.zeros(t, dtype=torch.int64).index_add_(0, tri, hit.long())
    got, covered = rastercount.fragments(mesh, cam, w, h)
    assert torch.equal(got, want)
    assert torch.equal(covered, torch.zeros(w * h, dtype=torch.bool)
                       .index_fill_(0, pix[hit], True))
    # Some triangles cross the eye plane, some lie behind it.
    wz = c[:, :, 2]
    assert bool((~torch.all(wz > rastercount.W_EPS, 1)
                 & torch.any(wz > 0, 1)).any())
    assert bool(torch.all(wz <= 0, 1).any())
    work = rastercount.frame_raster_work(mesh, cam, w, h)
    assert work["fragments"] == int(want.sum()) > 0
    assert work["pixels"] == int(covered.sum())
    assert work["bytes"] == (24 * len(mesh.vertices) + 24 * t
                             + 4 * rastercount.GBUFFER_CHANNELS * w * h)
    assert work["bound_ms"] > 0
