"""The benchmark's 4K three-light raster cell, ``hall_raster.multi3_2160p``,
run through the harness on the CPU at a tiny size (correct, its control
not, the traced run's layers); the unfused shadow pass's counter
``shadow_rays`` against the live rays counted in plain torch from the
frame's G-buffer, on every branch of the pass; its readers
(``bench_torch/metrics/shadow_mrays``, ``shadow_roofline``) on a traced
frame of the cell and on frames that give them nothing to read; and the
shadow walks' count (``bench_torch/shadowcount.py``) against
``bench_torch/workcount.py``'s count of the whole frame.

The test marked ``cuda`` needs an NVIDIA card and skips elsewhere (run it
there with ``python -m pytest --noconftest -m cuda
tests/test_torch_raster_multi_bench.py``): the cell's frame at 3840x2160
on the card, its pair capacity grown on the first frame, its counter
against the plain count.
"""

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

from bench_torch import harness, scene, shadowcount, workcount  # noqa: E402
from bench_torch import reference as ref  # noqa: E402
from tpurt_torch import spans  # noqa: E402
from tpurt_torch.app import Renderer  # noqa: E402
from tpurt_torch.types import Light, RenderConfig  # noqa: E402

torch.set_num_threads(1)
ensure_native_libraries()

CELL = "hall_raster.multi3_2160p"
W, H = 64, 36
FRAMES = 2
SEED = 2 ** 31 + 54321
TINY = dict(tris_target=3000, width=W, height=H, check_pixels=384,
            warmup_frames=1, trace_frames=FRAMES)
READERS = ("shadow_mrays", "shadow_roofline")
# The shadow-ray kernel as the profiler names it on the card, and one that
# is not of csrc/shadow_rays.cu.
KERNELS = [("void shadow_rays_kernel<0>(Params)", 6e-4),
           ("void fused_shadows_kernel<1, 1>(Params)", 2e-3)]


def _run(trace=False, control=False):
    """One run of the cell at the tiny size; a traced one traces a single
    frame (the CPU's profiler slows the raster frame's many operations)."""
    return harness.run(CELL, SEED, 0.3, trace, t_start=time.perf_counter(),
                       device="cpu", control=control,
                       overrides=dict(TINY, trace_frames=1) if trace
                       else TINY)


def test_multi_raster_config_is_hall_raster_at_4k():
    """The cell's configuration (BASELINE config 5) is the raster
    deployment's scene, camera, mode and render settings, letter for
    letter, under its own source; the 4K frame and the three suns come
    with the traffic."""
    cell = harness.find_cell(CELL)
    one = harness.find_cell("hall_raster.sun_1080p")
    assert cell.config["name"] != one.config["name"]
    assert cell.config["source"] != one.config["source"]
    for key in ("scene", "camera", "mode", "render", "precision"):
        assert cell.config[key] == one.config[key], key
    assert (cell.traffic["width"], cell.traffic["height"]) == (3840, 2160)
    assert len(cell.traffic["lights"]) == 3


def test_multi_raster_cell_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1


def test_multi_raster_cell_control_is_not_correct():
    """The reference in bfloat16 in the program's place fails; the
    program's own numbers on the same frames and pixels pass."""
    res = _run(control=True)
    assert not res["correct"], res["checks"]
    limits = harness.find_cell(CELL).limits
    program = res["_info"]["program"]
    assert all(program[k] <= limits[k] for k in harness.CHECKS), program


def test_multi_raster_traced_run_reads_its_layers():
    """The raster layer and the unfused pass's counter read on the CPU;
    the rooflines read CUDA kernels, which a CPU trace has not."""
    res = _run(trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert {"bin_ms", "raster_ms", "raster_pairs", "walk_ms", "shadow_ms",
            "shadow_mrays"} <= set(m)
    assert not {"shadow_roofline", "raster_roofline"} & set(m)
    assert m["host_syncs_per_frame"]["value"] == 1.0
    rays = m["shadow_mrays"]["value"] * 1e6
    assert 0 < rays <= res["_info"]["shadow_rays_per_frame"]


def _plain_live_rays(out, renderer, spp=1):
    """The live shadow rays of a frame's hard lights, counted in plain
    torch from its G-buffer: valid pixels whose biased origin leaves the
    scene box toward the light at a distance above 0; ``spp`` rays a
    valid pixel for a sampled light."""
    valid = out["valid"]
    o = out["position"] + out["gnormal"] * renderer.config.shadow_bias
    acc = renderer.accel
    lo = torch.as_tensor(acc.root_min, dtype=torch.float32)
    hi = torch.as_tensor(acc.root_max, dtype=torch.float32)
    n = 0
    for light in renderer.lights:
        if spp > 1:
            n += int(valid.sum()) * spp
            continue
        inv = torch.clamp(1.0 / torch.as_tensor(light.direction), -3.4e38,
                          3.4e38)
        exit_t = torch.maximum((lo - o) * inv, (hi - o) * inv).amin(-1)
        n += int((valid & (exit_t * (1.0 + 1e-4) > 0.0)).sum())
    return n


@pytest.fixture(scope="module")
def cell():
    """The cell at the tiny size on the CPU, one frame warm, then FRAMES
    traced; the last traced frame's outputs kept."""
    c = harness.Cell(harness.find_cell(CELL), SEED, "cpu", TINY)
    c.step()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(FRAMES):
            out = c.step()
    c.out = out
    return c


def _ctx(c, kernels):
    return SimpleNamespace(cell=c, trace=SimpleNamespace(
        frames=FRAMES, kernels=kernels),
        last_frame_index=c.renderer.frame_index - 1)


def _read(name, ctx):
    return harness._load_reader(str(ROOT / "bench_torch"), name)(ctx)


def test_counter_is_the_plain_count_of_live_rays(cell):
    r = cell.renderer
    assert len(r.lights) == 3 and not r.config.fused_shadow
    want = _plain_live_rays(cell.out, r)
    assert want > 0
    assert r.spans.counts["shadow_rays"] == FRAMES * want
    assert r.spans.syncs == FRAMES
    assert _read("shadow_mrays", _ctx(cell, KERNELS)) == want / 1e6


def test_shadow_roofline_reads_the_shadow_kernels(cell):
    ctx = _ctx(cell, KERNELS)
    work = shadowcount.frame_shadow_work(cell, ctx.last_frame_index)
    assert work["rays"] > 0 and work["bound_ms"] > 0
    assert _read("shadow_roofline", ctx) == pytest.approx(
        100.0 * work["bound_ms"] / (KERNELS[0][1] * 1e3 / FRAMES))
    assert _read("shadow_roofline", _ctx(cell, KERNELS[1:])) is None


def _closest_only(c, frame_index):
    """A closest-only count of the frame: ``workcount``'s plain closest
    walk of every camera ray, and no shadow ray."""
    r, view = c.renderer, c.view
    w, h = view["width"], view["height"]
    idx = torch.arange(w * h)
    o, d = ref.camera_rays(c.camera, w, h, idx // w, idx % w, torch.float32)
    stats = {}
    workcount.closest(r.accel.nodes, r.accel.tris, r.accel.leaf_size,
                      o.contiguous(), d, stats)
    return stats


@pytest.mark.parametrize("key", ["pops", "slab_tests", "tris"])
def test_shadow_count_and_closest_count_make_the_frame_count(cell, key):
    """The any-hit walks' pops, slab tests and triangle tests, added to a
    closest-only count of the same frame, are ``workcount.frame_work``'s
    totals; the closest walk's part ``shadowcount`` keeps apart is that
    closest-only count."""
    i = cell.renderer.frame_index - 1
    whole = workcount.frame_work(cell, i)
    shadow = shadowcount.frame_shadow_work(cell, i)
    closest = _closest_only(cell, i)
    assert shadow["closest"] == closest
    if key == "tris":
        assert shadow["anyhit_tris"] == whole["anyhit_tris"] > 0
        assert closest["closest_tris"] == whole["closest_tris"] > 0
        assert "closest_tris" not in shadow
    else:
        assert shadow[key] + closest[key] == whole[key]
        assert 0 < shadow[key] < whole[key]
    assert shadow["ops"] < whole["ops"]


def _hall_renderer(lights, spp=1, **cfg):
    m = scene.make_scene({"generator": "hall", "tris_target": 3000}, SEED)
    cam = scene.camera(harness.find_cell(CELL).config["camera"])
    return Renderer(m, cam, lights,
                    RenderConfig(width=32, height=18, leaf_size=14,
                                 sah=False, spp=spp, **cfg), device="cpu")


def _traced_frames(r, n=1):
    r.render_frame()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(n):
            out = r.render_frame()
    return out


SUNS = [Light.directional((0.25, 0.9, 0.2)),
        Light.directional((-0.55, 0.65, 0.25)),
        Light.directional((0.1, 0.9, -0.4))]


def test_fused_frame_counts_nothing_and_gives_no_shadow_count():
    """A frame whose fused launch takes every light runs no unfused pass:
    the counter stays out of the frame's record, the readers find
    nothing, and ``shadowcount`` has no light to walk."""
    r = _hall_renderer(SUNS, gbuffer="ray", fused_shadow=True)
    _traced_frames(r, FRAMES)
    assert r.route == "fusedN" and r.spans.frames == FRAMES
    assert "shadow_rays" not in r.spans.counts
    c = SimpleNamespace(renderer=r, mesh=r.mesh, camera=r.camera,
                        lights=r.lights, seed=SEED, dev=torch.device("cpu"),
                        view={"width": 32, "height": 18, "spp": 1,
                              "shadow_bias": r.config.shadow_bias})
    assert not shadowcount.unfused_light_indices(r)
    assert shadowcount.frame_shadow_work(c, 1) is None
    assert all(_read(name, _ctx(c, KERNELS)) is None for name in READERS)


def test_readers_find_nothing_without_the_counter(cell):
    """A program that keeps no ``shadow_rays`` counter (a tree before it)
    or traced no frame gives no reading."""
    ctx = _ctx(cell, KERNELS)
    r = cell.renderer
    try:
        cell.renderer = SimpleNamespace(spans=SimpleNamespace(
            frames=FRAMES, counts={"raster_pairs": 10}))
        assert _read("shadow_mrays", ctx) is None
        cell.renderer = SimpleNamespace(spans=SimpleNamespace(
            frames=0, counts={"shadow_rays": 10}))
        assert _read("shadow_mrays", ctx) is None
    finally:
        cell.renderer = r


SAMPLED = {"cone_in_kernel": (Light.sun((0.25, 0.9, 0.2), 2.0), 8),
           "disk_in_kernel": (Light.point((0.0, 6.0, 0.0), radius=0.3), 8),
           "cone_scan": (Light.sun((0.25, 0.9, 0.2), 2.0), 2)}


@pytest.mark.parametrize("case", list(SAMPLED))
def test_sampled_light_counts_each_sample(case):
    """A sampled light at spp 3: the 8-wide accel's in-kernel samplers
    (cone and disk) count its valid pixels x spp, the binary accel's scan
    each sample's batch."""
    light, width = SAMPLED[case]
    r = _hall_renderer([light], spp=3, gbuffer="ray", fused_shadow=False,
                       bvh_width=width)
    out = _traced_frames(r)
    assert r.spans.counts["shadow_rays"] == _plain_live_rays(out, r, 3) > 0


def test_frame_rendered_again_counts_its_last_attempt():
    """A traced raster frame whose binning overflows its pair capacity is
    rendered again with a bigger one: the counter holds the last
    attempt's live rays alone, after one host read an attempt."""
    r = _hall_renderer(SUNS, gbuffer="raster", fused_shadow=False,
                       raster_cap_pairs=256)
    with profile(activities=[ProfilerActivity.CPU]):
        out = r.render_frame()
    assert r.stats["raster_cap_growths"] == 1
    assert r.spans.syncs == 2
    assert r.spans.counts["shadow_rays"] == _plain_live_rays(out, r) > 0


def test_count_makes_nothing_untraced():
    """Outside a traced frame a counter's function is never called, so an
    untraced frame launches nothing for its counts."""
    calls = []
    spans.count("shadow_rays", lambda: calls.append(1))
    assert calls == []


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cell_frame_at_2160p_on_the_card(card):
    """The cell's frame at full size: the first frame grows the pair
    capacity past the default and none after it does; a traced frame
    makes one host sync and counts the plain live rays."""
    from tpurt_torch.raster.setup import default_cap_rows
    c = harness.Cell(harness.find_cell(CELL), SEED, card, {})
    r = c.renderer
    for _ in range(3):
        c.step()
    growths = r.stats["raster_cap_growths"]
    assert growths >= 1
    assert r.config.raster_cap_pairs >= 2 * default_cap_rows(
        r.mesh.num_triangles)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out = c.step()
    torch.cuda.synchronize()
    assert r.stats["raster_cap_growths"] == growths
    assert r.spans.syncs == 1
    host = {k: v.cpu() if torch.is_tensor(v) else v for k, v in out.items()}
    acc = SimpleNamespace(root_min=torch.as_tensor(r.accel.root_min).cpu(),
                          root_max=torch.as_tensor(r.accel.root_max).cpu())
    want = _plain_live_rays(host, SimpleNamespace(
        config=r.config, accel=acc, lights=r.lights))
    assert r.spans.counts["shadow_rays"] == want > 0.5 * 3 * 3840 * 2160
