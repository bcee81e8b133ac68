"""The raster frame's spans and pair counter (CPU, plain versions of the
kernels): under a recording profiler the raster G-buffer opens its
binning and rasterizer spans inside ``tpurt.gbuffer`` and the unfused
shadow pass its walk inside ``tpurt.shadow``; the counter of binned (row,
tile) pairs equals the binning's total and rides in the frame's one host
read; tracing changes no output bit; a fused ray-cast frame opens none of
the new spans."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpurt_torch.app import Renderer
from tpurt_torch.raster.setup import bin_rows, default_cap_rows
from tpurt_torch.scenes import default_camera_for, teapot_scene
from tpurt_torch.types import Light, RenderConfig

from test_torch_native import ensure_native_libraries

torch.set_num_threads(1)
ensure_native_libraries()

W, H = 96, 64
DIRECTION = (0.45, 0.8, 0.3)
TRACED = 2
NEW_SPANS = ("tpurt.gbuffer.bin", "tpurt.gbuffer.raster")


@pytest.fixture(scope="module")
def mesh():
    return teapot_scene(1500)


def _renderer(mesh, **cfg):
    return Renderer(mesh, default_camera_for(mesh),
                    Light.directional(DIRECTION),
                    RenderConfig(width=W, height=H, leaf_size=8, **cfg),
                    device="cpu")


def _traced(r):
    """TRACED frames under a recording profiler -> the last one's
    outputs."""
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(TRACED):
            out = r.render_frame()
    return out


@pytest.fixture(scope="module")
def raster(mesh):
    """A raster frame untraced, then TRACED frames traced."""
    r = _renderer(mesh, gbuffer="raster", fused_shadow=False)
    plain = r.render_frame()
    return r, plain, _traced(r)


def test_raster_frame_opens_its_spans(raster):
    r, _, _ = raster
    assert r.route == "unfused" and r.config.gbuffer == "raster"
    t = r.spans.totals
    assert r.spans.frames == TRACED
    for name in (*NEW_SPANS, "tpurt.walk", "tpurt.gbuffer", "tpurt.shadow"):
        assert t[name]["entries"] >= TRACED, name
    # A parent's self ms is its device ms less its children's: the binning
    # and the rasterizer are inside tpurt.gbuffer, the walk inside
    # tpurt.shadow.
    children = t["tpurt.gbuffer.bin"]["device_ms"] \
        + t["tpurt.gbuffer.raster"]["device_ms"]
    assert t["tpurt.gbuffer"]["self_ms"] == pytest.approx(
        t["tpurt.gbuffer"]["device_ms"] - children)
    assert t["tpurt.shadow"]["self_ms"] == pytest.approx(
        t["tpurt.shadow"]["device_ms"] - t["tpurt.walk"]["device_ms"])
    assert t["tpurt.walk"]["entries"] == TRACED


def test_pair_counter_is_the_binnings_total(raster, mesh):
    r, _, _ = raster
    bins = bin_rows(r.camera, r.mesh, W, H,
                    default_cap_rows(mesh.num_triangles))
    total = int(bins.pairs)
    assert not bool(bins.overflow)
    assert total == int(bins.row_counts.sum()) > 0
    counts = r.spans.counts
    # The unfused shadow pass counts its live rays beside the pairs.
    assert counts.pop("shadow_rays") > 0
    assert counts == {"raster_pairs": TRACED * total}


def test_grown_frame_counts_its_last_attempt(mesh):
    """A frame whose binning overflowed is rendered again with a bigger
    capacity: its counter holds the pairs of the attempt it returns."""
    r = Renderer(mesh, default_camera_for(mesh),
                 Light.directional(DIRECTION),
                 RenderConfig(width=48, height=32, leaf_size=8,
                              gbuffer="raster", raster_cap_pairs=256),
                 device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        r.render_frame()
    assert r.stats["raster_cap_growths"] == 1
    bins = bin_rows(r.camera, r.mesh, 48, 32,
                    r.config.raster_cap_pairs)
    assert not bool(bins.overflow)
    counts = r.spans.counts
    assert counts.pop("shadow_rays") > 0
    assert counts == {"raster_pairs": int(bins.pairs)}


def test_pair_counter_adds_no_host_sync(raster):
    """One host read a frame, the walk flags with the overflow flag, as
    before the counter: the count rides in the same copy."""
    r, _, _ = raster
    assert r.spans.syncs == 1 * TRACED


def test_tracing_changes_no_output(raster):
    _, plain, traced = raster
    assert set(plain) == set(traced)
    for k, v in plain.items():
        assert torch.equal(v, traced[k]), k


def test_fused_ray_frame_opens_no_raster_span(mesh):
    r = _renderer(mesh, gbuffer="ray")
    _traced(r)
    assert r.route == "fused0"
    t = r.spans.totals
    assert not set(NEW_SPANS) & set(t)
    assert r.spans.counts == {}
    # The fused walk is a stage of its own, not inside tpurt.shadow.
    assert t["tpurt.shadow"]["self_ms"] == t["tpurt.shadow"]["device_ms"]
