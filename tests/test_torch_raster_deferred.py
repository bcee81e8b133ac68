"""The deferred raster G-buffer (``raster_deferred=True``): the z-only
records and their binning (``bin_rows(..., fmt="z16")``), the z-only
rasterizer's plain version (``rasterize_rows16_reference``) on ``tpurt``'s
bins against ``tpurt``'s ``rasterize_rows16`` in interpret mode
(``_raster_kernel16``), the original-order shade table and its decode,
``_gbuffer_raster_deferred`` against ``tpurt``'s, and static and
plain-rebuild Renderer frames against ``tpurt``'s.

Tolerances and why: the binning as tests/test_torch_raster_setup.py
holds it (decision 8: edges to 1e-4 of the record's scale, 1/det to 1e-2
relative, every integer and copied lane equal); the rasterizer on the same
bins as tests/test_torch_raster.py (ids equal, u, v and 1/w within 2e-5:
interpret mode contracts the edge evaluations into FMAs); the table bit
for bit (its lanes are gathers and the packings of tests/
test_torch_shade_table.py); the decode within 1e-6 (decision 11's
order); the G-buffer as test_torch_raster_frames.py holds the 32-float
one (ids on 99.9% of valid pixels, depth and t within 2e-4 relative,
positions within 2e-4 of the depth, normals within 1e-4); frames as
tests/test_torch_app.py holds them (at most 2e-3 of pixels off by more
than 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.passes.gbuffer as jgbuffer
import tpurt.passes.shading as jshading
import tpurt.raster.setup as jsetup
import tpurt.scenes as jscenes
from tpurt.kernels.raster import rasterize_rows16 as jrasterize16
from tpurt.types import Light as JLight
from tpurt.types import RenderConfig as JRenderConfig
import tpurt_torch.raster.setup as tsetup
import tpurt_torch.scenes as tscenes
from tpurt_torch import convert
from tpurt_torch.app import Renderer
from tpurt_torch.kernels import raster as R
from tpurt_torch.passes import gbuffer as tgbuffer
from tpurt_torch.passes import shading as tshading
from tpurt_torch.types import Light, RenderConfig

from test_torch_app import _assert_close_frames, _jax_frame
from test_torch_native import ensure_native_libraries
from test_torch_raster_setup import _cameras, _np

torch.set_num_threads(1)
ensure_native_libraries()

W, H = 96, 64
NTRIS = 1500
DIRECTION = (0.45, 0.8, 0.3)


@pytest.fixture(scope="module")
def scene():
    jm = jscenes.teapot_scene(NTRIS)
    tm = convert.mesh(convert.numpy_fields(jm)).on("cpu")
    return jax.device_put(jm), tm


@pytest.fixture(scope="module")
def bins(scene):
    """Both packages' z16 bins for each camera at the default capacity."""
    jm, tm = scene
    out = {}
    for name, jc in _cameras(jm).items():
        tc = convert.camera(convert.numpy_fields(jc))
        cap = jsetup.default_cap_rows(NTRIS)
        out[name] = (jsetup.bin_rows(jc, jm, W, H, cap, fmt="z16"),
                     tsetup.bin_rows(tc, tm, W, H, cap, fmt="z16"), jc, tc)
    return out


def _check_records16(a, b):
    """Records f32[n, 16] of the two packages (decision 8)."""
    for lanes in ((10, 11), (12, 13, 14, 15)):
        np.testing.assert_array_equal(a[:, lanes], b[:, lanes])
    ea = a[:, 0:9].reshape(-1, 3, 3)
    eb = b[:, 0:9].reshape(-1, 3, 3)
    scale = np.maximum(np.abs(ea).max(axis=(1, 2)), 1e-30)
    assert (np.abs(ea - eb).max(axis=(1, 2)) <= 1e-4 * scale).all()
    np.testing.assert_allclose(b[:, 9], a[:, 9], rtol=1e-2, atol=0)


@pytest.mark.parametrize("cam", ["outside", "inside"])
def test_bin_rows_z16_matches(bins, cam):
    jb, tb, _, _ = bins[cam]
    for name in ("row_starts", "row_counts", "big_nrows", "overflow"):
        a, b = _np(getattr(jb, name)), _np(getattr(tb, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert _np(tb.pair_rows).shape == _np(jb.pair_rows).shape
    assert _np(tb.big_rows).shape == _np(jb.big_rows).shape
    live = int(_np(tb.row_counts).sum())
    assert live > 0 and not bool(_np(tb.overflow))
    _check_records16(_np(jb.pair_rows)[:live].reshape(-1, 16),
                     _np(tb.pair_rows)[:live].reshape(-1, 16))
    if cam == "inside":
        assert int(_np(tb.big_nrows)) > 0
    _check_records16(_np(jb.big_rows).reshape(-1, 16),
                     _np(tb.big_rows).reshape(-1, 16))
    # Eight records to a row: about half the 32-float binning's rows.
    full = tsetup.bin_rows(bins[cam][3], convert.mesh(convert.numpy_fields(
        jscenes.teapot_scene(NTRIS))).on("cpu"), W, H,
        jsetup.default_cap_rows(NTRIS))
    assert live < 0.7 * int(full.row_counts.sum())


def test_dead_slots_are_marked():
    """A z16 row holds eight records; the padding of the last row carries
    id -1 (lane 10), as tpurt's padding does."""
    table = tsetup._pack_rows32(torch.zeros((13, 16)))
    assert table.shape == (2, 128)
    ids = table.reshape(-1, 16)[:, 10].numpy()
    np.testing.assert_array_equal(ids[13:], -1.0)
    np.testing.assert_array_equal(ids[:13], 0.0)


@pytest.fixture(scope="module")
def raster16(bins):
    """tpurt's interpret-mode z-only rasterizer on its own bins, outside
    camera (about 20 s of interpret mode)."""
    jb, _, _, _ = bins["outside"]
    out = jrasterize16(jb, W, H, interpret=True)
    return {k: np.asarray(v) for k, v in
            zip(("tri", "u", "v", "invw"), out)}, jb


def test_plain_rasterizer16_matches_tpurt_on_its_bins(raster16):
    want, jb = raster16
    tb = convert.raster_rows({k: np.asarray(v)
                              for k, v in jb._asdict().items()}, "cpu")
    tri, u, v, invw = R.rasterize_rows16(tb, W, H)
    assert tri.dtype == torch.int32 and tri.shape == (H, W)
    assert u.shape == v.shape == invw.shape == (H, W)
    np.testing.assert_array_equal(tri.numpy(), want["tri"])
    valid = want["tri"] >= 0
    assert valid.mean() > 0.3
    for got, key in ((u, "u"), (v, "v"), (invw, "invw")):
        np.testing.assert_array_equal(got.numpy()[~valid], 0.0)
        np.testing.assert_allclose(got.numpy()[valid], want[key][valid],
                                   rtol=2e-5 if key == "invw" else 0,
                                   atol=0 if key == "invw" else 2e-5)


def test_rasterizer16_equals_the_32_float_one(scene, bins):
    """On the port's own bins the z-only rasterizer's ids, u, v and 1/w
    are the 32-float one's bit for bit: the same records in the same
    order, the same arithmetic."""
    _, tm = scene
    _, tb, _, tc = bins["inside"]
    full = tsetup.bin_rows(tc, tm, W, H, jsetup.default_cap_rows(NTRIS))
    tri32, at = R.rasterize_rows(full, W, H)
    tri, u, v, invw = R.rasterize_rows16(tb, W, H)
    assert torch.equal(tri, tri32) and (tri >= 0).any()
    for got, c in ((u, 0), (v, 1), (invw, 2)):
        assert torch.equal(got, at[c])


def test_rasterize_rows16_cuda_refuses_cpu_tensors(bins):
    _, tb, _, _ = bins["outside"]
    before = R.rasterize_rows16_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        R.rasterize_rows16_cuda(tb, W, H)
    assert R.rasterize_rows16_cuda.launches == before


def test_shade_table_orig_bit_for_bit(scene):
    jm, tm = scene
    want = np.asarray(jshading.make_shade_table_orig(jm))
    got = tshading.make_shade_table_orig(tm)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (tm.num_triangles, 16)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_shade_from_table_uv_matches(scene):
    jm, tm = scene
    rng = np.random.default_rng(0)
    ids = rng.integers(0, NTRIS, (24, 16))
    u = rng.uniform(0, 0.5, (24, 16)).astype(np.float32)
    v = rng.uniform(0, 0.5, (24, 16)).astype(np.float32)
    valid = rng.random((24, 16)) < 0.8
    jt = jshading.make_shade_table_orig(jm)
    want = jax.jit(jshading.shade_from_table_uv)(
        jt[ids], jnp.asarray(u), jnp.asarray(v), jnp.asarray(valid))
    tt = tshading.make_shade_table_orig(tm)
    got = tshading.shade_from_table_uv(tt[torch.from_numpy(ids)],
                                       torch.from_numpy(u),
                                       torch.from_numpy(v),
                                       torch.from_numpy(valid))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(got[k].numpy()[~valid], 0.0)


def test_deferred_gbuffer_matches_tpurt(scene, raster16, monkeypatch):
    """tpurt's pass bins the outside view as the fixture did, so its
    interpret-mode rasterizer's outputs are taken from the fixture."""
    import tpurt.kernels.raster as jraster
    jm, tm = scene
    jc = _cameras(jm)["outside"]
    tc = convert.camera(convert.numpy_fields(jc))
    jt = jshading.make_shade_table_orig(jm)
    want16, _ = raster16
    monkeypatch.setattr(jraster, "rasterize_rows16", lambda *a, **k: tuple(
        jnp.asarray(want16[key]) for key in ("tri", "u", "v", "invw")))
    want = {k: np.asarray(x) for k, x in jgbuffer.gbuffer_raster_pass(
        jm, jc, W, H, jt, interpret=True, deferred=True).items()}
    got = {k: x.numpy() for k, x in tgbuffer.gbuffer_raster_pass(
        tm, tc, W, H, tshading.make_shade_table_orig(tm),
        deferred=True).items()}
    assert set(got) == set(want)
    assert not got["raster_overflow"] and not want["raster_overflow"]
    valid = want["valid"]
    np.testing.assert_array_equal(got["valid"], valid)
    same = (got["tri_id"] == want["tri_id"]) & valid
    assert same.sum() >= 0.999 * valid.sum() and valid.mean() > 0.3
    for k in ("depth", "t"):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=2e-4)
        np.testing.assert_array_equal(got[k][~valid], want[k][~valid])
    dp = np.abs(got["position"] - want["position"])[same].max(axis=-1)
    assert (dp <= 2e-4 * want["depth"][same]).all()
    np.testing.assert_array_equal(got["position"][~valid], 0.0)
    for k, tol in (("normal", 1e-4), ("gnormal", 1e-6), ("view_dir", 1e-4),
                   ("albedo", 0.0)):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=0,
                                   atol=tol, err_msg=k)
    with pytest.raises(ValueError, match="original-order"):
        tgbuffer.gbuffer_raster_pass(tm, tc, W, H, deferred=True)


@pytest.mark.parametrize("mode", ["static", "rebuild"])
def test_deferred_frame_matches_jax_renderer(mode):
    """The rebuild takes the fixed cut, whose collapse has no kernel to
    interpret in tpurt (the G-buffer does not depend on the accel)."""
    fields = dict(width=48, height=32, leaf_size=8, gbuffer="raster",
                  raster_deferred=True)
    if mode == "rebuild":
        fields.update(rebuild_splits=0, rebuild_collapse="fixed")
    jmesh = jscenes.teapot_scene(1500)
    jimg = _jax_frame(jmesh, jscenes.default_camera_for(jmesh),
                      JLight.directional(DIRECTION), JRenderConfig(**fields),
                      mode=mode)
    tmesh = tscenes.teapot_scene(1500)
    r = Renderer(tmesh, tscenes.default_camera_for(tmesh),
                 Light.directional(DIRECTION), RenderConfig(**fields),
                 mode=mode, device="cpu")
    assert r.shade_table_orig is not None and r.shade_table is None
    assert r.attr_tables is None and r.route == "unfused"
    out = r.render_frame()
    _assert_close_frames(jimg, out["image"].numpy())
    assert "uv" not in out
