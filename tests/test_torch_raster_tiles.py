"""The v1 rasterizer: the port's ``bin_triangles`` against ``tpurt``'s
``tpurt/raster/setup.py`` ``bin_triangles``, and ``rasterize_tiles``'
plain version against ``tpurt``'s ``rasterize_tiles`` in Pallas
interpret mode on ``tpurt``'s own bins; its tie order, record masking
and the CUDA launch boundary.

Tolerances and why (ROADMAP decision 8): the integer outputs (starts,
counts, big_count, overflow) and the ids and zero lanes of every record
are equal; the edge vectors agree to 1e-4 of the record's largest
component and 1/det to 1e-2 relative. The v1 records are cross products
of pixel-scale clip coordinates, so the port rounds the clip transform's
dot products and the cross products as XLA's CPU compiler contracts them
(decision 24; the records then measure equal on these scenes); the bounds
hold across compilers. On identical bins the ids are equal, and u, v and
1/w agree to 2e-5: interpret mode contracts the edge evaluations into
fused multiply-adds, and the plain version and the CUDA kernel do not.

Scenes: the teapot (1500) at 96x64 from outside and from inside, where
triangles cross the eye plane and fill the big list; the teapot with a
degenerate triangle added; a forced pair overflow; the Sponza-class hall
(20k) from inside at 160x96."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import tpurt.raster.setup as jsetup
import tpurt_torch.raster.setup as tsetup
from tpurt.kernels.raster import rasterize_tiles as jrasterize
from tpurt.scenes import teapot_scene as jteapot
from tpurt_torch import convert
from tpurt_torch.kernels import raster as R

from test_torch_raster import _cameras
from test_torch_native import ensure_native_libraries

torch.set_num_threads(1)
ensure_native_libraries()

W, H = 96, 64
NTRIS = 1500


def _meshes(jm):
    """The JAX mesh on the device and its port copy on the CPU."""
    return jax.device_put(jm), convert.mesh(convert.numpy_fields(jm)).on(
        "cpu")


@pytest.fixture(scope="module")
def ref():
    """Both packages' bins per camera and tpurt's interpret-mode raster of
    its own bins (about 20 s of interpret mode per camera)."""
    jm, tm = _meshes(jteapot(NTRIS))
    cap = jsetup.default_cap_pairs(NTRIS)
    out = {}
    for name, jc in _cameras(jm).items():
        tc = convert.camera(convert.numpy_fields(jc))
        jb = jsetup.bin_triangles(jc, jm, W, H, cap)
        res = jrasterize(jb, W, H, interpret=True)
        out[name] = dict(
            jbins={k: np.asarray(v) for k, v in jb._asdict().items()},
            tbins=tsetup.bin_triangles(tc, tm, W, H, cap),
            res=[np.asarray(x) for x in res])
    return out


def _check_bins(jb, tb):
    for k in ("starts", "counts", "big_count", "overflow"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(), jb[k],
                                      err_msg=k)
    for rows in ("pair_rows", "big_rows"):
        a = jb[rows].reshape(-1, 16)
        b = getattr(tb, rows).numpy().reshape(-1, 16)
        assert a.shape == b.shape, rows
        np.testing.assert_array_equal(b[:, 10:], a[:, 10:], err_msg=rows)
        ea, eb = a[:, 0:9], b[:, 0:9]
        scale = np.maximum(np.abs(ea).max(axis=1), 1e-30)
        assert (np.abs(ea - eb).max(axis=1) <= 1e-4 * scale).all(), rows
        np.testing.assert_allclose(b[:, 9], a[:, 9], rtol=1e-2, atol=0,
                                   err_msg=rows)


@pytest.mark.parametrize("cam", ["outside", "inside"])
def test_bins_match_tpurt(ref, cam):
    r = ref[cam]
    _check_bins(r["jbins"], r["tbins"])
    assert not bool(r["tbins"].overflow)
    assert (int(r["tbins"].big_count) > 0) == (cam == "inside")


def _check_raster(got, want):
    tri, u, v, invw = (x.numpy() for x in got)
    wtri, wu, wv, winvw = want
    assert tri.dtype == np.int32 and tri.shape == (H, W)
    np.testing.assert_array_equal(tri, wtri)
    hit = wtri >= 0
    assert hit.mean() > 0.3
    for a, b in ((u, wu), (v, wv), (invw, winvw)):
        assert a.dtype == np.float32 and a.shape == (H, W)
        np.testing.assert_array_equal(a[~hit], 0.0)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)


@pytest.mark.parametrize("cam", ["outside", "inside"])
def test_plain_matches_tpurt_on_its_bins(ref, cam):
    r = ref[cam]
    got = R.rasterize_tiles(convert.raster_bins(r["jbins"], "cpu"), W, H)
    _check_raster(got, r["res"])


@pytest.mark.parametrize("cam", ["outside", "inside"])
def test_port_bins_rasterize_like_tpurt(ref, cam):
    """The port's own bins through the plain rasterizer against tpurt's
    whole chain: the binning's rounding may move an id at a shared edge,
    on at most 0.1% of the covered pixels."""
    r = ref[cam]
    tri, _, _, invw = R.rasterize_tiles(r["tbins"], W, H)
    wtri = r["res"][0]
    hit = wtri >= 0
    np.testing.assert_array_equal(tri.numpy() >= 0, hit)
    assert ((tri.numpy() == wtri) & hit).sum() >= 0.999 * hit.sum()
    np.testing.assert_allclose(invw.numpy(), r["res"][3], rtol=2e-4,
                               atol=0)


def _with_degenerate(jm):
    """The teapot plus one zero-area triangle (three collinear corners of
    existing vertices) in the middle of the index list."""
    idx = np.asarray(jm.indices)
    alb = np.asarray(jm.albedo)
    tri = np.array([[idx[0, 0], idx[0, 0], idx[0, 1]]], np.int32)
    return dataclasses.replace(
        jm, indices=np.concatenate([idx[:10], tri, idx[10:]]),
        albedo=np.concatenate([alb[:10], alb[:1], alb[10:]]))


def test_degenerate_and_overflow_match_tpurt():
    """A zero-area triangle is binned as tpurt bins it (with the
    contracted cross products its determinant is a rounding residue, not
    0, so both keep its pairs); a pair capacity far below the scene's sets
    overflow and keeps the pairs that fit, as tpurt's binner does."""
    jm, tm = _meshes(_with_degenerate(jteapot(NTRIS)))
    jc = _cameras(jm)["outside"]
    tc = convert.camera(convert.numpy_fields(jc))
    for cap in (jsetup.default_cap_pairs(NTRIS), 1024):
        jb = jsetup.bin_triangles(jc, jm, W, H, cap)
        tb = tsetup.bin_triangles(tc, tm, W, H, cap)
        _check_bins({k: np.asarray(v) for k, v in jb._asdict().items()}, tb)
        assert bool(tb.overflow) == (cap == 1024)
        n = int(tb.counts.sum())
        ids = tb.pair_rows.reshape(-1, 16)[:n, 10].numpy()
        jids = jb.pair_rows.reshape(-1, 16)[:n, 10]
        assert (ids == 10).sum() == (np.asarray(jids) == 10).sum()


def test_hall_matches_tpurt():
    """The Sponza-class hall from inside at 160x96 (138 big triangles):
    the port's bins through its plain rasterizer against tpurt's bins
    through its interpret-mode kernel, every pixel's id equal, where the
    v1 records' pixel-scale cross products cost depth precision
    (decision 24). The hall's edge values cancel more than the teapot's,
    so interpret mode's contracted edge evaluations move u and v by up to
    1.2e-4 and 1/w by 2.2e-4 relative (measured): held to 2e-4 and 5e-4
    relative."""
    import tpurt.scenes as jscenes
    jm, tm = _meshes(jscenes.sponza_scene(20_000))
    jc = jscenes.sponza_interior_camera()
    tc = convert.camera(convert.numpy_fields(jc))
    n = int(np.asarray(jm.indices).shape[0])
    w, h = 160, 96
    jb = jsetup.bin_triangles(jc, jm, w, h, jsetup.default_cap_pairs(n))
    tb = tsetup.bin_triangles(tc, tm, w, h, tsetup.default_cap_pairs(n))
    _check_bins({k: np.asarray(v) for k, v in jb._asdict().items()}, tb)
    assert int(tb.big_count) > 0
    want = [np.asarray(x) for x in jrasterize(jb, w, h, interpret=True)]
    got = [x.numpy() for x in R.rasterize_tiles(tb, w, h)]
    np.testing.assert_array_equal(got[0], want[0])
    assert (want[0] >= 0).mean() > 0.9
    np.testing.assert_allclose(got[1:3], want[1:3], rtol=0, atol=2e-4)
    np.testing.assert_allclose(got[3], want[3], rtol=5e-4, atol=0)


def test_full_hall_v1_loses_depth_order_as_tpurt_does():
    """The witness of decision 24: the hall at config 1's 260k triangles
    from inside at 160x96. tpurt's own v1 rasterizer (interpret mode)
    against tpurt's own ``rasterize_rows`` covers the same pixels, but
    its ids differ on about 0.45% of them (measured: equal on 99.550%),
    the rate at which the port's v1 differs from the port's
    ``rasterize_rows`` on this mesh at 1080p (PERF.md). The port's v1 ids
    equal tpurt's v1 ids on all but 1 of the 15,360 pixels (a near-tie
    that interpret mode's contracted edge evaluations decide), held to
    decision 2's 99.9%."""
    import tpurt.raster.setup as js
    import tpurt.scenes as jscenes
    from tpurt.kernels.raster import rasterize_rows as jrows
    jm, tm = _meshes(jscenes.sponza_scene(260_000))
    jc = jscenes.sponza_interior_camera()
    tc = convert.camera(convert.numpy_fields(jc))
    n = int(np.asarray(jm.indices).shape[0])
    w, h = 160, 96
    v1 = np.asarray(jrasterize(js.bin_triangles(
        jc, jm, w, h, js.default_cap_pairs(n)), w, h, interpret=True)[0])
    rows = np.asarray(jrows(js.bin_rows(
        jc, jm, w, h, js.default_cap_rows(n)), w, h, interpret=True)[0])
    cov = (v1 >= 0) & (rows >= 0)
    assert ((v1 >= 0) != (rows >= 0)).mean() < 2e-3
    ids_equal = (v1 == rows)[cov].mean()
    assert 0.994 <= ids_equal < 0.999, ids_equal
    port = R.rasterize_tiles(tsetup.bin_triangles(
        tc, tm, w, h, tsetup.default_cap_pairs(n)), w, h)[0].numpy()
    assert (port == v1).mean() >= 0.999


def _record(tid, z):
    """A screen-filling v1 record at constant 1/w = z: edges (0, 0, 1)
    each, so d = 1 everywhere, and Dinv = z / 3."""
    rec = torch.zeros(16)
    rec[2] = rec[5] = rec[8] = 1.0
    rec[9] = z / 3.0
    rec[10] = tid
    return rec


def _bins(pair_recs, big_recs, runs, big_count=None):
    """Hand-made v1 bins: ``runs`` (start, count) per tile over the
    records ``pair_recs`` (8 a row), ``big_recs`` in the big list."""
    def rows(recs):
        recs = list(recs) + [_record(-1, 0.0)] * (-len(recs) % 8)
        return torch.stack(recs).reshape(-1, 128) if recs else \
            torch.zeros((1, 128))
    n = len(big_recs) if big_count is None else big_count
    return tsetup.RasterBins(
        pair_rows=rows(pair_recs),
        starts=torch.tensor([s for s, _ in runs], dtype=torch.int32),
        counts=torch.tensor([c for _, c in runs], dtype=torch.int32),
        big_rows=rows(big_recs), big_count=torch.tensor(n, dtype=torch.int32),
        overflow=torch.tensor(False))


def test_ties_keep_the_first_record():
    """Equal 1/w: the strict z-fight keeps the first record in stream
    order, the big list before the tile's run; a nearer record wins; a
    run may start inside a row."""
    near, far = 0.5, 0.25
    pairs = [_record(1, far), _record(2, far)] + \
        [_record(3 + i, far) for i in range(8)] + [_record(20, near)]
    bins = _bins(pairs, [], [(0, 2), (9, 2)])
    tri, u, v, invw = R.rasterize_tiles(bins, 64, 32)
    assert bool((tri[:, :32] == 1).all())
    assert bool((tri[:, 32:] == 20).all())
    assert torch.allclose(invw[:, 32:], torch.tensor(near))
    assert torch.allclose(u, torch.tensor(1.0 / 3.0))
    bins = _bins(pairs, [_record(7, far)], [(0, 2), (2, 1)])
    tri, _, _, _ = R.rasterize_tiles(bins, 64, 32)
    assert bool((tri == 7).all())


def test_records_are_masked_by_index():
    """Records past big_count, and the records of a row outside the
    tile's run, are never tested; edge tiles are cropped."""
    pairs = [_record(5, 0.9), _record(1, 0.2), _record(6, 0.9)]
    bins = _bins(pairs, [_record(8, 0.9)], [(1, 1), (0, 0)], big_count=0)
    tri, u, v, invw = R.rasterize_tiles(bins, 40, 20)
    assert tri.shape == (20, 40)
    assert bool((tri[:, :32] == 1).all()) and bool((tri[:, 32:] == -1).all())
    for x in (u, v, invw):
        assert bool((x[:, 32:] == 0.0).all())


def test_cuda_wrapper_refuses_cpu_tensors():
    bins = _bins([_record(1, 0.5)], [], [(0, 1)])
    before = R.rasterize_tiles_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        R.rasterize_tiles_cuda(bins, 32, 32)
    assert R.rasterize_tiles_cuda.launches == before


def test_default_cap_pairs():
    assert tsetup.default_cap_pairs(NTRIS) == jsetup.default_cap_pairs(NTRIS)
    assert tsetup.default_cap_pairs(287_176) == 1_769_472
