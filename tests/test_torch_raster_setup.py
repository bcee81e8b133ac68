"""The rasterizer's front end (``tpurt_torch/raster/setup.py``) against
``tpurt/raster/setup.py`` on the same numpy mesh and cameras: the clip
transform, the records, the binning and its capacities.

Tolerances and why: the integer outputs (row starts and counts, big rows,
overflow) and every lane gathered or copied (ids, vertex normals, albedo,
tile rects) are equal. XLA on the CPU contracts the clip transform's dot
products and the records' cross products into fused multiply-adds, and
the port does not, so the float lanes agree to rounding: clip coordinates
to 1e-6 of their scale, edge vectors to 1e-4 of the record's largest edge
component, the geometric normal to 1e-6; 1/det to 1e-2 relative, because
the determinant of a triangle seen nearly edge-on cancels and magnifies
the edges' rounding (measured up to 6.3e-3 on the teapot at 96x64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.raster.setup as jsetup
import tpurt_torch.raster.setup as tsetup
from tpurt.scenes import default_camera_for as jcamera_for
from tpurt.scenes import teapot_scene as jteapot
from tpurt.types import Camera as JCamera
from tpurt_torch import convert

torch.set_num_threads(1)

W, H = 96, 64
NTRIS = 1500


@pytest.fixture(scope="module")
def scene():
    jm = jteapot(NTRIS)
    tm = convert.mesh(convert.numpy_fields(jm)).on("cpu")
    return jax.device_put(jm), tm


def _cameras(jm):
    """An outside view and one from inside the mesh, where triangles cross
    the eye plane and the big list is not empty (tests/test_raster.py)."""
    v = np.asarray(jm.vertices)
    c = v.mean(axis=0)
    return {"outside": jcamera_for(jm),
            "inside": JCamera.look_at(c + [0.01, 0.05, 0.01],
                                      c + [1.2, 0.2, 0.4], fov_y_deg=70)}


@pytest.fixture(scope="module")
def bins(scene):
    """Both packages' bins for each camera at the default capacity."""
    jm, tm = scene
    out = {}
    for name, jc in _cameras(jm).items():
        tc = convert.camera(convert.numpy_fields(jc))
        cap = jsetup.default_cap_rows(NTRIS)
        out[name] = (jsetup.bin_rows(jc, jm, W, H, cap),
                     tsetup.bin_rows(tc, tm, W, H, cap), jc, tc)
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_records(a, b):
    """Records f32[n, 32] of the two packages (see the module docstring)."""
    for lanes in ((10, 11), tuple(range(12, 21)), (24, 25, 26),
                  (27, 28, 29, 30, 31)):
        np.testing.assert_array_equal(a[:, lanes], b[:, lanes])
    ea = a[:, 0:9].reshape(-1, 3, 3)
    eb = b[:, 0:9].reshape(-1, 3, 3)
    scale = np.maximum(np.abs(ea).max(axis=(1, 2)), 1e-30)
    assert (np.abs(ea - eb).max(axis=(1, 2)) <= 1e-4 * scale).all()
    np.testing.assert_allclose(b[:, 9], a[:, 9], rtol=1e-2, atol=0)
    np.testing.assert_allclose(b[:, 21:24], a[:, 21:24], rtol=0, atol=1e-6)


@pytest.mark.parametrize("cam", ["outside", "inside"])
def test_clip_transform_matches(scene, cam):
    jm, tm = scene
    jc = _cameras(jm)[cam]
    a = np.asarray(jsetup.clip_transform(jc, W, H, jm.vertices))
    b = tsetup.clip_transform(convert.camera(convert.numpy_fields(jc)), W,
                              H, tm.vertices).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * np.abs(a).max())


@pytest.mark.parametrize("cam", ["outside", "inside"])
def test_bin_rows_matches(bins, cam):
    jb, tb, _, _ = bins[cam]
    for name in ("row_starts", "row_counts", "big_nrows", "overflow"):
        a, b = _np(getattr(jb, name)), _np(getattr(tb, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert _np(tb.pair_rows).shape == _np(jb.pair_rows).shape
    assert _np(tb.big_rows).shape == _np(jb.big_rows).shape
    live = int(_np(tb.row_counts).sum())
    assert live > 0 and not bool(_np(tb.overflow))
    _check_records(_np(jb.pair_rows)[:live].reshape(-1, 32),
                   _np(tb.pair_rows)[:live].reshape(-1, 32))
    nbig = int(_np(tb.big_nrows))
    if cam == "inside":
        assert nbig > 0
    _check_records(_np(jb.big_rows).reshape(-1, 32),
                   _np(tb.big_rows).reshape(-1, 32))


@pytest.mark.parametrize("cap_pairs,cap_big", [(64, 2048), (4096, 8)])
def test_capacity_overflow_matches(scene, cap_pairs, cap_big):
    """A pair or big-list capacity too small for the inside view: both set
    the flag and keep the same first pairs and big records."""
    jm, tm = scene
    jc = _cameras(jm)["inside"]
    tc = convert.camera(convert.numpy_fields(jc))
    jb = jsetup.bin_rows(jc, jm, W, H, cap_pairs, cap_big=cap_big)
    tb = tsetup.bin_rows(tc, tm, W, H, cap_pairs, cap_big=cap_big)
    assert bool(_np(jb.overflow)) and bool(_np(tb.overflow))
    for name in ("row_starts", "row_counts", "big_nrows"):
        np.testing.assert_array_equal(_np(getattr(tb, name)),
                                      _np(getattr(jb, name)), err_msg=name)
    live = int(_np(tb.row_counts).sum())
    _check_records(_np(jb.pair_rows)[:live].reshape(-1, 32),
                   _np(tb.pair_rows)[:live].reshape(-1, 32))
    _check_records(_np(jb.big_rows).reshape(-1, 32),
                   _np(tb.big_rows).reshape(-1, 32))


@pytest.mark.parametrize("n", [1, 4, 6, 1500])
def test_pack_rows32_matches(n):
    rec = np.random.default_rng(n).normal(size=(n, 32)).astype(np.float32)
    a = np.asarray(jsetup._pack_rows32(jnp.asarray(rec)))
    b = tsetup._pack_rows32(torch.from_numpy(rec)).numpy()
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("num_tris", [4, 1500, 30_000, 287_176, 2_000_000])
def test_default_cap_rows_matches(num_tris):
    assert tsetup.default_cap_rows(num_tris) == \
        jsetup.default_cap_rows(num_tris)


@pytest.mark.parametrize("share", [0.0, 0.01, 0.5, 1.0])
def test_compact_is_nonzero_with_size(share):
    """The scatter compaction equals jnp.nonzero(size=, fill_value=),
    with too few and too many set entries."""
    mask = np.random.default_rng(7).random(1000) < share
    for size in (16, 700):
        want = np.asarray(jnp.nonzero(jnp.asarray(mask), size=size,
                                      fill_value=1000)[0])
        got = tsetup._compact(torch.from_numpy(mask), size, 1000).numpy()
        np.testing.assert_array_equal(got, want)


def test_pairs_are_tile_sorted_and_stable(bins):
    """Within a tile the pair rows keep table order (the stable sort):
    their first live ids increase."""
    _, tb, _, _ = bins["outside"]
    rows = tb.pair_rows.reshape(-1, 4, 32)
    for s, c in zip(tb.row_starts.tolist(), tb.row_counts.tolist()):
        ids = rows[s:s + c, :, 10]
        first = torch.where(ids >= 0, ids, float("inf")).amin(dim=1)
        assert bool((first[1:] > first[:-1]).all())
