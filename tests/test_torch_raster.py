"""The tile rasterizer (``tpurt_torch/kernels/raster.py``): its plain
version against ``tpurt``'s ``rasterize_rows`` in Pallas interpret mode on
``tpurt``'s own bins, its tie order and cull, and the CUDA launch
boundary.

Tolerances and why: on identical bins the valid masks and the ids are
equal, and so are the geometric normal and albedo lanes the z-fight
copies. Interpret mode runs the kernel body through XLA's CPU compiler,
which contracts the edge evaluations into fused multiply-adds (the CUDA
kernel and the plain version are built without them), so u and v agree
to 2e-5, 1/w to 2e-5 relative and the normals to 1e-5 (measured at most
5.7e-6, 4.9e-6 and 1.4e-6 on the teapot at 96x64)."""

import jax
import numpy as np
import pytest
import torch

import tpurt.raster.setup as jsetup
from tpurt.kernels.raster import rasterize_rows as jrasterize
from tpurt.scenes import default_camera_for as jcamera_for
from tpurt.scenes import teapot_scene as jteapot
from tpurt.types import Camera as JCamera
from tpurt_torch import convert
from tpurt_torch.kernels import raster as R
from tpurt_torch.raster.setup import RasterRows, bin_rows, pixel_constants

torch.set_num_threads(1)

W, H = 96, 64
NTRIS = 1500


def _cameras(jm):
    v = np.asarray(jm.vertices)
    c = v.mean(axis=0)
    return {"outside": jcamera_for(jm),
            "inside": JCamera.look_at(c + [0.01, 0.05, 0.01],
                                      c + [1.2, 0.2, 0.4], fov_y_deg=70)}


@pytest.fixture(scope="module")
def ref():
    """tpurt's bins and interpret-mode raster for each camera (about 25 s
    of interpret mode per camera)."""
    jm = jax.device_put(jteapot(NTRIS))
    out = {}
    for name, jc in _cameras(jm).items():
        jb = jsetup.bin_rows(jc, jm, W, H, jsetup.default_cap_rows(NTRIS))
        tri, attrs = jrasterize(jb, W, H, interpret=True)
        out[name] = dict(bins={k: np.asarray(v)
                               for k, v in jb._asdict().items()},
                         tri=np.asarray(tri), attrs=np.asarray(attrs),
                         camera=convert.camera(convert.numpy_fields(jc)))
    return out


def _check(tri, attrs, want_tri, want_attrs, min_same=1.0):
    valid = want_tri >= 0
    np.testing.assert_array_equal(tri >= 0, valid)
    same = (tri == want_tri) & valid
    assert same.sum() >= min_same * valid.sum()
    assert valid.mean() > 0.3
    np.testing.assert_array_equal(attrs[:, ~valid], 0.0)
    a, b = attrs[:, same], want_attrs[:, same]
    np.testing.assert_allclose(a[0:2], b[0:2], rtol=0, atol=2e-5)
    np.testing.assert_allclose(a[2], b[2], rtol=2e-5, atol=0)
    np.testing.assert_allclose(a[3:6], b[3:6], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(a[6:12], b[6:12])


@pytest.mark.parametrize("cam", ["outside", "inside"])
def test_plain_matches_tpurt_on_its_bins(ref, cam):
    r = ref[cam]
    tri, attrs = R.rasterize_rows(convert.raster_rows(r["bins"], "cpu"),
                                  W, H)
    assert tri.dtype == torch.int32 and tri.shape == (H, W)
    assert attrs.dtype == torch.float32 and attrs.shape == (12, H, W)
    _check(tri.numpy(), attrs.numpy(), r["tri"], r["attrs"])


@pytest.mark.parametrize("cam", ["outside", "inside"])
def test_port_bins_rasterize_like_tpurt(ref, cam):
    """The port's own binning and plain rasterizer against tpurt's whole
    chain: the binning's rounding (test_torch_raster_setup) may move an
    id at a shared edge, on at most 0.1% of the valid pixels."""
    r = ref[cam]
    mesh = convert.mesh(convert.numpy_fields(jteapot(NTRIS))).on("cpu")
    bins = bin_rows(r["camera"], mesh, W, H, jsetup.default_cap_rows(NTRIS))
    tri, attrs = R.rasterize_rows(bins, W, H)
    valid = r["tri"] >= 0
    np.testing.assert_array_equal(tri.numpy() >= 0, valid)
    same = (tri.numpy() == r["tri"]) & valid
    assert same.sum() >= 0.999 * valid.sum()
    np.testing.assert_allclose(attrs.numpy()[2][same], r["attrs"][2][same],
                               rtol=2e-4, atol=0)


def _record(tid, z, rect=(0.0, 0.0, 1e6, 1e6)):
    """A screen-filling record at constant 1/w = z: edges (0, 0, 1) each,
    so d = 1 everywhere, and Dinv = z / 3."""
    rec = torch.zeros(32)
    rec[2] = rec[5] = rec[8] = 1.0
    rec[9] = z / 3.0
    rec[10] = tid
    rec[12:21] = torch.tensor([0.0, 1.0, 0.0] * 3)
    rec[21:24] = torch.tensor([0.0, 0.0, 1.0])
    rec[24:27] = tid / 10.0
    rec[27:31] = torch.tensor(rect)
    return rec


def _bins(pair_recs, big_recs, ntiles, runs):
    """Hand-made bins: ``runs`` (start, count) per tile over the rows of
    ``pair_recs`` (4 records a row), ``big_recs`` in the big list."""
    def rows(recs):
        recs = list(recs) + [_record(-1, 0.0)] * (-len(recs) % 4)
        return torch.stack(recs).reshape(-1, 128) if recs else \
            torch.zeros((1, 128))
    big = rows(big_recs)
    return RasterRows(
        pair_rows=rows(pair_recs),
        row_starts=torch.tensor([s for s, _ in runs], dtype=torch.int32),
        row_counts=torch.tensor([c for _, c in runs], dtype=torch.int32),
        big_rows=big,
        big_nrows=torch.tensor(-(-len(big_recs) // 4), dtype=torch.int32),
        overflow=torch.tensor(False))


def test_ties_keep_the_first_record():
    """Equal 1/w: the strict z-fight keeps the first record in stream
    order, the big list before the pair run; a nearer record wins."""
    near, far = 0.5, 0.25
    pairs = [_record(1, far), _record(2, far), _record(-1, 0.9),
             _record(3, far), _record(4, near), _record(5, near)]
    bins = _bins(pairs, [], 2, [(0, 1), (1, 1)])
    tri, attrs = R.rasterize_rows(bins, 64, 32)
    assert bool((tri[:, :32] == 1).all()) and bool((tri[:, 32:] == 4).all())
    assert torch.allclose(attrs[2, :, 32:], torch.tensor(near))
    bins = _bins(pairs, [_record(7, far)], 2, [(0, 1), (1, 1)])
    tri, _ = R.rasterize_rows(bins, 64, 32)
    assert bool((tri[:, :32] == 7).all()) and bool((tri[:, 32:] == 4).all())


def test_big_list_is_culled_by_tile_rect():
    """A big-list record whose rect holds only tile (1, 0) rasterizes only
    there; a dead slot (id -1) rasterizes nowhere."""
    big = [_record(9, 0.5, rect=(1.0, 0.0, 1.0, 0.0)), _record(-1, 0.9)]
    bins = _bins([], big, 4, [(0, 0)] * 4)
    tri, attrs = R.rasterize_rows(bins, 64, 40)
    assert bool((tri[:32, 32:] == 9).all())
    assert int((tri == 9).sum()) == 32 * 32 and int((tri == -1).sum()) == \
        64 * 40 - 32 * 32
    np.testing.assert_array_equal(attrs[:, tri < 0].numpy(), 0.0)
    # u = d1 / dsum = 1/3, the normal (0, 1, 0), the albedo 0.9.
    hit = tri >= 0
    assert torch.allclose(attrs[0][hit], torch.tensor(1.0 / 3.0))
    assert bool((attrs[4][hit] == 1.0).all())
    assert torch.allclose(attrs[9][hit], torch.tensor(0.9))


def test_cuda_wrapper_refuses_cpu_tensors():
    bins = _bins([_record(1, 0.5)], [], 1, [(0, 1)])
    before = R.rasterize_rows_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        R.rasterize_rows_cuda(bins, 32, 32)
    assert R.rasterize_rows_cuda.launches == before
    assert R.RASTER_KERNELS == (R.rasterize_rows_cuda,
                                R.rasterize_rows16_cuda,
                                R.rasterize_tiles_cuda)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    bins = _bins([_record(1, 0.5)], [], 1, [(0, 1)])
    before = R.rasterize_rows_cuda.launches
    tri, _ = R.rasterize_rows(bins, 32, 32)
    assert bool((tri == 1).all())
    assert R.rasterize_rows_cuda.launches == before


def test_pixel_constants_are_float32():
    for w in (96, 1920, 3840, 7):
        hw, iw, hh, ih = pixel_constants(w, 64)
        assert iw == float(np.float32(1.0 / w)) and hw == 0.5 * w
        assert ih == float(np.float32(1.0 / 64)) and hh == 32.0
