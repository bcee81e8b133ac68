"""The port's plain closest hit (``closest_reference``, which
``trace_closest`` takes for CPU tensors) against the JAX package's
``trace_closest_pallas(..., return_sorted=True)`` in interpret mode
(``_closest_hit_kernel_w8_b``), on the same accel: 64x32 camera rays at
leaf 8, once with tpurt's default t_max and once with a per-ray t_max.

Tolerances (ROADMAP decision 2): t to 1e-6; tri_id equal on >= 99.9% of
valid pixels (a tie on a shared edge may pick the other triangle); misses
(inf, -1) in the same places. sidx is not compared: SBVH splits reference
one triangle from several leaves.
"""

import numpy as np
import pytest
import torch

import tpurt_torch.kernels.traverse as tr
from tpurt.kernels.traverse import trace_closest_pallas

from test_torch_multi_shadow import jax_checks_off, parity_scene

torch.set_num_threads(1)


def closest_case(leaf: int, per_ray_t_max: bool = False):
    """(tpurt's (t, tri_id, sidx), the port's (t, tri_id, sidx, counts))
    on the parity scene. ``per_ray_t_max``: each ray's t_max is half
    tpurt's closest t on a checkerboard of pixels (those rays must miss
    what they hit) and 1.001 times it on the others (1e3 where nothing
    was hit)."""
    s = parity_scene(leaf)
    t_max = tr._BIG
    with jax_checks_off():
        if per_ray_t_max:
            t0 = np.asarray(trace_closest_pallas(s.acc, s.o, s.d,
                                                 interpret=True)[0])
            yy, xx = np.indices(t0.shape)
            scale = np.where((yy + xx) % 2 == 0, 0.5, 1.001)
            t_max = np.where(np.isfinite(t0), t0 * scale,
                             1e3).astype(np.float32)
        jres = trace_closest_pallas(s.acc, s.o, s.d, t_max=t_max,
                                    return_sorted=True, interpret=True)
    tres = tr.trace_closest(s.twide, s.to, s.td,
                            t_max=torch.as_tensor(t_max),
                            return_sorted=True)
    return ([np.asarray(x) for x in jres],
            [x.numpy() if x is not None else None for x in tres])


def check_closest(jres, tres):
    jt, jtid, jsidx = jres
    tt, ttid, tsidx, counts = tres
    np.testing.assert_array_equal(counts, [0, 0])
    valid = jsidx >= 0
    np.testing.assert_array_equal(tsidx >= 0, valid)
    np.testing.assert_array_equal(ttid >= 0, valid)
    assert valid.any() and not valid.all()
    np.testing.assert_allclose(tt[valid], jt[valid], rtol=1e-6, atol=1e-6)
    assert np.isinf(tt[~valid]).all() and np.isinf(jt[~valid]).all()
    assert (tsidx[~valid] == -1).all() and (ttid[~valid] == -1).all()
    same = (ttid == jtid) & valid
    assert same.sum() >= 0.999 * valid.sum()


@pytest.fixture(scope="module")
def leaf8():
    return closest_case(8)


def test_closest_matches_pallas_leaf8(leaf8):
    check_closest(*leaf8)


def test_closest_gather_tri_id_and_table_key_leaf8(leaf8):
    """gather_tri_id=False leaves tri_id to the table and returns the same
    t and sidx; the default return is (t, tri_id, counts)."""
    s = parity_scene(8)
    t, tid, sidx, counts = tr.trace_closest(s.twide, s.to, s.td,
                                            return_sorted=True,
                                            gather_tri_id=False)
    _, (tt, ttid, tsidx, _) = leaf8
    assert tid is None
    np.testing.assert_array_equal(t.numpy(), tt)
    np.testing.assert_array_equal(sidx.numpy(), tsidx)
    t2, tid2, counts2 = tr.trace_closest(s.twide, s.to, s.td)
    np.testing.assert_array_equal(tid2.numpy(), ttid)
    with pytest.raises(ValueError, match="return_sorted"):
        tr.trace_closest(s.twide, s.to, s.td, gather_tri_id=False)


def test_closest_honours_a_per_ray_t_max(leaf8):
    """Rays capped at half their closest t miss; rays capped just past it
    keep their hit: both packages agree ray for ray."""
    jres, tres = closest_case(8, per_ray_t_max=True)
    check_closest(jres, tres)
    hit_before = leaf8[0][2] >= 0
    yy, xx = np.indices(hit_before.shape)
    capped = hit_before & ((yy + xx) % 2 == 0)
    assert capped.any() and not (tres[2][capped] >= 0).any()
    kept = hit_before & ~capped
    np.testing.assert_array_equal(tres[2][kept] >= 0, True)


def test_closest_equals_the_attribute_walk_leaf8(leaf8):
    """The plain walk and the attribute-tracked walk (CLOSEST) visit the
    same boxes in the same order: t, sidx and tri_id equal exactly."""
    s = parity_scene(8)
    ch, _ = tr.trace_closest_attrs(s.twide, s.to, s.td, s.tat)
    _, (tt, ttid, tsidx, _) = leaf8
    np.testing.assert_array_equal(ch["t"].numpy(), tt)
    np.testing.assert_array_equal(ch["sidx"].numpy(), tsidx)
    np.testing.assert_array_equal(ch["tri_id"].numpy(), ttid)
