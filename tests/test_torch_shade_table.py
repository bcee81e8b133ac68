"""The port's packed shade table and its per-pixel decode against the JAX
package's (``tpurt/passes/shading.py``), on the same converted SBVH.

Tolerances: the table equal bit for bit, the id lane included (it holds
int32 bits, compared through int32 views); ``table_tri_id`` equal.
``barycentrics_from_position`` and ``shade_from_table`` run under
``jax.jit``, as the frame runs them, where XLA's CPU compiler contracts
the dot products and the 2x2 solve into fused multiply-adds (and divides
by 255 as a product) while the port evaluates them unfused, as its CUDA
code does. Measured on these rays at leaf 8 and 14: u 1.8e-7, v 2.4e-7,
the smooth normal 3.0e-7, the geometric normal and the albedo 6.0e-8
(run eagerly, with no contraction, all but the geometric normal agree
exactly). Held to 1e-6 (u, v, normals) and 2e-7 (albedo).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.bvh.sah as jsah
import tpurt.passes.shading as jshading
import tpurt.scenes as jscenes
from tpurt.camera import generate_rays as jgenerate_rays
from tpurt.kernels.traverse import trace_closest_pallas
import tpurt_torch.convert as convert
import tpurt_torch.passes.shading as tshading

from test_torch_multi_shadow import jax_checks_off
from test_torch_native import ensure_native_libraries

torch.set_num_threads(1)
ensure_native_libraries()


def _tables(leaf: int):
    """tpurt's SBVH of the teapot and both packages' shade tables of it."""
    mesh = jscenes.teapot_scene(1500)
    bvh = jsah.build_sah_lbvh(mesh, leaf)
    jst = np.asarray(jax.jit(jshading.make_shade_table)(bvh, mesh))
    tst = tshading.make_shade_table(
        convert.lbvh(convert.numpy_fields(bvh), "cpu"),
        convert.mesh(convert.numpy_fields(mesh)))
    return mesh, bvh, jst, tst


@pytest.fixture(scope="module", params=[8, 14])
def tables(request):
    return _tables(request.param)


def test_shade_table_equals_jax_bit_for_bit(tables):
    _, bvh, jst, tst = tables
    assert tst.dtype == torch.float32 and tuple(tst.shape) == jst.shape
    assert jst.shape == (np.asarray(bvh.tri_id).shape[0], 24)
    np.testing.assert_array_equal(tst.view(torch.int32).numpy(),
                                  jst.view(np.int32))
    np.testing.assert_array_equal(tst.view(torch.int32)[:, 16].numpy(),
                                  np.asarray(bvh.tri_id))


def test_shade_table_from_the_converted_table_is_the_same(tables):
    """convert.shade_table carries tpurt's table across unchanged."""
    _, _, jst, tst = tables
    carried = convert.shade_table(jst, "cpu")
    assert torch.equal(carried.view(torch.int32), tst.view(torch.int32))


BIG_IDS = np.array([0, 1, 2 ** 23 - 1, 2 ** 23, 2 ** 23 + 1, 2 ** 24 + 3,
                    0x7F800001, 0x7FC00000, 0x7FFFFFFF, 0x00000007],
                   np.int32)


def test_id_lane_keeps_its_bits_at_and_above_2_23():
    """Ids whose float bit patterns are denormals (1, 7) or NaNs
    (0x7F800001 and up) survive the row gather and table_tri_id, as in
    tpurt's bitcast."""
    rows = np.zeros((len(BIG_IDS), 24), np.float32)
    rows[:, 16] = BIG_IDS.view(np.float32)
    table = torch.from_numpy(rows.copy())
    sidx = torch.tensor([[9, 8, 7, 6, 5], [4, 3, 2, 1, 0]], dtype=torch.int32)
    valid = torch.ones(sidx.shape, dtype=torch.bool)
    valid[1, 4] = False
    got = tshading.table_tri_id(tshading.gather_table_rows(table, sidx),
                                valid)
    want = jshading.table_tri_id(jnp.asarray(rows)[jnp.asarray(sidx.numpy())],
                                 jnp.asarray(valid.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1, 4] == -1 and got[0, 0] == 0x00000007
    assert got[0, 1] == 0x7FFFFFFF


@pytest.fixture(scope="module")
def hits():
    """tpurt's closest hit of 64x32 camera rays (interpret mode) at leaf 8,
    the hit positions and the gathered rows of tpurt's table."""
    mesh, bvh, jst, _ = _tables(8)
    from tpurt.bvh.wide import build_wide
    acc = build_wide(bvh, from_node_boxes=True)
    o, d = jgenerate_rays(jscenes.default_camera_for(mesh), 64, 32)
    with jax_checks_off():
        t, _, sidx = trace_closest_pallas(acc, o, d, return_sorted=True,
                                          interpret=True)
    t, sidx = np.asarray(t), np.asarray(sidx)
    valid = sidx >= 0
    pos = np.asarray(o) + np.asarray(d) * np.where(valid, t, 0.0)[..., None]
    rows = jst[np.clip(sidx, 0, jst.shape[0] - 1)]
    return rows, pos.astype(np.float32), valid


def test_barycentrics_match_jax(hits):
    rows, pos, valid = hits
    ju, jv = jax.jit(jshading.barycentrics_from_position)(
        rows[..., 0:3], rows[..., 3:6], rows[..., 6:9], pos)
    tr = torch.from_numpy(rows)
    tu, tv = tshading.barycentrics_from_position(
        tr[..., 0:3], tr[..., 3:6], tr[..., 6:9], torch.from_numpy(pos))
    assert valid.any()
    np.testing.assert_allclose(tu.numpy()[valid], np.asarray(ju)[valid],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tv.numpy()[valid], np.asarray(jv)[valid],
                               atol=1e-6, rtol=0)


def test_shade_from_table_matches_jax(hits):
    rows, pos, valid = hits
    j = jax.jit(jshading.shade_from_table)(rows, pos, valid)
    t = tshading.shade_from_table(torch.from_numpy(rows),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(valid))
    for k, atol in (("u", 1e-6), ("v", 1e-6), ("normal", 1e-6),
                    ("gnormal", 1e-6), ("albedo", 2e-7)):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   atol=atol, rtol=0, err_msg=k)
    assert not t["normal"].numpy()[~valid].any()
