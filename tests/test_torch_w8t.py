"""The port's w8t walks (the plain versions, which the wrappers take for
CPU tensors) against the JAX package's transposed-leaf kernels in
interpret mode, at leaf 8, on ``tpurt``'s own WideBVHT carried across by
``tpurt_torch.convert``: teapot 1500, ``build_lbvh``, ``build_wide``,
``build_wide_t``, 64x32 camera rays.

- ``trace_closest`` against ``trace_closest_pallas``;
- ``trace_any`` against ``trace_any_pallas`` on one flat batch: the
  camera rays (t_max BIG on half of them, half the closest t on the
  rest) and shadow rays toward a directional light from the hits;
- ``trace_closest_attrs_t`` against ``trace_closest_attrs_pallas_t``
  without textures and, on a copy of the teapot with uv and layers from a
  seed (the same tree, other attribute rows), with them;
- ``trace_closest`` and ``trace_any`` against ``tpurt.bvh.traverse`` (the
  JAX package's portable walk) at 96x64.

Each JAX kernel runs once per module. Tolerances (tests/test_kernels.py's
for the w8t kernels; ROADMAP decisions 1, 2, 16): t to rtol 1e-5 / atol
1e-7; tri_id and the sorted index equal on >= 99.9% of hits; u, v and uv
to 1e-4; the layer and the triangle id exact; occlusion exact. The helpers
serve tests/test_torch_w8t_leaf16.py too.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.bvh.lbvh as jlbvh
import tpurt.bvh.wide as jwide
import tpurt.passes.shading as jshading
import tpurt.scenes as jscenes
from tpurt.bvh.traverse import traverse
from tpurt.camera import generate_rays as jgenerate_rays
from tpurt.kernels.traverse import (trace_any_pallas,
                                    trace_closest_attrs_pallas_t,
                                    trace_closest_pallas)
import tpurt_torch.convert as convert
import tpurt_torch.kernels.traverse as tr

from test_torch_multi_shadow import jax_checks_off
from test_torch_native import ensure_native_libraries
from test_torch_w8t_layout import textured_copy

torch.set_num_threads(1)
ensure_native_libraries()

W, H = 64, 32
LIGHT_DIR = np.float32([0.45, 0.8, 0.3]) / np.float32(
    np.linalg.norm([0.45, 0.8, 0.3]))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def w8t_scene(leaf: int):
    """tpurt's WideBVHT of the teapot at ``leaf`` with its transposed
    attribute rows, and the port's copies; camera rays."""
    mesh = jscenes.teapot_scene(1500)
    cam = jscenes.default_camera_for(mesh)
    with jax_checks_off():
        jb = jlbvh.build_lbvh(jnp.asarray(mesh.vertices),
                              jnp.asarray(mesh.indices), leaf_size=leaf)
        jt = jwide.build_wide_t(jwide.build_wide(jb), jb)
        jat = jshading.make_leaf_attr_rows_t(jb, mesh)
    o, d = jgenerate_rays(cam, W, H)
    return types.SimpleNamespace(
        mesh=mesh, cam=cam, jb=jb, jt=jt, jat=jat, o=o, d=d,
        acc=convert.wide_bvh_t(convert.numpy_fields(jt), "cpu"),
        tat=convert.attr_tables(*jat, "cpu"), to=_t(o), td=_t(d))


def any_rays(s):
    """One flat batch (N, 3): the camera rays, t_max BIG on a checkerboard
    and half the closest t elsewhere (no occluder before it), then shadow
    rays toward LIGHT_DIR from the hits pushed 1e-3 along it (inactive,
    t_max -1, off the hits)."""
    t, _, _ = tr.trace_closest(s.acc, s.to, s.td)
    hit = torch.isfinite(t)
    checker = (torch.arange(H)[:, None] + torch.arange(W)[None, :]) % 2 == 0
    cam_tmax = torch.where(checker | ~hit, 3.4e38, 0.5 * t)
    pos = s.to + s.td * torch.where(hit, t, 0.0)[..., None]
    ld = torch.from_numpy(LIGHT_DIR)
    so = pos + ld * 1e-3
    o = torch.cat([s.to.reshape(-1, 3), so.reshape(-1, 3)])
    d = torch.cat([s.td.reshape(-1, 3), ld.expand(H * W, 3)])
    tmax = torch.cat([cam_tmax.reshape(-1),
                      torch.where(hit, 3.4e38, -1.0).reshape(-1)])
    return o.contiguous(), d.contiguous(), tmax.contiguous()


def jax_results(s, textured_tables=None):
    """Each JAX kernel once: closest, any on ``any_rays``, attrs (and, with
    the textured tables, attrs with textured=True)."""
    o, d, tmax = any_rays(s)
    out = {"any_rays": (o, d, tmax)}
    with jax_checks_off():
        out["closest"] = [np.asarray(x) for x in trace_closest_pallas(
            s.jt, s.o, s.d, return_sorted=True, interpret=True)]
        out["any"] = np.asarray(trace_any_pallas(
            s.jt, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
            jnp.asarray(tmax.numpy()), interpret=True))
        out["attrs"] = {k: np.asarray(v) for k, v in
                        trace_closest_attrs_pallas_t(
                            s.jt, *s.jat, s.o, s.d, interpret=True).items()}
        if textured_tables is not None:
            out["attrs_tex"] = {k: np.asarray(v) for k, v in
                                trace_closest_attrs_pallas_t(
                                    s.jt, *textured_tables, s.o, s.d,
                                    textured=True, interpret=True).items()}
    return out


def check_hits(jt, jtid, tt, ttid):
    """Hit sets equal, t to rtol 1e-5 / atol 1e-7, misses (inf, -1),
    tri_id equal on >= 99.9% of hits."""
    valid = jtid >= 0
    np.testing.assert_array_equal(ttid >= 0, valid)
    assert valid.any() and not valid.all()
    np.testing.assert_allclose(tt[valid], jt[valid], rtol=1e-5, atol=1e-7)
    assert np.isinf(tt[~valid]).all() and (ttid[~valid] == -1).all()
    assert ((ttid == jtid) & valid).sum() >= 0.999 * valid.sum()
    return valid


def check_closest(s, jres):
    jt, jtid, jsidx = jres["closest"]
    tt, ttid, tsidx, counts = (x.numpy() for x in tr.trace_closest(
        s.acc, s.to, s.td, return_sorted=True))
    np.testing.assert_array_equal(counts, [0, 0])
    valid = check_hits(jt, jtid, tt, ttid)
    assert ((tsidx == jsidx) & valid).sum() >= 0.999 * valid.sum()
    assert (tsidx[~valid] == -1).all()


def check_any(s, jres):
    o, d, tmax = jres["any_rays"]
    occ, counts = tr.trace_any(s.acc, o, d, tmax)
    np.testing.assert_array_equal(counts.numpy(), [0, 0])
    np.testing.assert_array_equal(occ.numpy(), jres["any"])
    n = H * W
    assert not occ[:n][tmax[:n] < 1e38].any()       # nothing before t/2
    assert occ[:n].any() and occ[n:].any() and not occ[n:].all()


def check_attrs(s, jch, tables, textured: bool):
    """The channel dicts, and the raw layer channel of the plain version:
    -1 on every ray without textures."""
    tch, counts = tr.trace_closest_attrs_t(s.acc, s.to, s.td, tables,
                                           textured=textured)
    np.testing.assert_array_equal(counts.numpy(), [0, 0])
    t = {k: v.numpy() for k, v in tch.items()}
    valid = check_hits(jch["t"], jch["tri_id"], t["t"], t["tri_id"])
    same = (t["tri_id"] == jch["tri_id"]) & valid
    for key in ("u", "v", "uv"):
        np.testing.assert_allclose(t[key][same], jch[key][same], rtol=0,
                                   atol=1e-4, err_msg=key)
    for key in ("kd", "oct", "layer", "tri_id"):
        np.testing.assert_array_equal(t[key][same], jch[key][same],
                                      err_msg=key)
    np.testing.assert_allclose(t["gn"][same], jch["gn"][same], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(t["layer"][~valid], -1.0)
    args, kw, _, _ = tr.closest_attrs_inputs(s.acc, s.to, s.td, tables)
    fn = tr.w8t_closest_attrs_tex_reference if textured \
        else tr.w8t_closest_attrs_reference
    raw = fn(*args, **kw)[0]
    if textured:
        assert set(np.unique(t["layer"][valid])) >= {-1.0, 0.0, 2.0}
        # tpurt's textured walk starts the layer at 0 (lay0).
        assert (raw[:, 7][raw[:, 1] < 0] == 0.0).all()
    else:
        assert (raw[:, 7] == -1.0).all()
        assert (t["uv"] == 0.0).all()


def check_against_traverse(leaf: int):
    """The port's w8t walks against tpurt's portable walk of the same
    LBVH at 96x64."""
    s = w8t_scene(leaf)
    o, d = jgenerate_rays(s.cam, 96, 64)
    with jax_checks_off():
        jt_, jtid = (np.asarray(x) for x in traverse(s.jb, o, d))
    tt, ttid, counts = tr.trace_closest(s.acc, _t(o), _t(d))
    np.testing.assert_array_equal(counts.numpy(), [0, 0])
    valid = check_hits(jt_, jtid, tt.numpy(), ttid.numpy())
    occ, counts = tr.trace_any(s.acc, _t(o), _t(d),
                               torch.full((64, 96), 3.4e38))
    np.testing.assert_array_equal(counts.numpy(), [0, 0])
    np.testing.assert_array_equal(occ.numpy(), valid)


@pytest.fixture(scope="module")
def leaf8():
    s = w8t_scene(8)
    tex = textured_copy(s.mesh)
    with jax_checks_off():
        jtex = jshading.make_leaf_attr_rows_t(s.jb, tex)
    s.ttex = convert.attr_tables(*jtex, "cpu")
    return s, jax_results(s, jtex)


def test_w8t_closest_matches_pallas(leaf8):
    check_closest(*leaf8)


def test_w8t_any_matches_pallas(leaf8):
    check_any(*leaf8)


def test_w8t_attrs_match_pallas(leaf8):
    s, jres = leaf8
    check_attrs(s, jres["attrs"], s.tat, textured=False)


def test_w8t_textured_attrs_match_pallas(leaf8):
    s, jres = leaf8
    check_attrs(s, jres["attrs_tex"], s.ttex, textured=True)


def test_w8t_walks_match_the_portable_traversal():
    check_against_traverse(8)


def test_trace_closest_on_w8t_ignores_seeded(leaf8, monkeypatch):
    """tpurt's trace_closest_pallas takes the WideBVHT branch before it
    looks at ``seeded``: no first-hit walk runs, and return_sorted and
    gather_tri_id are honoured."""
    s, _ = leaf8

    def no_seed(*a, **k):
        raise AssertionError("the seed walk ran on a WideBVHT")
    monkeypatch.setattr(tr, "first_hit_reference", no_seed)
    t, tid, sidx, counts = tr.trace_closest(s.acc, s.to, s.td,
                                            return_sorted=True)
    t2, none, sidx2, counts2 = tr.trace_closest(
        s.acc, s.to, s.td, return_sorted=True, gather_tri_id=False,
        seeded=True)
    assert none is None
    assert torch.equal(t, t2) and torch.equal(sidx, sidx2)
    assert torch.equal(counts, counts2)
    t3, tid3, counts3 = tr.trace_closest(s.acc, s.to, s.td, seeded=True)
    assert torch.equal(t, t3) and torch.equal(tid, tid3)
    with pytest.raises(ValueError, match="trace_closest_attrs_t"):
        tr.trace_closest_attrs(s.acc, s.to, s.td, s.tat)
