"""The port's textured (attrs=2) walks, the plain PyTorch versions of the
six attribute kernels' ``textured=True`` variants, against the JAX
package's Pallas kernels in interpret mode (``textured=True``, the zero
PRNG stream for the soft modes, which the port runs as
``zero_stream=True``), on the SAME accel and attribute rows carried
across by tpurt_torch.convert: teapot 1500 with a box-projected uv, a
three-layer atlas and per-triangle layers (-1 included), leaf 8, 32x32
camera rays (one packet), spp 2. HARD, MULTI and CLOSEST here, SOFT,
PSOFT and SOFT_MULTI in test_torch_textured_kernels_soft.py.

Tolerances (decisions 1 and 2 of ROADMAP.md): t to rtol 1e-6; tri_id on
>= 99.9% of valid pixels; u, v and the interpolated uv to 1e-4 (XLA's CPU
compiler contracts the reference's products into fused multiply-adds,
the port does not); layer and the other attribute channels exact or to
1e-6 where the winning triangle agrees; occlusion, mask bits and counts
off on at most 1e-3 of valid pixels. The textured channels must also
equal the attrs=1 walk's everywhere but uv and layer.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.bvh.sah as jsah
import tpurt.bvh.wide as jwide
import tpurt.kernels.traverse as jtr
import tpurt.scenes as jscenes
from tpurt.camera import generate_rays as jgenerate_rays
from tpurt.passes.shading import make_leaf_attr_rows as jmake_leaf_attr_rows
import tpurt_torch.convert as convert
import tpurt_torch.kernels.traverse as ttr

from test_torch_multi_shadow import FILL_DIR, jax_checks_off, np_channels
from test_torch_native import ensure_native_libraries
from test_torch_soft_shadow import CONE_COS, RADIUS, SEED, SPP
from test_torch_traverse import BIAS, LIGHT_DIR, LIGHT_POS

torch.set_num_threads(1)
ensure_native_libraries()

# This file's modes; the sampling ones run in
# test_torch_textured_kernels_soft.py, which imports the checks from here
# (two files, so that xdist spreads their interpret-mode fixtures).
MODES = ("closest_shadow", "closest_multi_shadow", "closest_attrs")


def textured_teapot(n: int = 1500, layers: int = 3):
    """tpurt's teapot with a box projection of world position as uv (REPEAT
    wrapping beyond [0, 1)), random atlas layers and per-triangle layers
    in [-1, layers)."""
    mesh = jscenes.teapot_scene(n)
    rng = np.random.default_rng(21)
    v = np.asarray(mesh.vertices)
    uv = np.stack([v[:, 0] * 0.9 + v[:, 2] * 0.4, v[:, 1] * 1.2 - 0.3],
                  axis=1).astype(np.float32)
    return dataclasses.replace(
        mesh, uv=uv, tex_atlas=rng.random((layers, 8, 8, 3),
                                          dtype=np.float32),
        tri_tex=rng.integers(-1, layers, mesh.num_triangles)
        .astype(np.int32))


@pytest.fixture(scope="module")
def scene():
    mesh = textured_teapot()
    assert mesh.textured
    cam = jscenes.default_camera_for(mesh)
    bvh = jsah.build_sah_lbvh(mesh, 8)
    wide = jwide.build_wide(bvh, from_node_boxes=True)
    at = jmake_leaf_attr_rows(bvh, mesh)
    acc = jwide.order_children_for_point(wide, cam.position)
    o, d = jgenerate_rays(cam, 32, 32)
    return types.SimpleNamespace(
        acc=acc, at=at, o=o, d=d,
        twide=convert.wide_bvh(convert.numpy_fields(acc), "cpu"),
        tat=convert.attr_tables(at[0], at[1], "cpu"),
        to=torch.from_numpy(np.array(o)), td=torch.from_numpy(np.array(d)))


def _jax(mode, s):
    """tpurt's textured kernel of ``mode`` -> (channels, *shadow outputs)."""
    kw = dict(attr_tables=s.at, textured=True, interpret=True)
    with jax_checks_off():
        if mode == "closest_shadow":
            r = jtr.trace_closest_shadow_pallas(
                s.acc, s.o, s.d, jnp.asarray(LIGHT_DIR), BIAS, **kw)
        elif mode == "closest_multi_shadow":
            r = jtr.trace_closest_multi_shadow_pallas(
                s.acc, s.o, s.d, [(jnp.asarray(LIGHT_DIR), None),
                                  (None, jnp.asarray(LIGHT_POS))], BIAS,
                **kw)
        elif mode == "closest_soft_shadow":
            r = jtr.trace_closest_soft_shadow_pallas(
                s.acc, s.o, s.d, jnp.asarray(LIGHT_DIR),
                jnp.asarray(CONE_COS), SPP, SEED, BIAS, **kw)
        elif mode == "closest_point_soft_shadow":
            r = jtr.trace_closest_point_soft_shadow_pallas(
                s.acc, s.o, s.d, jnp.asarray(LIGHT_POS), jnp.float32(RADIUS),
                SPP, SEED, BIAS, **kw)
        elif mode == "closest_soft_multi_shadow":
            r = jtr.trace_closest_soft_multi_shadow_pallas(
                s.acc, s.o, s.d, ("cone", jnp.asarray(LIGHT_DIR),
                                  jnp.float32(CONE_COS)),
                [jnp.asarray(FILL_DIR)], SPP, SEED, BIAS, **kw)
        else:
            r = (jtr.trace_closest_attrs_pallas(
                s.acc, s.at[0], s.at[1], s.o, s.d, textured=True,
                interpret=True),)
    return (np_channels(r[0]),) + tuple(np.asarray(x) for x in r[1:])


def _port(mode, s, textured=True):
    """The port's wrapper of ``mode`` on the CPU -> (channels, *shadow
    outputs, walk counts)."""
    kw = dict(attr_tables=s.tat, textured=textured)
    zs = dict(zero_stream=True)
    if mode == "closest_shadow":
        r = ttr.trace_closest_shadow(s.twide, s.to, s.td, LIGHT_DIR, BIAS,
                                     **kw)
    elif mode == "closest_multi_shadow":
        r = ttr.trace_closest_multi_shadow(
            s.twide, s.to, s.td, [(LIGHT_DIR, None), (None, LIGHT_POS)],
            BIAS, **kw)
    elif mode == "closest_soft_shadow":
        r = ttr.trace_closest_soft_shadow(s.twide, s.to, s.td, LIGHT_DIR,
                                          CONE_COS, SPP, SEED, BIAS, **kw,
                                          **zs)
    elif mode == "closest_point_soft_shadow":
        r = ttr.trace_closest_point_soft_shadow(
            s.twide, s.to, s.td, LIGHT_POS, RADIUS, SPP, SEED, BIAS, **kw,
            **zs)
    elif mode == "closest_soft_multi_shadow":
        r = ttr.trace_closest_soft_multi_shadow(
            s.twide, s.to, s.td, ("cone", LIGHT_DIR, CONE_COS), [FILL_DIR],
            SPP, SEED, BIAS, **kw, **zs)
    else:
        r = ttr.trace_closest_attrs(s.twide, s.to, s.td, s.tat,
                                    textured=textured)
    return ({k: v.numpy() for k, v in r[0].items()},) \
        + tuple(x.numpy() for x in r[1:])


@pytest.fixture(scope="module", params=MODES)
def case(request, scene):
    mode = request.param
    return mode, _jax(mode, scene), _port(mode, scene), \
        _port(mode, scene, textured=False)


def test_hits_and_counters(case):
    _, (jch, *_), (tch, *_, counts), _ = case
    np.testing.assert_array_equal(counts, [0, 0])
    valid = jch["sidx"] >= 0
    np.testing.assert_array_equal(tch["sidx"] >= 0, valid)
    assert valid.any() and not valid.all()
    np.testing.assert_allclose(tch["t"][valid], jch["t"][valid], rtol=1e-6,
                               atol=1e-6)


def test_textured_attributes(case):
    _, (jch, *_), (tch, *_), _ = case
    valid = jch["sidx"] >= 0
    same = (tch["tri_id"] == jch["tri_id"]) & valid
    assert same.sum() >= 0.999 * valid.sum()
    for k in ("u", "v", "uv"):
        np.testing.assert_allclose(tch[k][same], jch[k][same], atol=1e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(tch["layer"][same], jch["layer"][same])
    assert set(np.unique(tch["layer"][valid])) == {-1.0, 0.0, 1.0, 2.0}
    for k in ("kd", "oct", "gn"):
        np.testing.assert_allclose(tch[k][same], jch[k][same], atol=1e-6,
                                   err_msg=k)


def test_shadow_outputs(case):
    mode, (jch, *jout), (_, *tout, _), _ = case
    valid = jch["sidx"] >= 0
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        j, t = np.asarray(j).astype(np.int64), np.asarray(t).astype(np.int64)
        assert not t[~valid].any(), mode
        mism = (j != t) & valid
        assert mism.sum() <= 1e-3 * valid.sum(), (mode, int(mism.sum()))


def test_textured_walk_extends_the_untextured_one(case):
    """attrs=2 differs from attrs=1 in uv and layer alone (attrs=1 leaves
    them 0 on the kernel side; the wrapper reads layer -1 off hits)."""
    _, _, (tch, *tout), (uch, *uout) = case
    for k in tch:
        if k not in ("uv", "layer"):
            np.testing.assert_array_equal(tch[k], uch[k], err_msg=k)
    for a, b in zip(tout, uout):
        np.testing.assert_array_equal(a, b)
    valid = uch["sidx"] >= 0
    assert not uch["uv"].any() and (uch["layer"][valid] == 0).all()
    assert tch["uv"][valid].any()
