"""The attrs=0 variants of the port's five fused kernels (plain versions,
``attr_tables=None``) against the JAX package's fused Pallas kernels
without attribute tables, in interpret mode, on the same accel: 64x32
camera rays of the teapot at leaf 8. The samplers run the port's zero
stream, as interpret mode's generator is. This file holds light 0's hard
shadow (directional and point light); test_torch_fused_attrs0_multi.py,
test_torch_fused_attrs0_soft.py and test_torch_fused_attrs0_soft_multi.py
hold the other modes.

Tolerances, those of the attrs=1 parity files (ROADMAP decision 2): t to
1e-6, misses (inf, -1) in the same places, tri_id (the accel's id at the
sorted index) on >= 99.9% of valid pixels, occlusion, each mask bit and
counts off on at most 1e-3 of valid pixels and nothing set off them. On
the port the attrs=0 walk also equals the attrs=1 walk exactly: t and
sidx are channels 0-1 of the attribute block, and the shadow outputs are
the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.kernels.traverse as jtr
import tpurt_torch.kernels.traverse as tr

from test_torch_multi_shadow import FILL2_DIR, FILL_DIR, jax_checks_off, \
    parity_scene
from test_torch_soft_shadow import CONE_COS, RADIUS, SEED, SPP
from test_torch_traverse import BIAS, LIGHT_DIR, LIGHT_POS

torch.set_num_threads(1)

MULTI_LIGHTS = [(LIGHT_DIR, None), (None, LIGHT_POS), (FILL_DIR, None)]
CONE_EXTRAS = [FILL_DIR, FILL2_DIR]


def _jax(kind, s):
    """tpurt's kernel of ``kind`` without attribute tables -> (t, sidx,
    *shadow outputs)."""
    if kind in ("hard", "hard_point"):
        return jtr.trace_closest_shadow_pallas(
            s.acc, s.o, s.d, jnp.asarray(LIGHT_DIR), BIAS,
            light_pos=jnp.asarray(LIGHT_POS) if kind == "hard_point"
            else None, interpret=True)
    if kind == "multi":
        return jtr.trace_closest_multi_shadow_pallas(
            s.acc, s.o, s.d,
            [(None if ld is None else jnp.asarray(ld),
              None if lp is None else jnp.asarray(lp))
             for ld, lp in MULTI_LIGHTS], BIAS, interpret=True)
    if kind == "soft":
        return jtr.trace_closest_soft_shadow_pallas(
            s.acc, s.o, s.d, jnp.asarray(LIGHT_DIR), jnp.asarray(CONE_COS),
            SPP, SEED, BIAS, interpret=True)
    if kind == "psoft":
        return jtr.trace_closest_point_soft_shadow_pallas(
            s.acc, s.o, s.d, jnp.asarray(LIGHT_POS), jnp.float32(RADIUS),
            SPP, SEED, BIAS, interpret=True)
    return jtr.trace_closest_soft_multi_shadow_pallas(
        s.acc, s.o, s.d,
        ("cone", jnp.asarray(LIGHT_DIR), jnp.float32(CONE_COS)),
        [jnp.asarray(x) for x in CONE_EXTRAS], SPP, SEED, BIAS,
        interpret=True)


def _port(kind, s, attr_tables):
    """The port's wrapper of ``kind`` (plain version on the CPU)."""
    if kind in ("hard", "hard_point"):
        return tr.trace_closest_shadow(
            s.twide, s.to, s.td, LIGHT_DIR, BIAS,
            light_pos=LIGHT_POS if kind == "hard_point" else None,
            attr_tables=attr_tables)
    if kind == "multi":
        return tr.trace_closest_multi_shadow(
            s.twide, s.to, s.td, MULTI_LIGHTS, BIAS, attr_tables=attr_tables)
    sampled = dict(attr_tables=attr_tables, zero_stream=True)
    if kind == "soft":
        return tr.trace_closest_soft_shadow(
            s.twide, s.to, s.td, LIGHT_DIR, CONE_COS, SPP, SEED, BIAS,
            **sampled)
    if kind == "psoft":
        return tr.trace_closest_point_soft_shadow(
            s.twide, s.to, s.td, LIGHT_POS, RADIUS, SPP, SEED, BIAS,
            **sampled)
    return tr.trace_closest_soft_multi_shadow(
        s.twide, s.to, s.td, ("cone", LIGHT_DIR, CONE_COS), CONE_EXTRAS,
        SPP, SEED, BIAS, **sampled)


# Each mode's i32 outputs: ("bits", n) for occlusion or a mask of n
# lights, ("count", spp) for sample counts.
OUTPUTS = {"hard": [("bits", 1)], "hard_point": [("bits", 1)],
           "multi": [("bits", 3)], "soft": [("count", SPP)],
           "psoft": [("count", SPP)],
           "soft_multi": [("count", SPP), ("bits", 2)]}


def attrs0_case(kind: str, leaf: int = 8):
    """(tpurt's (t, sidx, *outputs), the port's attrs=0 (t, sidx,
    *outputs, walk counts), the port's attrs=1 (channels, *outputs, walk
    counts), the accel's tri_id), all numpy."""
    s = parity_scene(leaf)
    with jax_checks_off():
        jres = [np.asarray(x) for x in _jax(kind, s)]
    tres = [x.numpy() for x in _port(kind, s, None)]
    ares = _port(kind, s, s.tat)
    ares = [{k: v.numpy() for k, v in ares[0].items()}] + \
        [x.numpy() for x in ares[1:]]
    return jres, tres, ares, s.twide.tri_id.numpy()


def check_hits(case):
    jres, tres, _, tri_id = case
    (jt, jsidx), (tt, tsidx) = jres[:2], tres[:2]
    np.testing.assert_array_equal(tres[-1], [0, 0])
    valid = jsidx >= 0
    np.testing.assert_array_equal(tsidx >= 0, valid)
    assert valid.any() and not valid.all()
    np.testing.assert_allclose(tt[valid], jt[valid], rtol=1e-6, atol=1e-6)
    assert np.isinf(tt[~valid]).all() and (tsidx[~valid] == -1).all()
    same = (tri_id[tsidx] == tri_id[jsidx]) & valid
    assert same.sum() >= 0.999 * valid.sum()


def check_outputs(case, kind):
    jres, tres, _, _ = case
    valid = jres[1] >= 0
    for (what, n), jo, to in zip(OUTPUTS[kind], jres[2:], tres[2:-1]):
        jo, to = jo.astype(np.int32), to.astype(np.int32)
        assert not to[~valid].any()
        planes = [(jo, to)] if what == "count" else \
            [((jo >> b) & 1, (to >> b) & 1) for b in range(n)]
        for a, b in planes:
            mism = (a != b) & valid
            assert mism.sum() <= 1e-3 * valid.sum(), f"{mism.sum()}"
            assert b[valid].any()
        if what == "count":
            assert set(np.unique(to)) <= {0, n}
        else:
            assert not (to >> n).any()


def check_equals_attrs1(case):
    """attrs=0 t and sidx are attrs=1's channels 0-1 (the wrappers' t and
    sidx), and the shadow outputs are identical."""
    _, tres, ares, _ = case
    np.testing.assert_array_equal(tres[0], ares[0]["t"])
    np.testing.assert_array_equal(tres[1], ares[0]["sidx"])
    for a, b in zip(tres[2:], ares[1:]):
        np.testing.assert_array_equal(a, b)


KINDS = ["hard", "hard_point"]


@pytest.fixture(scope="module", params=KINDS)
def case(request):
    return request.param, attrs0_case(request.param)


def test_attrs0_hits_match_pallas(case):
    check_hits(case[1])


def test_attrs0_shadow_outputs_match_pallas(case):
    check_outputs(case[1], case[0])


def test_attrs0_equals_the_attrs1_walk(case):
    check_equals_attrs1(case[1])
