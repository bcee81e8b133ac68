"""The port's counterparts of ``tpurt/kernels/_variants.py``: the stats
walk (``_variants.trace_any_stats``, plain PyTorch version) against
``trace_any_pallas_stats`` in interpret mode, and the retired variants
reached through ``variant=`` (the dual-pop any hit "x2" on a WideBVH, the
packet-frustum any and closest hits "frustum" on a binary tree) held
against ``tpurt``'s interpret-mode kernels, which the port routes to
modes ANY, BIN_ANY and BIN_CLOSEST (ROADMAP decision 23); and the
``variant=`` / ``seeded`` dispatch of ``trace_any`` and ``trace_closest``.

Scenes: the parity scene (teapot 1500, SBVH, leaf 8, 64x32 camera rays)
and its shadow rays toward a directional and a point light; the binary
teapot of ``tests/test_torch_binary.py``. The stats walk takes a flat set
of six packets: the directional and the point light's rays, a packet
whose rays are all inactive, and a short tail.

Tolerances (decision 2): t within 1e-6, tri_id equal on >= 99.9% of
valid rays, occlusion differing on at most 1e-3 of active rays. The
stats walk's iteration counts are exact (decision 22): equal on every
packet whose occlusion agrees on every ray, 0 on the all-inactive one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt_torch.kernels.traverse as tr
from tpurt.kernels._variants import trace_any_pallas_stats
from tpurt.kernels.traverse import trace_any_pallas, trace_closest_pallas
from tpurt_torch.kernels import _variants as V

from test_torch_any_hit import hard_rays, port_gbuf
from test_torch_binary import (camera_rays, check_any, closest_pair,
                               flat_rays, scene)
from test_torch_closest import check_closest
from test_torch_multi_shadow import jax_checks_off, parity_scene
from test_torch_native import ensure_native_libraries

torch.set_num_threads(1)
ensure_native_libraries()


@pytest.fixture(scope="module")
def scene8():
    s = parity_scene(8)
    gbuf = port_gbuf(s)
    return s, gbuf["valid"].numpy(), hard_rays(s, gbuf)


def _flat(x):
    return x.reshape(-1, *x.shape[2:])


@pytest.fixture(scope="module")
def stats_rays(scene8):
    """Six packets of flat rays: the directional light's 2048 shadow rays,
    the point light's 2048, 1024 inactive rays (t_max 0) and 300 active
    directional rays again; and both packages' stats walks of them."""
    _, _, rays = scene8
    do, dd, dt = (_flat(x) for x in rays["directional"])
    po, pd, pt = (_flat(x) for x in rays["point"])
    tail = torch.nonzero(dt > 0.0)[:300, 0]
    o = torch.cat([do, po, do[:1024], do[tail]])
    d = torch.cat([dd, pd, dd[:1024], dd[tail]])
    t = torch.cat([dt, pt, torch.zeros(1024), dt[tail]])
    s = scene8[0]
    with jax_checks_off():
        jocc, jit = trace_any_pallas_stats(
            s.acc, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
            jnp.asarray(t.numpy()), interpret=True)
    tocc, tit, counts = V.trace_any_stats(s.twide, o, d, t)
    return dict(o=o, d=d, t=t, jocc=np.asarray(jocc), jit=np.asarray(jit),
                tocc=tocc.numpy(), tit=tit.numpy(), counts=counts.numpy())


def test_stats_walk_matches_pallas(stats_rays):
    r = stats_rays
    active = r["t"].numpy() > 0.0
    assert r["jit"].shape == r["tit"].shape == (6,)
    np.testing.assert_array_equal(r["counts"], [0, 0])
    assert not r["tocc"][~active].any() and not r["jocc"][~active].any()
    assert r["tocc"][active].any() and not r["tocc"][active].all()
    assert (r["tocc"] != r["jocc"]).sum() <= 1e-3 * active.sum()
    n = r["t"].shape[0]
    pad = -(-n // 1024) * 1024 - n
    agree = np.pad(r["tocc"] == r["jocc"], (0, pad),
                   constant_values=True).reshape(-1, 1024).all(axis=1)
    assert agree.sum() >= 5
    np.testing.assert_array_equal(r["tit"][agree], r["jit"][agree])
    assert r["tit"][4] == 0 and r["jit"][4] == 0
    assert (r["tit"][[0, 1, 2, 3, 5]] > 0).all()


def test_stats_walk_occlusion_is_mode_any(scene8, stats_rays):
    r = stats_rays
    occ, counts = tr.trace_any(scene8[0].twide, r["o"], r["d"], r["t"])
    np.testing.assert_array_equal(counts.numpy(), [0, 0])
    active = r["t"].numpy() > 0.0
    assert (occ.numpy() != r["tocc"]).sum() <= 1e-3 * active.sum()


def test_stats_walk_counts_overflow_and_cap(scene8):
    """A one-entry stack drops pushes and counts them; an iteration cap of
    one period stops every packet with work left, counted as capped."""
    s, _, rays = scene8
    so, sd, stm = rays["point"]
    args, kw, _, _ = V.any_stats_inputs(s.twide, so, sd, stm)
    _, its, counts = V.any_stats_reference(*args, **dict(kw, stack_size=1))
    assert counts[0] > 0 and (its[:, 0, 0] > 0).all()
    _, its, counts = V.any_stats_reference(
        *args, **dict(kw, max_iters=V.LIVENESS_PERIOD))
    assert (its[:, 0, 0] <= V.LIVENESS_PERIOD).all() and counts[1] > 0


def test_stats_walk_counts_the_work_it_does(scene8, stats_rays):
    """The plain version's work counts (the kernel's bound): counting
    leaves the result alone; every iteration pops one node for each of a
    packet's 1024 lanes in the SIMD counts; the live rays' slab tests and
    the leaf tests of the rays not yet occluded are fewer."""
    r = stats_rays
    args, kw, _, _ = V.any_stats_inputs(scene8[0].twide, r["o"], r["d"],
                                        r["t"])
    stats = {}
    res = V.any_stats_reference(*args, stats=stats, **kw)
    for a, b in zip(res, V.any_stats_reference(*args, **kw)):
        assert torch.equal(a, b)
    n = {k: int(v) for k, v in stats.items()}
    assert n["simd_pops"] == tr.LANES * int(res[1][:, 0, 0].sum())
    assert 0 < n["pops"] < n["simd_pops"]
    assert 0 < n["slab_tests"] < n["simd_slab_tests"]
    assert 0 < n["anyhit_tris"] <= n["anyhit_leaf_tris"] < n["simd_tris"]


def test_stats_walk_refuses_other_accels():
    tp = scene("teapot")[1]
    o, d = camera_rays("teapot")
    with pytest.raises(ValueError, match="WideBVH"):
        V.trace_any_stats(tp, torch.from_numpy(o), torch.from_numpy(d),
                          torch.tensor(tr._BIG))


@pytest.mark.parametrize("kind", ["directional", "point"])
def test_x2_is_mode_any(scene8, kind):
    s, valid, rays = scene8
    so, sd, stm = rays[kind]
    with jax_checks_off():
        jocc = np.asarray(trace_any_pallas(
            s.acc, jnp.asarray(so.numpy()), jnp.asarray(sd.numpy()),
            jnp.asarray(stm.numpy()), variant="x2", interpret=True))
    tocc, counts = tr.trace_any(s.twide, so, sd, stm, variant="x2")
    tocc = tocc.numpy()
    np.testing.assert_array_equal(counts.numpy(), [0, 0])
    assert not tocc[~valid].any() and not jocc[~valid].any()
    assert tocc[valid].any() and not tocc[valid].all()
    assert ((tocc != jocc) & valid).sum() <= 1e-3 * valid.sum()


def test_frustum_any_is_bin_any():
    jp, tp = scene("teapot")[:2]
    o, d = flat_rays("teapot")
    t_max = np.float32(np.random.default_rng(9).random(o.shape[0]) * 0.6)
    with jax_checks_off():
        jocc = np.asarray(trace_any_pallas(
            jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
            variant="frustum", interpret=True))
    tocc, counts = tr.trace_any(tp, torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(t_max), variant="frustum")
    check_any(jocc, tocc.numpy(), counts.numpy(), t_max > 0.0)
    # The frustum route walks what the default one walks.
    plain, _ = tr.trace_any(tp, torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(t_max))
    assert torch.equal(plain, tocc)


def test_frustum_closest_is_bin_closest():
    jp, tp = scene("teapot")[:2]
    o, d = camera_rays("teapot")
    with jax_checks_off():
        jres = trace_closest_pallas(jp, jnp.asarray(o), jnp.asarray(d),
                                    variant="frustum", return_sorted=True,
                                    interpret=True)
    tres = tr.trace_closest(tp, torch.from_numpy(o), torch.from_numpy(d),
                            return_sorted=True, variant="frustum")
    check_closest([np.asarray(x) for x in jres], [x.numpy() for x in tres])
    plain = closest_pair("teapot", o, d)[1]
    for a, b in zip(plain, [x.numpy() for x in tres]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The dispatch of variant= and seeded (tpurt/kernels/traverse.py
# :2533-2568, :2908-2960)
# ---------------------------------------------------------------------------

def _w8t_accel():
    from tpurt_torch.bvh.lbvh import build_lbvh
    from tpurt_torch.bvh.wide import build_wide, build_wide_t
    from tpurt_torch.scenes import teapot_scene
    m = teapot_scene(300).on("cpu")
    b = build_lbvh(m.vertices, m.indices, leaf_size=8)
    return build_wide_t(build_wide(b), b)


def _accel(kind):
    if kind == "wide":
        return parity_scene(8).twide
    if kind == "w8t":
        return _w8t_accel()
    return scene("teapot")[1]


def _record_calls(monkeypatch, names):
    """Wrap each plain version in ``names`` to record its calls."""
    calls = []
    for name in names:
        fn = getattr(tr, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(tr, name, wrapped)
    return calls


_ANY_REFS = ("any_reference", "w8t_any_reference", "binary_any_reference")
_CLOSEST_REFS = ("closest_reference", "first_hit_reference",
                 "w8t_closest_reference", "binary_closest_reference")


@pytest.mark.parametrize("kind,variant,want", [
    ("wide", "lanes", "any_reference"),
    ("wide", "w8", "any_reference"),
    ("wide", "x2", "any_reference"),
    ("wide", "frustum", "any_reference"),
    ("w8t", "x2", "w8t_any_reference"),
    ("w8t", "frustum", "w8t_any_reference"),
    ("binary", "frustum", "binary_any_reference"),
    ("binary", "x2", "binary_any_reference"),
])
def test_trace_any_variant_dispatch(monkeypatch, kind, variant, want):
    acc = _accel(kind)
    o = torch.zeros((5, 3))
    d = torch.tensor([[0.0, 1.0, 0.0]]).expand(5, 3).contiguous()
    calls = _record_calls(monkeypatch, _ANY_REFS)
    occ, counts = tr.trace_any(acc, o, d, torch.full((5,), 2.0),
                               variant=variant)
    # The w8t plain walk is any_reference's over the transposed leaves.
    assert calls[0] == want and occ.shape == (5,)
    assert calls[1:] == (["any_reference"] if kind == "w8t" else [])


@pytest.mark.parametrize("kind,variant,seeded,want", [
    ("wide", "lanes", True, ["first_hit_reference", "closest_reference"]),
    ("wide", "lanes", False, ["closest_reference"]),
    ("wide", "w8", True, ["closest_reference"]),
    ("wide", "frustum", True, ["closest_reference"]),
    ("w8t", "lanes", True, ["w8t_closest_reference", "closest_reference"]),
    ("w8t", "frustum", False, ["w8t_closest_reference",
                               "closest_reference"]),
    ("binary", "lanes", True, ["binary_closest_reference"]),
    ("binary", "frustum", True, ["binary_closest_reference"]),
])
def test_trace_closest_variant_dispatch(monkeypatch, kind, variant, seeded,
                                        want):
    acc = _accel(kind)
    o = torch.zeros((5, 3))
    d = torch.tensor([[0.0, 1.0, 0.0]]).expand(5, 3).contiguous()
    calls = _record_calls(monkeypatch, _CLOSEST_REFS)
    t, tri_id, counts = tr.trace_closest(acc, o, d, seeded=seeded,
                                         variant=variant)
    assert calls == want and t.shape == (5,)
