"""``top_sah``: the sweep-SAH priorities (``sweep_sah_priorities_reference``,
which ``sweep_sah_priorities`` takes for CPU tensors) against the JAX
package's ``sweep_sah_priorities`` in interpret mode
(``_sweep_sah_kernel``), the topology of the steered priorities
(``topology(..., d_max=)``), ``build_lbvh(top_sah=)`` and
``_rebuild_fused(top_sah=)`` against ``tpurt``'s, a steered rebuild frame
against ``tpurt``'s Renderer, and the stack rule of steered rebuilds.

Everything is held exactly (the priorities choose the tree), but the
frame, which is held as tests/test_torch_app.py holds frames. Under
``jit`` XLA's CPU compiler contracts the sweep's SA into fma(dz, dx,
fma(dx, dy, dy dz)) and its cost into fma(SA(j+1..b), b - j, SA(a..j)
(j - a + 1)) (decision 19); the plain version and the CUDA kernel round
them so (``fma32``, ``__fmaf_rn``). Unfused, a near tie of two costs
picks another split on some inputs: the "random2028" case below differs
so.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.app as japp
import tpurt.bvh.lbvh as jlbvh
import tpurt.scenes as jscenes
from tpurt.kernels.build import sweep_sah_priorities as jsweep
from tpurt.kernels.build import topology_pallas
from tpurt.types import Light as JLight
from tpurt.types import RenderConfig as JRenderConfig
import tpurt_torch.app as tapp
import tpurt_torch.bvh.lbvh as tlbvh
import tpurt_torch.convert as convert
import tpurt_torch.kernels.build as B
import tpurt_torch.scenes as tscenes
from tpurt_torch.kernels.traverse import STACK_CAPACITY, stack_bound
from tpurt_torch.types import Light, RenderConfig

from test_torch_app import _assert_close_frames, _jax_frame
from test_torch_native import ensure_native_libraries

torch.set_num_threads(1)
ensure_native_libraries()

DIRECTION = (0.45, 0.8, 0.3)


def _soup(kind: str, nl: int, seed: int):
    """Leaf boxes (min, max) f32[nl, 3]: "clustered" (8 clusters),
    "random" (uniform), or "peel" (boxes growing by e^0.5 along the order,
    whose sweep splits off the biggest block each time and so reaches the
    maxn cap)."""
    rng = np.random.default_rng(seed)
    if kind == "peel":
        i = np.arange(nl, dtype=np.float64)[:, None]
        c = np.zeros((nl, 3))
        c[:, 0] = np.exp(0.5 * i[:, 0])
        ext = np.exp(0.5 * i) * 0.01
    else:
        if kind == "clustered":
            c = rng.normal(size=(8, 3))[rng.integers(0, 8, nl)] * 5 \
                + rng.normal(size=(nl, 3)) * 0.3
        else:
            c = rng.uniform(-10, 10, size=(nl, 3))
        ext = rng.uniform(0.01, 1.0, size=(nl, 3))
    return (c - ext).astype(np.float32), (c + ext).astype(np.float32)


# (kind, leaves, seed, top_sah's tuple or None for the defaults)
CASES = [("clustered", 1500, 0, None), ("random", 2028, 5, None),
         ("random", 900, 1, (4, 30, 2)), ("peel", 64, 0, (2, 21, 8))]


@pytest.mark.parametrize("kind,nl,seed,args", CASES,
                         ids=[f"{c[0]}{c[1]}" for c in CASES])
def test_priorities_equal_pallas(kind, nl, seed, args):
    lmin, lmax = _soup(kind, nl, seed)
    d = np.random.default_rng(seed).integers(0, 96, nl - 1).astype(np.int32)
    kw = tlbvh.top_sah_args(args)
    want = np.asarray(jsweep(jnp.asarray(d), jnp.asarray(lmin),
                             jnp.asarray(lmax), interpret=True, **kw))
    got = B.sweep_sah_priorities(torch.from_numpy(d), torch.from_numpy(lmin),
                                 torch.from_numpy(lmax), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    maxd = kw.get("maxd", B.SWEEP_MAXD)
    steered = got.numpy() < maxd
    assert steered.any() and (got.numpy()[~steered] >= maxd).all()
    if kind == "peel":
        bx = B.block_boxes(torch.from_numpy(lmin), torch.from_numpy(lmax),
                           kw["block"])
        gaps, _ = B.sweep_sah_priorities_reference(bx, nl - 1, **kw)
        assert (gaps < nl - 1).all()          # every slot taken: the cap


def _round_f32(v: Fraction) -> np.float32:
    """The float32 nearest to v, ties to even."""
    r = np.float32(float(v))
    best = None
    for c in (np.nextafter(r, np.float32(-np.inf)), r,
              np.nextafter(r, np.float32(np.inf))):
        e = abs(Fraction(float(c)) - v)
        if best is None or e < best[0] or (
                e == best[0] and int(c.view(np.int32)) % 2 == 0):
            best = (e, c)
    return best[1]


def test_fma32_rounds_once():
    """fma32 against exact rational arithmetic, with the sums that lie on
    a float32 halfway point after the float64 sum's rounding: (1 +
    2^-12)^2 = 1 + 2^-11 + 2^-24 is halfway between two float32 values,
    and +-2^-80 decides the side."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=2000).astype(np.float32) * 1e3
    b = rng.normal(size=2000).astype(np.float32)
    c = rng.normal(size=2000).astype(np.float32) * 1e2
    h = np.float32(1 + 2 ** -12)
    a = np.concatenate([a, [h, h, h]]).astype(np.float32)
    b = np.concatenate([b, [h, h, h]]).astype(np.float32)
    c = np.concatenate([c, [2.0 ** -80, -2.0 ** -80, 0.0]]).astype(
        np.float32)
    got = B.fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[-3] > got[-2] and got[-1] == got[-2]


def test_topology_takes_the_steered_range():
    """Priorities up to the top of D_MAX + maxd: the topology with that
    d_max (and its depth output) equals topology_pallas; D_MAX's range
    would miss the values above it."""
    rng = np.random.default_rng(3)
    maxd = B.SWEEP_MAXD
    d_max = tlbvh.delta_range(True)
    d = rng.integers(0, d_max, 3000).astype(np.int32)
    d[[7, 1500, 2999]] = d_max - 1
    d[100] = 0
    want = topology_pallas(jnp.asarray(d), interpret=True, want_depth=True)
    got = B.topology(torch.from_numpy(d), want_depth=True, d_max=d_max)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert d_max == B.D_MAX + maxd
    with pytest.raises(RuntimeError, match="out of bounds"):
        B.topology_reference(torch.from_numpy(d))


@pytest.mark.parametrize("top_sah", [True, (4, 30, 2)], ids=["default",
                                                             "tuple"])
def test_build_lbvh_equals_kernel_builder(top_sah):
    jm = jscenes.teapot_scene(1500)
    want = jlbvh.build_lbvh(jnp.asarray(jm.vertices), jnp.asarray(jm.indices),
                            leaf_size=4, top_sah=top_sah, builder="kernel")
    got = tlbvh.build_lbvh(torch.from_numpy(np.asarray(jm.vertices)),
                           torch.from_numpy(np.asarray(jm.indices)),
                           leaf_size=4, top_sah=top_sah)
    for f in ("nodes_child", "nodes_first", "nodes_last", "nodes_box",
              "tri_id", "tri_v0", "root_min", "root_max"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    plain = tlbvh.build_lbvh(torch.from_numpy(np.asarray(jm.vertices)),
                             torch.from_numpy(np.asarray(jm.indices)),
                             leaf_size=4)
    assert not torch.equal(plain.nodes_child, got.nodes_child)
    with pytest.raises(ValueError, match="exclusive"):
        tlbvh.build_lbvh(torch.from_numpy(np.asarray(jm.vertices)),
                         torch.from_numpy(np.asarray(jm.indices)),
                         leaf_size=4, top_sah=True, split_blocks=4)


@pytest.mark.parametrize("collapse", ["area", "fixed"])
def test_rebuild_fused_equals_jax(collapse):
    """tpurt's jitted _rebuild_fused (its CPU search builder over the same
    priorities) and the port's: the wide accel and the attribute rows
    (the rows carry breadth-first wide ids and leaf refs alone)."""
    jm = jscenes.random_soup(250)
    tm = convert.mesh(convert.numpy_fields(jm)).on("cpu")
    jv, ji = jnp.asarray(jm.vertices), jnp.asarray(jm.indices)
    leaf = 2
    nw_pad = 64
    _, jw, _, _, jat, jcnt = japp._rebuild_fused(
        jv, ji, jm, leaf, nw_pad, tables="attr", collapse=collapse,
        top_sah=True)
    tb, tw, tat, tcnt = tapp._rebuild_fused(
        tm.vertices, tm.indices, tm, leaf, nw_pad, collapse=collapse,
        top_sah=True)
    assert int(tcnt) == int(jcnt) <= nw_pad
    for f in ("nodes", "tris", "tri_id", "root_min", "root_max"):
        np.testing.assert_array_equal(getattr(tw, f).numpy(),
                                      np.asarray(getattr(jw, f)), err_msg=f)
    np.testing.assert_array_equal(tat[0].numpy(), np.asarray(jat[0]))
    unsteered = tapp._rebuild_fused(tm.vertices, tm.indices, tm, leaf,
                                    nw_pad, collapse=collapse)[1]
    assert not torch.equal(unsteered.nodes, tw.nodes)


def test_steered_rebuild_frame_matches_jax_renderer():
    fields = dict(width=48, height=32, leaf_size=8, top_sah=True,
                  rebuild_splits=0, gbuffer="ray")
    jmesh = jscenes.teapot_scene(1500)
    jimg = _jax_frame(jmesh, jscenes.default_camera_for(jmesh),
                      JLight.directional(DIRECTION), JRenderConfig(**fields),
                      mode="rebuild")
    tmesh = tscenes.teapot_scene(1500)
    r = tapp.Renderer(tmesh, tscenes.default_camera_for(tmesh),
                      Light.directional(DIRECTION), RenderConfig(**fields),
                      mode="rebuild", device="cpu")
    assert r._top_sah is True
    out = r.render_frame()
    assert out["walk_counts"].tolist() == [0, 0]
    _assert_close_frames(jimg, out["image"].numpy())


def test_stack_rule_of_steered_rebuilds(monkeypatch):
    """Decision 18: the Karras bound of a steered tree is 95 + maxd binary
    levels, so the fixed cut's bound, 39 wide levels, needs 274 stack
    entries, past the 256 the kernels hold. An unsteered fixed rebuild
    checks its constant bound; a steered one relies on the frame's walk
    counters (a frame raises on a dropped push); a binary rebuild checks
    the steered Karras bound, 116 + 1 entries."""
    d_max = tlbvh.delta_range(True)
    assert tapp.karras_depth_bound(d_max) == 116
    assert tapp.fixed_cut_depth_bound(d_max) == 39
    assert stack_bound(39) == 274 > STACK_CAPACITY
    assert tapp.FIXED_CUT_DEPTH_BOUND == 32
    assert tlbvh.delta_range((8, 30, 8)) == 126
    checked, binary = [], []
    monkeypatch.setattr(tapp, "check_stack_bound", checked.append)
    monkeypatch.setattr(tapp, "check_binary_stack_bound", binary.append)
    mesh = tscenes.teapot_scene(1500).on("cpu")
    for top_sah in (False, True):
        tapp._rebuild_fused(mesh.vertices, mesh.indices, mesh, 8, 256,
                            collapse="fixed", top_sah=top_sah)
        tapp._rebuild_binary(mesh.vertices, mesh.indices, mesh, 8,
                             top_sah=top_sah)
    assert checked == [32] and binary == [95, 116]


def test_check_slice_refuses_top_sah_with_clustering():
    mesh = jscenes.teapot_scene(200)
    lights = [Light.directional(DIRECTION)]
    cfg = RenderConfig(top_sah=True, gbuffer="ray")
    tapp.check_slice(cfg, "rebuild", lights, mesh, None, 0)
    with pytest.raises(NotImplementedError, match="sub-leaf clustering"):
        tapp.check_slice(cfg, "rebuild", lights, mesh, None, 4)
