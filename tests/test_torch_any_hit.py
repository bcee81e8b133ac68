"""The port's any-hit traversal (``trace_any``, plain PyTorch version)
against the JAX package's ``trace_any_pallas`` in interpret mode, and the
port's shadow-ray construction (``passes/shadow.py``) against
``tpurt.passes.shadow`` on the same arrays.

The shadow rays of the kernel check start from the G-buffer of the parity
scene (teapot 1500, 64x32, leaf 8): one directional light, its rays capped
at the scene-box exit, and one point light with a finite t_max, from the
same biased origins. Both packages trace the SAME rays. Tolerances:
occlusion may differ on at most 1e-3 of valid pixels (the reference's
FMA-contracted products round differently on a shadow boundary); invalid
pixels (t_max = 0) are never occluded. The ray construction is plain
float32 arithmetic in both packages: rtol 1e-6 / atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.passes.shadow as jshadow
import tpurt.types as jtypes
from tpurt.kernels.traverse import _pack_soft_origins as jpack_soft
from tpurt.kernels.traverse import _ray_packets_packed as jpack
from tpurt.kernels.traverse import trace_any_pallas
import tpurt_torch.passes.shadow as tshadow
import tpurt_torch.scenes as tscenes
import tpurt_torch.types as ttypes
from tpurt_torch.kernels.traverse import (_pack_soft_origins,
                                          _ray_packets_packed, trace_any,
                                          trace_closest_attrs)
from tpurt_torch.passes.gbuffer import gbuf_from_attr_channels

from test_torch_multi_shadow import jax_checks_off, parity_scene
from test_torch_traverse import BIAS, LIGHT_DIR, LIGHT_POS

torch.set_num_threads(1)


def port_gbuf(s):
    """The port's G-buffer of the parity scene's camera rays."""
    mesh = tscenes.teapot_scene(1500)
    ch, _ = trace_closest_attrs(s.twide, s.to, s.td, s.tat)
    return gbuf_from_attr_channels(ch, s.to, s.td,
                                   tscenes.default_camera_for(mesh), mesh)


def hard_rays(s, gbuf):
    """{kind: (origins, dirs, t_max)} of the directional and point light."""
    bounds = (s.twide.root_min, s.twide.root_max)
    return {kind: tshadow.shadow_ray_batch(gbuf, light, BIAS, None, bounds)
            for kind, light in (
                ("directional", ttypes.Light.directional(LIGHT_DIR)),
                ("point", ttypes.Light.point(LIGHT_POS)))}


@pytest.fixture(scope="module")
def leaf8():
    s = parity_scene(8)
    gbuf = port_gbuf(s)
    out = {"valid": gbuf["valid"].numpy(), "scene": s, "rays": {}}
    for kind, (so, sd, stm) in hard_rays(s, gbuf).items():
        with jax_checks_off():
            jocc = trace_any_pallas(s.acc, jnp.asarray(so.numpy()),
                                    jnp.asarray(sd.numpy()),
                                    jnp.asarray(stm.numpy()), interpret=True)
        tocc, counts = trace_any(s.twide, so, sd, stm)
        out[kind] = (np.asarray(jocc), tocc.numpy(), counts.numpy())
        out["rays"][kind] = (so, sd, stm)
    return out


KINDS = ["directional", "point"]


@pytest.mark.parametrize("kind", KINDS)
def test_any_matches_pallas_leaf8(leaf8, kind):
    jocc, tocc, counts = leaf8[kind]
    valid = leaf8["valid"]
    np.testing.assert_array_equal(counts, [0, 0])
    mism = (jocc != tocc) & valid
    assert mism.sum() <= 1e-3 * valid.sum(), f"{mism.sum()} mismatches"
    assert not tocc[~valid].any()
    assert tocc[valid].any() and not tocc[valid].all()


@pytest.mark.parametrize("kind", KINDS)
def test_any_flat_rays_match_image_rays(leaf8, kind):
    so, sd, stm = leaf8["rays"][kind]
    occ, counts = trace_any(leaf8["scene"].twide, so.reshape(-1, 3),
                            sd.reshape(-1, 3), stm.reshape(-1))
    assert counts.tolist() == [0, 0]
    np.testing.assert_array_equal(occ.numpy(), leaf8[kind][1].reshape(-1))


def test_any_t_min_skips_near_hits(leaf8):
    """A ray is inactive where t_max <= t_min, and hits nearer than t_min
    do not count."""
    so, sd, stm = leaf8["rays"]["point"]
    occ, _ = trace_any(leaf8["scene"].twide, so, sd, stm, t_min=1e6)
    assert not occ.any()


# ---------------------------------------------------------------------------
# Packing: the kernels' input blocks equal the JAX package's
# ---------------------------------------------------------------------------

def _rays(shape, seed=5):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-5, 5, shape + (3,)).astype(np.float32)
    d = rng.normal(size=shape + (3,)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, rng.uniform(0, 9, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(40, 70), (1500,)])
def test_ray_blocks_match_pallas(shape):
    o, d, tm = _rays(shape)
    jr, jp, _ = jpack(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), 1)
    tr_, tp, _ = _ray_packets_packed(torch.from_numpy(o), torch.from_numpy(d),
                                     torch.from_numpy(tm), 1)
    assert jp == tp
    np.testing.assert_array_equal(np.asarray(jr), tr_.numpy())


@pytest.mark.parametrize("shape,batch", [((40, 70), 1), ((1500,), 1),
                                         ((40, 70), 8)])
def test_soft_origin_blocks_match_pallas(shape, batch):
    o, _, tm = _rays(shape)
    valid = tm > 3.0
    jr, jp, _ = jpack_soft(jnp.asarray(o), jnp.asarray(valid), batch)
    tr_, tp, _ = _pack_soft_origins(torch.from_numpy(o),
                                    torch.from_numpy(valid), batch)
    assert jp == tp
    np.testing.assert_array_equal(np.asarray(jr), tr_.numpy())


# ---------------------------------------------------------------------------
# Shadow-ray construction against tpurt.passes.shadow
# ---------------------------------------------------------------------------

H, W = 24, 20
BOUNDS = (np.float32([-6.0, -6.0, -6.0]), np.float32([7.0, 6.5, 8.0]))


def _gbuf(seed=11):
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(H, W, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return {"position": rng.uniform(-5, 5, (H, W, 3)).astype(np.float32),
            "gnormal": n, "valid": rng.uniform(size=(H, W)) < 0.8}


def _uniforms(seed=12):
    return np.random.default_rng(seed).uniform(size=(H, W, 2)).astype(
        np.float32)


def _lights(mod, kind):
    if kind == "directional":
        return mod.Light.directional((0.45, 0.8, 0.3))
    if kind == "point":
        return mod.Light.point((1.0, 9.0, -2.0), radius=0.5)
    return mod.Light.sun((0.45, 0.8, 0.3), angular_radius_deg=4.0)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kind,jitter", [
    ("directional", False), ("point", False), ("point", True),
    ("cone", False), ("cone", True)])
def test_shadow_ray_batch_matches_tpurt(kind, jitter):
    g = _gbuf()
    u = _uniforms() if jitter else None
    jres = jshadow.shadow_ray_batch(
        {k: jnp.asarray(v) for k, v in g.items()}, _lights(jtypes, kind),
        BIAS, None if u is None else jnp.asarray(u),
        scene_bounds=tuple(jnp.asarray(b) for b in BOUNDS))
    tres = tshadow.shadow_ray_batch(
        {k: torch.from_numpy(v) for k, v in g.items()},
        _lights(ttypes, kind), BIAS,
        None if u is None else torch.from_numpy(u), scene_bounds=BOUNDS)
    for a, b in zip(jres, tres):
        _close(a, b)
    assert (tres[2].numpy()[~g["valid"]] == 0).all()


def test_scene_exit_t_matches_tpurt():
    o = _gbuf()["position"]
    d = _gbuf(13)["gnormal"]
    d[0, :, 1] = 0.0                  # axis-parallel rays: 1/0 is clamped
    jt = jshadow.scene_exit_t(jnp.asarray(o), jnp.asarray(d),
                              tuple(jnp.asarray(b) for b in BOUNDS))
    tt = tshadow.scene_exit_t(torch.from_numpy(o), torch.from_numpy(d),
                              BOUNDS)
    _close(jt, tt)
    assert (tt >= 0).all()


def test_sample_cone_matches_tpurt():
    d = _gbuf(14)["gnormal"]
    u = _uniforms(15)
    half = np.float32(np.deg2rad(4.0))
    jd = jshadow.sample_cone(jnp.asarray(d), half, jnp.asarray(u))
    td = tshadow.sample_cone(torch.from_numpy(d), half, torch.from_numpy(u))
    _close(jd, td)
    cos = (td * torch.from_numpy(d)).sum(-1)
    assert (cos >= np.cos(half) - 1e-6).all()


def test_onb_matches_tpurt():
    n = _gbuf(16)["gnormal"]
    for a, b in zip(jshadow._onb(jnp.asarray(n)),
                    tshadow._onb(torch.from_numpy(n))):
        _close(a, b)
