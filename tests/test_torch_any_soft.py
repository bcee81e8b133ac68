"""The port's standalone in-kernel soft-shadow samplers (plain PyTorch
versions) against the JAX package's ``trace_any_soft_pallas`` (cone, 4 deg
sun) and ``trace_any_point_soft_pallas`` (disk, radius 0.4) in the
TPU-semantics interpreter, whose PRNG is a zero stream: spp 2, from the
biased origins of the parity scene's G-buffer (teapot 1500, 64x32, leaf
8). The port runs its generator's zero stream, so every sample is the same
ray in both packages.

Tolerances: counts may differ on at most 1e-3 of valid pixels (origins on
a shadow boundary, where the reference's FMA-contracted products round
differently); with a zero stream every count is 0 or spp, and equals spp x
``trace_any``'s hard occlusion along the axis or toward the centre (the
kernel renormalises the axis and caps t in its own order, hence the same
1e-3 allowance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tpurt_torch.passes.shadow as tshadow
import tpurt_torch.types as ttypes
from tpurt.kernels.traverse import (trace_any_point_soft_pallas,
                                    trace_any_soft_pallas)
from tpurt_torch.kernels.traverse import (trace_any, trace_any_point_soft,
                                          trace_any_soft)

from test_torch_any_hit import port_gbuf
from test_torch_multi_shadow import jax_checks_off, parity_scene
from test_torch_soft_shadow import CONE_COS, RADIUS, SEED, SPP
from test_torch_traverse import BIAS, LIGHT_DIR, LIGHT_POS

torch.set_num_threads(1)

KINDS = ["cone", "disk"]


def _port(kind, s, origins, valid, **kw):
    if kind == "cone":
        return trace_any_soft(s.twide, origins, valid, LIGHT_DIR, CONE_COS,
                              SPP, SEED, **kw)
    return trace_any_point_soft(s.twide, origins, valid, LIGHT_POS, RADIUS,
                                SPP, SEED, **kw)


@pytest.fixture(scope="module")
def leaf8():
    s = parity_scene(8)
    gbuf = port_gbuf(s)
    valid = gbuf["valid"]
    origins = gbuf["position"] + gbuf["gnormal"] * BIAS
    jo, jv = jnp.asarray(origins.numpy()), jnp.asarray(valid.numpy())
    out = {"scene": s, "valid": valid.numpy(), "origins": origins}
    with jax_checks_off():
        jcnt = {
            "cone": trace_any_soft_pallas(
                s.acc, jo, jv, jnp.asarray(LIGHT_DIR), jnp.asarray(CONE_COS),
                SPP, SEED, interpret=pltpu.InterpretParams()),
            "disk": trace_any_point_soft_pallas(
                s.acc, jo, jv, jnp.asarray(LIGHT_POS), jnp.float32(RADIUS),
                SPP, SEED, interpret=pltpu.InterpretParams())}
    bounds = (s.twide.root_min, s.twide.root_max)
    for kind, light in (("cone", ttypes.Light.directional(LIGHT_DIR)),
                        ("disk", ttypes.Light.point(LIGHT_POS))):
        tcnt, counts = _port(kind, s, origins, valid, zero_stream=True)
        hard, _ = trace_any(s.twide, *tshadow.shadow_ray_batch(
            gbuf, light, BIAS, None, bounds))
        out[kind] = (np.asarray(jcnt[kind]), tcnt.numpy(), counts.numpy(),
                     hard.numpy())
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_soft_counts_match_pallas_leaf8(leaf8, kind):
    jcnt, tcnt, counts, _ = leaf8[kind]
    valid = leaf8["valid"]
    np.testing.assert_array_equal(counts, [0, 0])
    mism = (jcnt != tcnt) & valid
    assert mism.sum() <= 1e-3 * valid.sum(), f"{mism.sum()} mismatches"
    assert not tcnt[~valid].any()
    assert set(np.unique(tcnt)) <= {0, SPP}
    assert (tcnt[valid] == SPP).any() and (tcnt[valid] == 0).any()


@pytest.mark.parametrize("kind", KINDS)
def test_zero_stream_counts_are_spp_times_any_leaf8(leaf8, kind):
    _, tcnt, _, hard = leaf8[kind]
    valid = leaf8["valid"]
    mism = (tcnt != SPP * hard.astype(np.int32)) & valid
    assert mism.sum() <= 1e-3 * valid.sum()


@pytest.mark.parametrize("kind", KINDS)
def test_flat_origins_match_image_origins_leaf8(leaf8, kind):
    """With the zero stream the sample does not depend on where a ray sits
    in the packed block, so (N, 3) origins count as the image's do."""
    s, o = leaf8["scene"], leaf8["origins"]
    v = torch.from_numpy(leaf8["valid"])
    flat, counts = _port(kind, s, o.reshape(-1, 3), v.reshape(-1),
                         zero_stream=True)
    assert counts.tolist() == [0, 0]
    np.testing.assert_array_equal(flat.numpy(),
                                  leaf8[kind][1].reshape(-1))


@pytest.mark.parametrize("kind", KINDS)
def test_real_stream_samples_per_light_leaf8(leaf8, kind):
    """The real stream draws a penumbra, keyed by (seed, light): light 1
    draws other samples than light 0, and the same key the same ones."""
    s, o = leaf8["scene"], leaf8["origins"]
    v = torch.from_numpy(leaf8["valid"])
    a, _ = _port(kind, s, o, v, light=0)
    b, _ = _port(kind, s, o, v, light=1)
    assert torch.equal(a, _port(kind, s, o, v, light=0)[0])
    assert not torch.equal(a, b)
    assert ((a > 0) & (a < SPP)).any()
    assert not a[~v].any()
