"""The port's fused soft-shadow traversals (plain PyTorch versions) against
the JAX package's Pallas kernels in interpret mode, where the hardware
PRNG is a zero stream: ``trace_closest_soft_shadow_pallas`` (cone, 4 deg
sun) and ``trace_closest_point_soft_shadow_pallas`` (disk, radius 0.4),
with the attribute tables, spp 2, teapot 1500, 64x32 rays, leaf 8. The
port runs its generator's zero stream (``zero_stream=True``), so every
sample is the same ray in both packages.

Tolerances: those of tests/test_torch_traverse.py for the hit set and the
attribute channels; counts may differ on at most 1e-3 of valid pixels
(biased origins on a shadow boundary), and with a zero stream every count
is 0 or spp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.kernels.traverse import (trace_closest_point_soft_shadow_pallas,
                                    trace_closest_soft_shadow_pallas)
from tpurt_torch.kernels.traverse import (trace_closest_point_soft_shadow,
                                          trace_closest_shadow,
                                          trace_closest_soft_shadow)

from test_torch_multi_shadow import jax_checks_off, np_channels, \
    parity_scene
from test_torch_traverse import BIAS, LIGHT_DIR, LIGHT_POS, _check_attrs, \
    _check_hits

torch.set_num_threads(1)

SPP = 2
SEED = 7
CONE_COS = np.float32(np.cos(np.deg2rad(4.0)))
RADIUS = 0.4


def check_counts(jch, jcnt, tcnt, spp: int = SPP):
    valid = jch["sidx"] >= 0
    jcnt, tcnt = np.asarray(jcnt), np.asarray(tcnt)
    mism = (jcnt != tcnt) & valid
    assert mism.sum() <= 1e-3 * valid.sum(), f"{mism.sum()} mismatches"
    assert not tcnt[~valid].any()
    assert set(np.unique(tcnt)) <= {0, spp}
    assert (tcnt[valid] == spp).any() and (tcnt[valid] == 0).any()


def soft_cases(leaf: int, kinds=("soft", "psoft")):
    """{kind: (jax channels, jax counts, port channels, port counts, walk
    counts)} and {"hard": {kind: the port's hard occlusion along the axis
    or toward the centre}}."""
    s = parity_scene(leaf)
    out = {"hard": {}}
    for kind in kinds:
        with jax_checks_off():
            if kind == "soft":
                jch, jcnt = trace_closest_soft_shadow_pallas(
                    s.acc, s.o, s.d, jnp.asarray(LIGHT_DIR),
                    jnp.asarray(CONE_COS), SPP, SEED, BIAS,
                    attr_tables=s.at, interpret=True)
            else:
                jch, jcnt = trace_closest_point_soft_shadow_pallas(
                    s.acc, s.o, s.d, jnp.asarray(LIGHT_POS),
                    jnp.float32(RADIUS), SPP, SEED, BIAS, attr_tables=s.at,
                    interpret=True)
        if kind == "soft":
            tch, tcnt, counts = trace_closest_soft_shadow(
                s.twide, s.to, s.td, LIGHT_DIR, CONE_COS, SPP, SEED, BIAS,
                attr_tables=s.tat, zero_stream=True)
        else:
            tch, tcnt, counts = trace_closest_point_soft_shadow(
                s.twide, s.to, s.td, LIGHT_POS, RADIUS, SPP, SEED, BIAS,
                attr_tables=s.tat, zero_stream=True)
        out[kind] = (np_channels(jch), np.asarray(jcnt),
                     {k: v.numpy() for k, v in tch.items()}, tcnt.numpy(),
                     counts.numpy())
        out["hard"][kind] = trace_closest_shadow(
            s.twide, s.to, s.td, LIGHT_DIR, BIAS,
            light_pos=LIGHT_POS if kind == "psoft" else None,
            attr_tables=s.tat)[1].numpy()
    return out


KINDS = ["soft", "psoft"]


@pytest.fixture(scope="module")
def leaf8():
    return soft_cases(8)


@pytest.mark.parametrize("kind", KINDS)
def test_soft_hits_match_pallas_leaf8(leaf8, kind):
    _check_hits(leaf8[kind])


@pytest.mark.parametrize("kind", KINDS)
def test_soft_attributes_match_pallas_leaf8(leaf8, kind):
    _check_attrs(leaf8[kind])


@pytest.mark.parametrize("kind", KINDS)
def test_soft_counts_match_pallas_leaf8(leaf8, kind):
    jch, jcnt, _, tcnt, _ = leaf8[kind]
    check_counts(jch, jcnt, tcnt)


@pytest.mark.parametrize("kind", KINDS)
def test_zero_stream_counts_are_spp_times_hard_leaf8(leaf8, kind):
    """A zero stream puts every cone sample on the axis and every disk
    sample on the centre: counts = spp x the hard kernel's occlusion (the
    cone's renormalised axis may round one ulp off the light direction,
    hence the 1e-3 allowance)."""
    jch, _, _, tcnt, _ = leaf8[kind]
    hard = leaf8["hard"][kind]
    valid = jch["sidx"] >= 0
    mism = (tcnt != SPP * hard.astype(np.int32)) & valid
    assert mism.sum() <= 1e-3 * valid.sum()
