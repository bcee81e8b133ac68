"""The port's fused soft-plus-extras traversal (plain PyTorch version)
against the JAX package's ``trace_closest_soft_multi_shadow_pallas`` in
interpret mode (zero PRNG stream; the port runs ``zero_stream=True``),
with the attribute tables, spp 2, teapot 1500, 64x32 rays: a 4 deg cone
light 0 with two hard directional extras at leaf 8, and a disk light 0
(radius 0.4) with one extra at leaf 14 (this file's second half, in
test_torch_soft_multi_shadow_leaf14.py).

Tolerances: those of tests/test_torch_soft_shadow.py for light 0's counts
and of tests/test_torch_multi_shadow.py for each bit of the extras' mask.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.kernels.traverse import trace_closest_soft_multi_shadow_pallas
from tpurt_torch.kernels.traverse import trace_closest_soft_multi_shadow

from test_torch_multi_shadow import FILL2_DIR, FILL_DIR, check_bit, \
    jax_checks_off, np_channels, parity_scene
from test_torch_soft_shadow import CONE_COS, RADIUS, SEED, SPP, \
    check_counts
from test_torch_traverse import BIAS, LIGHT_DIR, LIGHT_POS, _check_attrs, \
    _check_hits

torch.set_num_threads(1)


def soft_multi_case(leaf: int, disk: bool):
    s = parity_scene(leaf)
    extras = [FILL_DIR] if disk else [FILL_DIR, FILL2_DIR]
    if disk:
        light0 = ("disk", LIGHT_POS, RADIUS)
    else:
        light0 = ("cone", LIGHT_DIR, CONE_COS)
    with jax_checks_off():
        jch, jcnt, jmask = trace_closest_soft_multi_shadow_pallas(
            s.acc, s.o, s.d,
            (light0[0], jnp.asarray(light0[1]), jnp.float32(light0[2])),
            [jnp.asarray(x) for x in extras], SPP, SEED, BIAS,
            attr_tables=s.at, interpret=True)
    tch, tcnt, tmask, counts = trace_closest_soft_multi_shadow(
        s.twide, s.to, s.td, light0, extras, SPP, SEED, BIAS,
        attr_tables=s.tat, zero_stream=True)
    return (np_channels(jch), (np.asarray(jcnt), np.asarray(jmask)),
            {k: v.numpy() for k, v in tch.items()},
            (tcnt.numpy(), tmask.numpy()), counts.numpy())


@pytest.fixture(scope="module")
def cone8():
    return soft_multi_case(8, disk=False)


def test_soft_multi_hits_match_pallas_cone_leaf8(cone8):
    _check_hits(cone8)


def test_soft_multi_attributes_match_pallas_cone_leaf8(cone8):
    _check_attrs(cone8)


def test_soft_multi_counts_match_pallas_cone_leaf8(cone8):
    jch, (jcnt, _), _, (tcnt, _), _ = cone8
    check_counts(jch, jcnt, tcnt)


@pytest.mark.parametrize("bit", [0, 1])
def test_soft_multi_mask_bits_match_pallas_cone_leaf8(cone8, bit):
    jch, (_, jmask), _, (_, tmask), _ = cone8
    check_bit(jch, jmask, tmask, bit)
    assert not ((tmask >> 2) != 0).any()
