"""The port's attribute-tracked closest hit (``trace_closest_attrs``, plain
PyTorch version, which the wrapper takes for CPU tensors) against the JAX
package's ``trace_closest_attrs_pallas`` in interpret mode, on the SAME
accel carried across by tpurt_torch.convert: teapot 1500, 64x32 camera
rays, leaf 8.

Tolerances: those of tests/test_torch_traverse.py (t to rtol 1e-6, tri_id
on >= 99.9% of valid pixels, u and v to 1e-4, the other channels to 1e-6).
The kernel is the fused kernels' phase 1 alone, so its channels must also
equal the fused hard-shadow kernel's exactly.
"""

import numpy as np
import pytest
import torch

from tpurt.kernels.traverse import trace_closest_attrs_pallas
from tpurt_torch.kernels.traverse import (trace_closest_attrs,
                                          trace_closest_shadow)

from test_torch_multi_shadow import jax_checks_off, np_channels, \
    parity_scene
from test_torch_traverse import BIAS, LIGHT_DIR, _check_attrs, _check_hits

torch.set_num_threads(1)


def attrs_case(leaf: int):
    """(jax channels, None, port channels, None, walk counts) in the layout
    of the traverse checks, and the port's fused phase-1 channels."""
    s = parity_scene(leaf)
    with jax_checks_off():
        jch = trace_closest_attrs_pallas(s.acc, s.at[0], s.at[1], s.o, s.d,
                                         interpret=True)
    tch, counts = trace_closest_attrs(s.twide, s.to, s.td, s.tat)
    fused = trace_closest_shadow(s.twide, s.to, s.td, LIGHT_DIR, BIAS,
                                 attr_tables=s.tat)[0]
    res = (np_channels(jch), None, {k: v.numpy() for k, v in tch.items()},
           None, counts.numpy())
    return res, {k: v.numpy() for k, v in fused.items()}, s


def check_equals_fused(case):
    (_, _, tch, _, _), fused, _ = case
    assert tch.keys() == fused.keys()
    for k in tch:
        np.testing.assert_array_equal(tch[k], fused[k], err_msg=k)


@pytest.fixture(scope="module")
def leaf8():
    return attrs_case(8)


def test_closest_attrs_hits_match_pallas_leaf8(leaf8):
    _check_hits(leaf8[0])


def test_closest_attrs_attributes_match_pallas_leaf8(leaf8):
    _check_attrs(leaf8[0])


def test_closest_attrs_equal_the_fused_phase1_leaf8(leaf8):
    check_equals_fused(leaf8)


def test_flat_rays_give_the_image_rays_hits(leaf8):
    """(N, 3) rays in runs of 1024 walk as the (H, W, 3) tiles do: each ray
    walks alone, so the channels are the same ray for ray."""
    (_, _, tch, _, _), _, s = leaf8
    flat, counts = trace_closest_attrs(s.twide, s.to.reshape(-1, 3),
                                       s.td.reshape(-1, 3), s.tat)
    assert counts.tolist() == [0, 0]
    for k, v in flat.items():
        np.testing.assert_array_equal(
            v.numpy(), tch[k].reshape((-1,) + tch[k].shape[2:]), err_msg=k)
