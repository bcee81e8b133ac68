"""The JAX package's unbatched 8-wide kernels, ``_any_hit_kernel_w8`` and
``_closest_hit_kernel_w8`` (one packet per grid step; ``tpurt`` reaches
them with a variant other than "lanes" or with ``PACKETS_PER_STEP == 1``),
compute what the port's modes ANY and NEAREST compute: each is held here
against the port's plain version of that mode (``trace_any`` and
``trace_closest`` on CPU tensors), in interpret mode
(``variant="w8"``), on the parity scene (teapot 1500, SBVH, leaf 8,
64x32 camera rays, camera-ordered accel) and its shadow rays toward a
directional and a point light. The port launches the batched modes'
kernels for them; no separate kernel is needed.

Tolerances as for the batched kernels (ROADMAP decision 2): t within
1e-6, tri_id equal on >= 99.9% of valid pixels, occlusion differing on at
most 1e-3 of valid pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt_torch.kernels.traverse as tr
from tpurt.kernels.traverse import trace_any_pallas, trace_closest_pallas

from test_torch_any_hit import hard_rays, port_gbuf
from test_torch_closest import check_closest
from test_torch_multi_shadow import jax_checks_off, parity_scene
from test_torch_native import ensure_native_libraries

torch.set_num_threads(1)
ensure_native_libraries()


@pytest.fixture(scope="module")
def scene8():
    return parity_scene(8)


def test_closest_hit_kernel_w8_is_mode_nearest(scene8):
    s = scene8
    with jax_checks_off():
        jres = trace_closest_pallas(s.acc, s.o, s.d, variant="w8",
                                    return_sorted=True, interpret=True)
    tres = tr.trace_closest(s.twide, s.to, s.td, return_sorted=True)
    check_closest([np.asarray(x) for x in jres],
                  [x.numpy() for x in tres])


@pytest.mark.parametrize("kind", ["directional", "point"])
def test_any_hit_kernel_w8_is_mode_any(scene8, kind):
    s = scene8
    gbuf = port_gbuf(s)
    valid = gbuf["valid"].numpy()
    so, sd, stm = hard_rays(s, gbuf)[kind]
    with jax_checks_off():
        jocc = np.asarray(trace_any_pallas(
            s.acc, jnp.asarray(so.numpy()), jnp.asarray(sd.numpy()),
            jnp.asarray(stm.numpy()), variant="w8", interpret=True))
    tocc, counts = tr.trace_any(s.twide, so, sd, stm)
    tocc = tocc.numpy()
    np.testing.assert_array_equal(counts.numpy(), [0, 0])
    assert not tocc[~valid].any() and not jocc[~valid].any()
    assert tocc[valid].any() and not tocc[valid].all()
    assert ((tocc != jocc) & valid).sum() <= 1e-3 * valid.sum()
