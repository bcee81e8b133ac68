"""The port's 30-bit Morton codes against the JAX package's: the XLA
formulation (``morton_of_points``) and the Pallas kernel in interpret
mode (``morton_codes_pallas``), bit for bit. They are the sort keys of
the rebuild: any difference reshapes every tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.bvh.morton import morton_of_points as jmorton_of_points
from tpurt.kernels.build import morton_codes_pallas
from tpurt_torch.bvh.morton import morton_encode, morton_of_points
from tpurt_torch.kernels.build import (morton_codes, morton_codes_cuda,
                                       morton_codes_reference)
from tpurt_torch.bvh.morton import unit_coords

torch.set_num_threads(1)


def _points(flat: bool):
    """The 1,537 points of tests/test_lbvh.py's Morton kernel test, and its
    flat variant (one axis of zero extent)."""
    p = jax.random.uniform(jax.random.PRNGKey(3), (1537, 3), minval=-11.0,
                           maxval=4.0)
    if flat:
        p = p.at[:, 1].set(0.25)
    return np.asarray(p)


@pytest.fixture(scope="module", params=["full", "flat"])
def case(request):
    p = _points(request.param == "flat")
    smin, smax = p.min(axis=0), p.max(axis=0)
    jp = jnp.asarray(p)
    want = np.asarray(jmorton_of_points(jp, jnp.asarray(smin),
                                        jnp.asarray(smax)))
    kern = np.asarray(morton_codes_pallas(jp, jnp.asarray(smin),
                                          jnp.asarray(smax), interpret=True))
    return p, smin, smax, want, kern


def test_jax_xla_and_kernel_agree(case):
    _, _, _, want, kern = case
    np.testing.assert_array_equal(want, kern)


@pytest.mark.parametrize("fn", ["morton_of_points", "morton_codes",
                                "morton_codes_reference"])
def test_port_codes_equal_jax(case, fn):
    p, smin, smax, want, _ = case
    tp, tmin, tmax = (torch.from_numpy(np.array(a)) for a in (p, smin, smax))
    if fn == "morton_of_points":
        got = morton_of_points(tp, tmin, tmax)
    elif fn == "morton_codes":
        got = morton_codes(tp, tmin, tmax)
    else:
        got = morton_codes_reference(unit_coords(tp, tmin, tmax))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_encode_interleaves_bits():
    q = torch.tensor([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1023, 1023, 1023]])
    np.testing.assert_array_equal(morton_encode(q).numpy(),
                                  [4, 2, 1, (1 << 30) - 1])


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        morton_codes_cuda(torch.zeros((4, 3)))
