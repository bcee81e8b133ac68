"""The 60-bit Morton keys against the JAX package's: ``morton_of_points_60``
and the kernel's plain version (``morton_codes60_reference``, which
``morton_codes60`` takes for CPU tensors) equal to
``tpurt.bvh.morton.morton_of_points_60`` and ``morton_codes60_pallas`` in
interpret mode, bit for bit, also on a flat scene; the deltas over (hi, lo)
equal ``tpurt``'s ``adjacent_deltas``; and ``build_lbvh(morton_bits=60)``
equal to ``tpurt``'s ``build_lbvh(morton_bits=60, builder="kernel")``
array for array (ROADMAP decision 7: the port always builds the kernel's
tree). The model is ``tests/test_lbvh.py``'s 60-bit check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.bvh.lbvh as jlbvh
import tpurt.scenes as jscenes
import tpurt_torch.bvh.lbvh as tlbvh
import tpurt_torch.convert as convert
import tpurt_torch.kernels.build as tbuild
from tpurt.bvh.morton import morton_of_points_60 as jmorton60
from tpurt.kernels.build import morton_codes60_pallas
from tpurt_torch.bvh.morton import morton_of_points_60, unit_coords

from test_torch_multi_shadow import jax_checks_off

torch.set_num_threads(1)


def _points(flat: bool):
    rng = np.random.default_rng(17)
    p = rng.normal(size=(3000, 3)).astype(np.float32) * [3.0, 1.0, 0.2]
    p = p.astype(np.float32)
    if flat:
        p[:, 1] = 0.25
    return p


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32)


@pytest.mark.parametrize("flat", [False, True])
def test_codes60_equal_tpurt(flat):
    p = _points(flat)
    smin, smax = p.min(axis=0), p.max(axis=0)
    jh, jl = jmorton60(jnp.asarray(p), jnp.asarray(smin), jnp.asarray(smax))
    with jax_checks_off():
        kh, kl = morton_codes60_pallas(jnp.asarray(p), jnp.asarray(smin),
                                       jnp.asarray(smax), interpret=True)
    tp, tmin, tmax = (torch.from_numpy(x) for x in (p, smin, smax))
    th, tl = morton_of_points_60(tp, tmin, tmax)
    rh, rl = tbuild.morton_codes60(tp, tmin, tmax)
    for a, b in ((jh, th), (jl, tl), (kh, rh), (kl, rl), (jh, rh)):
        np.testing.assert_array_equal(b.numpy().astype(np.uint32), _u32(a))
    assert th.dtype == torch.int32 and int(th.max()) < 2 ** 30
    unit = unit_coords(tp, tmin, tmax).contiguous()
    rh2, rl2 = tbuild.morton_codes60_reference(unit)
    assert torch.equal(rh2, rh) and torch.equal(rl2, rl)


def test_deltas_over_two_words_equal_tpurt():
    """Sorted keys with runs of equal hi words, equal (hi, lo) pairs and
    distinct ones: every branch of the delta."""
    rng = np.random.default_rng(3)
    hi = np.sort(rng.integers(0, 12, 4000)).astype(np.int64)
    lo = rng.integers(0, 2 ** 30, 4000)
    lo[::5] = 7
    key = np.sort((hi << 30) | lo)
    h, l = (key >> 30).astype(np.int32), (key & (2 ** 30 - 1)).astype(np.int32)
    want = np.asarray(jlbvh.adjacent_deltas(
        (jnp.asarray(h.astype(np.uint32)), jnp.asarray(l.astype(np.uint32)))))
    got = tlbvh.adjacent_deltas((torch.from_numpy(h), torch.from_numpy(l)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want) // 32) >= {0, 1, 2}
    # The 30-bit call is unchanged.
    np.testing.assert_array_equal(
        tlbvh.adjacent_deltas(torch.from_numpy(h)).numpy(),
        np.asarray(jlbvh.adjacent_deltas(jnp.asarray(h.astype(np.uint32)))))


@pytest.mark.parametrize("leaf", [4, 14])
def test_build_lbvh_60_equals_tpurt(leaf):
    mesh = jscenes.teapot_scene(1200)
    with jax_checks_off():
        jb = jlbvh.build_lbvh(jnp.asarray(mesh.vertices),
                              jnp.asarray(mesh.indices), leaf_size=leaf,
                              morton_bits=60, builder="kernel")
        jax.block_until_ready(jb.nodes_box)
    tb = tlbvh.build_lbvh(torch.from_numpy(np.array(mesh.vertices)),
                          torch.from_numpy(np.array(mesh.indices)),
                          leaf_size=leaf, morton_bits=60)
    jf = convert.numpy_fields(jb)
    for name in ("nodes_box", "nodes_child", "nodes_first", "nodes_last",
                 "tri_v0", "tri_e1", "tri_e2", "tri_sorted", "tri_id",
                 "root_min", "root_max"):
        a, b = np.asarray(jf[name]), getattr(tb, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8),
                                      err_msg=name)
    # The 60-bit tree differs from the 30-bit one where 30-bit codes
    # collide.
    t30 = tlbvh.build_lbvh(torch.from_numpy(np.array(mesh.vertices)),
                           torch.from_numpy(np.array(mesh.indices)),
                           leaf_size=leaf)
    assert not torch.equal(t30.tri_id, tb.tri_id)


def test_build_lbvh_60_refuses_clustering_and_other_widths():
    mesh = jscenes.teapot_scene(300)
    v = torch.from_numpy(np.array(mesh.vertices))
    i = torch.from_numpy(np.array(mesh.indices))
    with pytest.raises(ValueError, match="30-bit"):
        tlbvh.build_lbvh(v, i, leaf_size=4, morton_bits=60, split_blocks=8)
    with pytest.raises(AssertionError, match="30-bit"):
        jlbvh.build_lbvh(jnp.asarray(mesh.vertices),
                         jnp.asarray(mesh.indices), leaf_size=4,
                         morton_bits=60, split_blocks=8)
    with pytest.raises(ValueError, match="morton_bits"):
        tlbvh.build_lbvh(v, i, leaf_size=4, morton_bits=45)


def test_codes60_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbuild.morton_codes60_cuda(torch.zeros((4, 3)))
