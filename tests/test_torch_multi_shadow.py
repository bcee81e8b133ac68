"""The port's fused multi-light traversal (plain PyTorch version, which the
wrapper takes for CPU tensors) against the JAX package's
``trace_closest_multi_shadow_pallas`` in interpret mode, with the
attribute tables, on the SAME accel carried across by tpurt_torch.convert:
teapot 1500, 64x32 camera rays, directional + point + directional light.

Tolerances: those of tests/test_torch_traverse.py for the hit set and the
attribute channels; each bit of the occlusion mask may differ on at most
1e-3 of valid pixels (biased origins on a shadow boundary, where the
reference's FMA-contracted products round differently). The helpers here
serve the soft-shadow parity files too.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.bvh.sah as jsah
import tpurt.bvh.wide as jwide
import tpurt.scenes as jscenes
from tpurt.camera import generate_rays as jgenerate_rays
from tpurt.kernels.traverse import trace_closest_multi_shadow_pallas
from tpurt.passes.shading import make_leaf_attr_rows as jmake_leaf_attr_rows
import tpurt_torch.convert as convert
from tpurt_torch.kernels.traverse import trace_closest_multi_shadow

from test_torch_native import ensure_native_libraries
from test_torch_traverse import BIAS, LIGHT_DIR, LIGHT_POS, _check_attrs, \
    _check_hits

torch.set_num_threads(1)
ensure_native_libraries()

FILL_DIR = np.float32([-0.5, 0.7, 0.2]) / np.float32(
    np.linalg.norm([-0.5, 0.7, 0.2]))
FILL2_DIR = np.float32([0.1, 0.9, -0.4]) / np.float32(
    np.linalg.norm([0.1, 0.9, -0.4]))


@contextlib.contextmanager
def jax_checks_off():
    """JAX's internal consistency checks (on in conftest) double the
    interpret-mode tracing time and check jax, not the port."""
    checks = jax.config.jax_enable_checks
    jax.config.update("jax_enable_checks", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_checks", checks)


def parity_scene(leaf: int):
    """One accel in both packages: the JAX accel with its attribute rows,
    ordered near-first for the camera, and its torch copy; 64x32 rays."""
    mesh = jscenes.teapot_scene(1500)
    cam = jscenes.default_camera_for(mesh)
    bvh = jsah.build_sah_lbvh(mesh, leaf)
    wide = jwide.build_wide(bvh, from_node_boxes=True)
    at = jmake_leaf_attr_rows(bvh, mesh)
    acc = jwide.order_children_for_point(wide, cam.position)
    o, d = jgenerate_rays(cam, 64, 32)
    return types.SimpleNamespace(
        acc=acc, at=at, o=o, d=d,
        twide=convert.wide_bvh(convert.numpy_fields(acc), "cpu"),
        tat=convert.attr_tables(at[0], at[1], "cpu"),
        to=torch.from_numpy(np.array(o)), td=torch.from_numpy(np.array(d)))


def np_channels(ch):
    return {k: np.asarray(v) for k, v in ch.items()}


def check_bit(jch, jmask, tmask, bit: int):
    """Bit ``bit`` of the port's mask against the reference's."""
    valid = jch["sidx"] >= 0
    jb = (np.asarray(jmask) >> bit) & 1
    tb = (np.asarray(tmask) >> bit) & 1
    mism = (jb != tb) & valid
    assert mism.sum() <= 1e-3 * valid.sum(), f"bit {bit}: {mism.sum()}"
    assert not tb[~valid].any()
    assert tb[valid].any()


def multi_case(leaf: int):
    s = parity_scene(leaf)
    lights = [(LIGHT_DIR, None), (None, LIGHT_POS), (FILL_DIR, None)]
    with jax_checks_off():
        jch, jmask = trace_closest_multi_shadow_pallas(
            s.acc, s.o, s.d,
            [(None if ld is None else jnp.asarray(ld),
              None if lp is None else jnp.asarray(lp)) for ld, lp in lights],
            BIAS, attr_tables=s.at, interpret=True)
    tch, tmask, counts = trace_closest_multi_shadow(
        s.twide, s.to, s.td, lights, BIAS, attr_tables=s.tat)
    return (np_channels(jch), np.asarray(jmask),
            {k: v.numpy() for k, v in tch.items()}, tmask.numpy(),
            counts.numpy())


@pytest.fixture(scope="module")
def leaf8():
    return multi_case(8)


def test_multi_hits_match_pallas_leaf8(leaf8):
    _check_hits(leaf8)


def test_multi_attributes_match_pallas_leaf8(leaf8):
    _check_attrs(leaf8)


@pytest.mark.parametrize("bit", [0, 1, 2])
def test_multi_mask_bits_match_pallas_leaf8(leaf8, bit):
    jch, jmask, _, tmask, _ = leaf8
    check_bit(jch, jmask, tmask, bit)
