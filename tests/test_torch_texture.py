"""The port's texture pass (``tpurt_torch.passes.texture``) against the JAX
package's on the same numpy inputs, made from a seed: ``sample_atlas``
(nearest and bilinear, uv far outside [0, 1) on both sides, so the REPEAT
wrap of negative texel indices is a floor modulo, layers past both ends),
``interpolate_uv`` and ``apply_textures`` with and without the G-buffer's
own uv and layer. Everything within 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.passes.texture as jtex
import tpurt.scenes as jscenes
import tpurt_torch.passes.texture as ttex
from tpurt_torch import convert

torch.set_num_threads(1)

NT, RES = 3, 16


def _atlas(seed=1):
    return np.random.default_rng(seed).random((NT, RES, RES, 3),
                                              dtype=np.float32)


def _uv_layer(n, lo, hi, seed=2):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    # Exact texel edges and centres too, where the taps switch.
    edges = (np.arange(-2 * RES, 2 * RES) / RES).astype(np.float32)
    uv[:edges.size, 0] = edges
    uv[edges.size:2 * edges.size, 1] = edges + np.float32(0.5 / RES)
    layer = rng.integers(-1, NT + 1, n).astype(np.int32)
    return uv, layer


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("bilinear", [False, True])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-3.5, 3.5)])
def test_sample_atlas_equals_jax(bilinear, lo, hi):
    atlas = _atlas()
    uv, layer = _uv_layer(4096, lo, hi)
    want = jtex.sample_atlas(jnp.asarray(atlas), jnp.asarray(layer),
                             jnp.asarray(uv), bilinear=bilinear)
    got = ttex.sample_atlas(torch.from_numpy(atlas), torch.from_numpy(layer),
                            torch.from_numpy(uv), bilinear=bilinear)
    assert got.dtype == torch.float32 and got.shape == (4096, 3)
    _close(got, want)


def test_negative_uv_wraps_like_positive():
    """uv and uv - 2 name the same texels (a floor modulo, never a
    truncating one)."""
    atlas = torch.from_numpy(_atlas())
    uv, layer = _uv_layer(512, 0.05, 0.95)
    a = ttex.sample_atlas(atlas, torch.from_numpy(layer),
                          torch.from_numpy(uv), bilinear=False)
    b = ttex.sample_atlas(atlas, torch.from_numpy(layer),
                          torch.from_numpy(uv - 2.0), bilinear=False)
    assert torch.equal(a, b)


def _textured_teapot():
    jm = jscenes.teapot_scene(600)
    rng = np.random.default_rng(5)
    v = np.asarray(jm.vertices)
    uv = np.stack([v[:, 0] * 0.8 - v[:, 2] * 0.3, v[:, 1] * 1.1],
                  axis=1).astype(np.float32)
    tri_tex = rng.integers(-1, NT, jm.num_triangles).astype(np.int32)
    jm = dataclasses.replace(jm, uv=jnp.asarray(uv),
                             tex_atlas=jnp.asarray(_atlas(7)),
                             tri_tex=jnp.asarray(tri_tex))
    return jm, convert.mesh(convert.numpy_fields(jm)).on("cpu")


def _hits(jm, n=2048, seed=9):
    """Points on random triangles, and some misses (tri_id -1)."""
    rng = np.random.default_rng(seed)
    tid = rng.integers(-1, jm.num_triangles, n).astype(np.int32)
    v = np.asarray(jm.vertices)[np.asarray(jm.indices)[np.maximum(tid, 0)]]
    a, b = rng.random((2, n, 1), dtype=np.float32) * 0.5
    pos = (v[:, 0] + a * (v[:, 1] - v[:, 0]) + b * (v[:, 2] - v[:, 0]))
    return tid.reshape(32, 64), pos.astype(np.float32).reshape(32, 64, 3)


def test_interpolate_uv_equals_jax():
    jm, tm = _textured_teapot()
    tid, pos = _hits(jm)
    want = jtex.interpolate_uv(jm, jnp.asarray(tid), jnp.asarray(pos))
    got = ttex.interpolate_uv(tm, torch.from_numpy(tid),
                              torch.from_numpy(pos))
    _close(got, want)


def _gbuf(jm, with_uv: bool, seed=3):
    rng = np.random.default_rng(seed)
    tid, pos = _hits(jm)
    g = {"tri_id": tid, "position": pos, "valid": tid >= 0,
         "albedo": rng.random((32, 64, 3), dtype=np.float32)}
    if with_uv:
        uv, layer = _uv_layer(32 * 64, -2.0, 2.0, seed)
        g.update(uv=uv.reshape(32, 64, 2),
                 tex_layer=np.where(tid >= 0, layer.reshape(32, 64), -1))
    return g


@pytest.mark.parametrize("with_uv", [False, True])
@pytest.mark.parametrize("bilinear", [False, True])
def test_apply_textures_equals_jax(with_uv, bilinear):
    jm, tm = _textured_teapot()
    g = _gbuf(jm, with_uv)
    want = jtex.apply_textures(jm, {k: jnp.asarray(v) for k, v in g.items()},
                               bilinear=bilinear)
    got = ttex.apply_textures(tm, {k: torch.from_numpy(np.asarray(v))
                                   for k, v in g.items()}, bilinear=bilinear)
    _close(got, want)
    layer = g["tex_layer"] if with_uv \
        else np.asarray(tm.tri_tex)[np.maximum(g["tri_id"], 0)]
    flat = ~((layer >= 0) & g["valid"])
    assert flat.any() and (~flat).any()
    np.testing.assert_array_equal(got.numpy()[flat], g["albedo"][flat])
