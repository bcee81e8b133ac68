"""Whole frames of the port's Renderer in rebuild mode (config 2's path,
CPU, plain versions of the kernels): the checked-in golden, animated
frames, and the recovery from a pad the geometry outgrew."""

import os

import numpy as np
import pytest
import torch

import tpurt_torch.scenes as tscenes
from tpurt_torch.app import Renderer
from tpurt_torch.io.image import read_png, to_uint8
from tpurt_torch.types import Light, Mesh, RenderConfig

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
DIRECTION = (0.45, 0.8, 0.3)


def _renderer(mesh, mode="rebuild", camera=None, **cfg):
    fields = dict(width=128, height=96, use_pallas=True, gbuffer="ray",
                  fused_shadow=True, leaf_size=8, seed=0)
    fields.update(cfg)
    return Renderer(mesh, camera or tscenes.default_camera_for(mesh),
                    Light.directional(DIRECTION), RenderConfig(**fields),
                    mode=mode, device="cpu")


@pytest.fixture(scope="module")
def mesh():
    return tscenes.teapot_scene(1500)


def test_rebuild_frame_matches_golden(mesh):
    """The fused config of tests/gen_goldens.py, with the tolerance of
    tests/test_golden.py. The golden was rendered on an SAH tree, so this
    also shows that the rebuilt Morton tree gives the same image."""
    r = _renderer(mesh)
    assert r.config.order_children is False          # clustered rebuild
    assert r.bvh.leaf_block is not None
    img = r.render_frame()["image"].numpy()
    golden = read_png(os.path.join(GOLDEN, "teapot_128x96.png")
                      ).astype(np.int16)
    ours = to_uint8(img).astype(np.int16)
    assert ours.shape == golden.shape
    frac_off = (np.abs(ours - golden) > 2).mean()
    assert frac_off < 0.005, f"{frac_off:.4%} pixels differ"
    assert r.stats["build_ms"] > 0 and r.stats["overflow_recoveries"] == 0
    again = r.render_frame()["image"]
    assert torch.equal(again, torch.from_numpy(img))


def _deformed(r, mesh):
    """The Renderer's current geometry as a host mesh."""
    return Mesh(vertices=r.mesh.vertices.numpy(),
                normals=r.mesh.normals.numpy(),
                indices=np.asarray(mesh.indices),
                albedo=np.asarray(mesh.albedo))


def test_animated_frames_match_static_frames(mesh):
    """Two set_vertices steps: each rebuilt frame against a static SAH
    render of the same deformed geometry (the two trees may split ties on
    t differently)."""
    r = _renderer(mesh, width=64, height=48)
    r.render_frame()
    for step in (1, 2):
        r.set_vertices(tscenes.deform(mesh, 0.35 * step))
        img = r.render_frame()["image"].numpy()
        want = _renderer(_deformed(r, mesh), mode="static", camera=r.camera,
                         width=64, height=48).render_frame()["image"].numpy()
        assert np.isfinite(img).all()
        diff = np.abs(img - want).max(axis=-1)
        assert (diff > 1e-3).mean() <= 2e-3, f"{(diff > 1e-3).sum()} pixels"
    assert r.stats["overflow_recoveries"] == 0


def test_overflow_recovery_rebuilds_with_the_recount(mesh):
    """A pad forced below the count: the frame after set_vertices reads the
    count, recounts on a full-box build and reruns the rebuild with the
    new pad, so it renders exactly what a fresh Renderer of the deformed
    geometry renders."""
    r = _renderer(mesh, width=64, height=48)
    r._nw_pad = 4
    r.set_vertices(tscenes.deform(mesh, 0.21))
    out = r.render_frame()
    assert r.stats["overflow_recoveries"] == 1
    fresh = _renderer(mesh, width=64, height=48)
    fresh.set_vertices(tscenes.deform(mesh, 0.21))
    want = fresh.render_frame()
    assert r._nw_pad == fresh._nw_pad
    assert torch.equal(r.accel.nodes, fresh.accel.nodes)
    assert torch.equal(out["image"], want["image"])


def test_set_vertices_outside_rebuild_raises(mesh):
    r = _renderer(mesh, mode="static", width=32, height=32)
    with pytest.raises(NotImplementedError, match="refit"):
        r.set_vertices(tscenes.deform(mesh, 0.1))
