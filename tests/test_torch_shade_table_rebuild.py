"""Rebuild frames (config 2) through the shade table: the port's
Renderer(mode="rebuild", inkernel_attrs=False) rebuilds the accel and the
packed shade table of the rebuilt, payload-sorted tree every frame
(``_rebuild_fused(tables="st")``); its fused0 frame against the JAX
package's Renderer with the same flag (CPU, Pallas interpret mode), with
the tolerance of tests/test_torch_app.py. The unfused frame is in
test_torch_shade_table_rebuild_unfused.py."""

import numpy as np
import pytest
import torch

import tpurt.scenes as jscenes
from tpurt.types import Light as JLight
from tpurt.types import RenderConfig as JRenderConfig
import tpurt_torch.app as tapp
import tpurt_torch.scenes as tscenes
from tpurt_torch.app import Renderer
from tpurt_torch.passes.shading import make_shade_table
from tpurt_torch.types import Light, RenderConfig

from test_torch_app import _assert_close_frames, _jax_frame

torch.set_num_threads(1)

DIRECTION = (0.45, 0.8, 0.3)


def rebuild_frames(fused: bool):
    """tpurt's and the port's rebuilt frame (teapot 600, 64x48, leaf 8)
    and the port's Renderer."""
    fields = dict(width=64, height=48, leaf_size=8, inkernel_attrs=False,
                  fused_shadow=fused)
    jmesh = jscenes.teapot_scene(600)
    jimg = _jax_frame(jmesh, jscenes.default_camera_for(jmesh),
                      JLight.directional(DIRECTION), JRenderConfig(**fields),
                      mode="rebuild")
    tmesh = tscenes.teapot_scene(600)
    r = Renderer(tmesh, tscenes.default_camera_for(tmesh),
                 Light.directional(DIRECTION), RenderConfig(**fields),
                 mode="rebuild", device="cpu")
    out = r.render_frame()
    return jimg, out, r


def test_rebuild_fused_frame_matches_jax_renderer():
    jimg, out, r = rebuild_frames(fused=True)
    assert r.route == "fused0" and r.attr_tables is None
    _assert_close_frames(jimg, out["image"].numpy())
    assert out["walk_counts"].tolist() == [0, 0]
    # The frame's table is the rebuilt tree's.
    assert torch.equal(r.shade_table.view(torch.int32),
                       make_shade_table(r.bvh, r.mesh).view(torch.int32))


def test_rebuild_makes_the_table_of_the_rebuilt_tree():
    """_rebuild_fused(tables="st") returns the rebuilt tree's shade table
    and no attribute rows; tables=None (the raster G-buffer) returns no
    table, tables="sto" the original-order one."""
    mesh = tscenes.teapot_scene(600).on("cpu")
    r = Renderer(mesh, tscenes.default_camera_for(mesh),
                 Light.directional(DIRECTION),
                 RenderConfig(width=16, height=16, leaf_size=8,
                              inkernel_attrs=False),
                 mode="rebuild", device="cpu")
    args = (mesh.vertices, mesh.indices, mesh, 8, r._nw_pad)
    kw = dict(split_blocks=r._rebuild_splits)
    bvh, _, st, count = tapp._rebuild_fused(*args, tables="st", **kw)
    assert int(count) <= r._nw_pad
    assert st.shape == (bvh.num_sorted_tris, 24)
    assert torch.equal(st.view(torch.int32)[:, 16], bvh.tri_id)
    assert tapp._rebuild_fused(*args, tables=None, **kw)[2] is None
    # "sto", the deferred raster G-buffer's original-order table.
    sto = tapp._rebuild_fused(*args, tables="sto", **kw)[2]
    assert sto.shape == (mesh.num_triangles, 16)
    with pytest.raises(ValueError, match="tables"):
        tapp._rebuild_fused(*args, tables="orig", **kw)
