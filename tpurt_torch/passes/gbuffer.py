"""The G-buffers (counterpart of ``tpurt/passes/gbuffer.py``): the
attribute-tracked ray cast (``gbuffer_attr_pass``,
``gbuf_from_attr_channels``), where the closest-hit kernel returns the
winner's attribute channels, and the raster G-buffer
(``gbuffer_raster_pass``), where the tile rasterizer's z-fight selects
them. Either way the decode is elementwise tensor code, no per-pixel
gather."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..camera import (as_f32, camera_basis, generate_rays, normalize,
                      view_depth)
from ..kernels.raster import rasterize_rows
from ..kernels.traverse import trace_closest_attrs
from ..raster.setup import bin_rows, default_cap_rows
from ..types import Camera, Mesh
from .shading import oct_decode, unpack_rgb


def gbuffer_attr_pass(bvh, attr_tables, mesh: Mesh, cam: Camera,
                      width: int, height: int, rays=None):
    """G-buffer of the unfused frame: camera rays (or the given (origins,
    dirs)) -> ONE closest-hit kernel launch -> decode. Returns (G-buffer,
    walk counts i32[2])."""
    if rays is None:
        rays = generate_rays(cam, width, height, bvh.nodes.device)
    origins, dirs = rays
    ch, counts = trace_closest_attrs(bvh, origins, dirs, attr_tables)
    return gbuf_from_attr_channels(ch, origins, dirs, cam, mesh), counts


def gbuf_from_attr_channels(ch: Dict[str, torch.Tensor], origins, dirs,
                            cam: Camera, mesh: Mesh
                            ) -> Dict[str, torch.Tensor]:
    """Attribute-channel dict (``kernels/traverse._attr_channels``) ->
    full G-buffer: position, smooth and geometric normals flipped toward
    the viewer, albedo, depth, t, tri_id, valid, view_dir."""
    if mesh.textured:
        raise NotImplementedError("textured G-buffer decode is not ported")
    valid = ch["sidx"] >= 0
    t = ch["t"]
    position = origins + dirs * torch.where(valid, t, 0.0)[..., None]
    n0 = oct_decode(ch["oct"][..., 0:2])
    n1 = oct_decode(ch["oct"][..., 2:4])
    n2 = oct_decode(ch["oct"][..., 4:6])
    u, v = ch["u"], ch["v"]
    smooth = normalize(n0 + u[..., None] * (n1 - n0)
                       + v[..., None] * (n2 - n0))
    gnormal = normalize(ch["gn"])
    albedo = unpack_rgb(ch["kd"])
    zeros = torch.zeros_like(smooth)
    vmask = valid[..., None]
    smooth = torch.where(vmask, smooth, zeros)
    gnormal = torch.where(vmask, gnormal, zeros)
    albedo = torch.where(vmask, albedo, zeros)
    gd = gnormal * dirs
    facing = torch.sign(-(gd[..., 0:1] + gd[..., 1:2] + gd[..., 2:3]))
    flip = torch.where(facing == 0, 1.0, facing)
    return {
        "position": position,
        "normal": smooth * flip,
        "gnormal": gnormal * flip,
        "albedo": albedo,
        "depth": view_depth(cam, position, valid),
        "t": t,
        "tri_id": ch["tri_id"],
        "valid": valid,
        "view_dir": dirs,
    }


def gbuffer_raster_pass(mesh: Mesh, cam: Camera, width: int, height: int,
                        shade_table_orig=None,
                        cap_pairs: Optional[int] = None
                        ) -> Dict[str, torch.Tensor]:
    """Primary visibility by tile rasterization, the reference program's
    own strategy: bin the mesh (``raster.setup.bin_rows``), ONE rasterizer
    launch, then decode. Position comes back from 1/w along the view ray.
    ``mesh`` holds tensors on the device (``Mesh.on``).
    ``shade_table_orig`` is accepted and ignored, as in ``tpurt``; its
    deferred z-only variant (``raster_deferred``) is not ported. The dict
    gains ``raster_overflow`` (bool[]): the pair capacity dropped coverage
    and the frame must be rendered again with a bigger one."""
    dev = mesh.vertices.device
    if cap_pairs is None:
        cap_pairs = default_cap_rows(mesh.num_triangles)
    bins = bin_rows(cam, mesh, width, height, cap_pairs)
    tri_id, at = rasterize_rows(bins, width, height)
    valid = tri_id >= 0
    origins, dirs = generate_rays(cam, width, height, dev)
    _, _, forward = camera_basis(cam, dev)
    depth = torch.where(valid, 1.0 / torch.clamp(at[2], min=1e-30),
                        as_f32(cam.zfar, dev))
    cosf = dirs[..., 0] * forward[0] + dirs[..., 1] * forward[1] \
        + dirs[..., 2] * forward[2]
    t = torch.where(valid, depth / torch.clamp(cosf, min=1e-6), torch.inf)
    position = origins + dirs * torch.where(valid, t, 0.0)[..., None]
    smooth = at[3:6].permute(1, 2, 0)
    gnormal = at[6:9].permute(1, 2, 0)
    gd = gnormal * dirs
    facing = torch.sign(-(gd[..., 0:1] + gd[..., 1:2] + gd[..., 2:3]))
    flip = torch.where(facing == 0, 1.0, facing)
    return {
        "position": position,
        "normal": smooth * flip,
        "gnormal": gnormal * flip,
        "albedo": at[9:12].permute(1, 2, 0),
        "depth": depth,
        "t": t,
        "tri_id": tri_id,
        "valid": valid,
        "view_dir": dirs,
        "raster_overflow": bins.overflow,
    }
