"""The attribute-tracked G-buffer (counterpart of ``tpurt/passes/gbuffer.py``
``gbuffer_attr_pass`` and ``gbuf_from_attr_channels``): the closest-hit
kernel returns the winner's attribute channels, and the decode is
elementwise tensor code, no per-pixel gather."""

from __future__ import annotations

from typing import Dict

import torch

from ..camera import generate_rays, normalize, view_depth
from ..kernels.traverse import trace_closest_attrs
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
