"""The G-buffers (counterpart of ``tpurt/passes/gbuffer.py``): the
attribute-tracked ray cast (``gbuffer_attr_pass``,
``gbuf_from_attr_channels``), where the closest-hit kernel returns the
winner's attribute channels; the shade-table ray cast (``gbuffer_pass``,
``gbuf_from_table``), where the kernel returns t and the sorted hit index
and ONE row gather per pixel reads the packed shade table; the ray cast
without a table (``gbuffer_pass`` with none, ``shade_attributes``: t and
tri_id, then gathers of the mesh by tri_id); and the raster G-buffer
(``gbuffer_raster_pass``), where the tile rasterizer's z-fight selects the
attributes, or, deferred, the z-only rasterizer returns the triangle and
its barycentrics and ONE row gather per pixel reads the original-order
shade table. Apart from the gathers, the decode is elementwise tensor
code. A textured mesh's albedo is sampled afterwards, on every G-buffer
(``passes/texture.apply_textures``, applied by the app's productions):
the attribute and shade-table G-buffers hand it their interpolated uv and
layer, the others their (tri_id, position)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..camera import _cross, as_f32, generate_rays, normalize, view_depth
from ..kernels.raster import rasterize_rows, rasterize_rows16
from ..bvh.wide import WideBVHT
from ..kernels.traverse import trace_closest_attrs, trace_closest_attrs_t
from ..raster.setup import bin_rows, default_cap_rows
from ..spans import count, span
from ..types import Camera, Mesh
from .shading import (barycentrics_from_position, gather_table_rows,
                      oct_decode, shade_from_table, shade_from_table_uv,
                      table_tri_id, table_uv, unpack_rgb)


def gbuffer_attr_pass(bvh, attr_tables, mesh: Mesh, cam: Camera,
                      width: int, height: int, rays=None):
    """G-buffer of the unfused frame: camera rays (or the given (origins,
    dirs)) -> ONE closest-hit kernel launch -> decode. On a WideBVHT
    ``attr_tables`` are its transposed rows (``make_leaf_attr_rows_t``)
    and the w8t attribute walk runs. Returns (G-buffer, walk counts
    i32[2])."""
    if rays is None:
        with span("tpurt.rays"):
            rays = generate_rays(cam, width, height, bvh.nodes.device)
    origins, dirs = rays
    trace = trace_closest_attrs_t if isinstance(bvh, WideBVHT) \
        else trace_closest_attrs
    with span("tpurt.walk"):
        ch, counts = trace(bvh, origins, dirs, attr_tables,
                           textured=mesh.textured)
    with span("tpurt.gbuffer"):
        return gbuf_from_attr_channels(ch, origins, dirs, cam, mesh), counts


def _viewer_facing(gnormal, dirs) -> torch.Tensor:
    """+1 or -1 per pixel: the sign that turns the geometric normal toward
    the viewer (+1 where it is perpendicular to the ray)."""
    gd = gnormal * dirs
    facing = torch.sign(-(gd[..., 0:1] + gd[..., 1:2] + gd[..., 2:3]))
    return torch.where(facing == 0, 1.0, facing)


def shade_attributes(mesh: Mesh, tri_id: torch.Tensor,
                     position: torch.Tensor, valid: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """Interpolated vertex attributes at hit points, by gathers of the mesh
    (``mesh`` on the device, ``Mesh.on``): barycentrics from the hit
    position against the hit triangle, the smooth normal at them, the
    geometric normal e1 x e2 and the triangle's albedo; zero off the valid
    mask."""
    tid = torch.clamp(tri_id, min=0).long()
    tri = mesh.indices.long()[tid]                           # [..., 3]
    v0 = mesh.vertices[tri[..., 0]]
    e1 = mesh.vertices[tri[..., 1]] - v0
    e2 = mesh.vertices[tri[..., 2]] - v0
    u, v = barycentrics_from_position(v0, e1, e2, position)
    n0 = mesh.normals[tri[..., 0]]
    n1 = mesh.normals[tri[..., 1]]
    n2 = mesh.normals[tri[..., 2]]
    smooth = normalize(n0 + u[..., None] * (n1 - n0)
                       + v[..., None] * (n2 - n0))
    gnormal = normalize(_cross(e1, e2))
    albedo = mesh.albedo[tid]
    zeros = torch.zeros_like(smooth)
    vmask = valid[..., None]
    return {
        "normal": torch.where(vmask, smooth, zeros),
        "gnormal": torch.where(vmask, gnormal, zeros),
        "albedo": torch.where(vmask, albedo, zeros),
    }


def gbuffer_pass(trace_closest: Callable, mesh: Mesh, cam: Camera,
                 width: int, height: int, shade_table=None, rays=None):
    """The ray-cast G-buffer (``tpurt``'s ``gbuffer_pass``): camera rays
    (or the given (origins, dirs)) -> ``trace_closest(origins, dirs)``.
    With the packed shade table the tracer returns (t, tri_id or None,
    sidx, walk counts) -> ``gbuf_from_table``; without one it returns (t,
    tri_id, walk counts) and the attributes come from
    ``shade_attributes`` on ``mesh`` (on the device). Returns (G-buffer,
    walk counts)."""
    if rays is None:
        dev = (shade_table if shade_table is not None
               else mesh.vertices).device
        with span("tpurt.rays"):
            rays = generate_rays(cam, width, height, dev)
    origins, dirs = rays
    with span("tpurt.walk"):
        hit = trace_closest(origins, dirs)
    with span("tpurt.gbuffer"):
        return _gbuf_from_hit(hit, origins, dirs, cam, mesh, shade_table)


def _gbuf_from_hit(hit, origins, dirs, cam: Camera, mesh: Mesh,
                   shade_table):
    """``gbuffer_pass``'s decode of the tracer's result."""
    if shade_table is not None:
        t, tri_id, sidx, counts = hit
        return gbuf_from_table(t, tri_id, sidx, origins, dirs, cam, mesh,
                               shade_table), counts
    t, tri_id, counts = hit
    valid = tri_id >= 0
    position = origins + dirs * torch.where(valid, t, 0.0)[..., None]
    attrs = shade_attributes(mesh, tri_id, position, valid)
    flip = _viewer_facing(attrs["gnormal"], dirs)
    return {
        "position": position,
        "normal": attrs["normal"] * flip,
        "gnormal": attrs["gnormal"] * flip,
        "albedo": attrs["albedo"],
        "depth": view_depth(cam, position, valid),
        "t": t,
        "tri_id": tri_id,
        "valid": valid,
        "view_dir": dirs,
    }, counts


def gbuf_from_table(t, tri_id, sidx, origins, dirs, cam: Camera, mesh: Mesh,
                    shade_table) -> Dict[str, torch.Tensor]:
    """A closest hit's t, tri_id (or None) and sorted index -> full
    G-buffer: ONE row gather per pixel keyed by sidx gives the
    interpolated smooth normal, the geometric normal and the albedo, and
    tri_id from the row's id lane where the tracer left it out; both
    normals are turned toward the viewer. A textured mesh's G-buffer also
    carries ``uv`` (interpolated from the row's corner uvs) and
    ``tex_layer`` (-1 off the valid mask)."""
    valid = sidx >= 0 if tri_id is None else tri_id >= 0
    position = origins + dirs * torch.where(valid, t, 0.0)[..., None]
    rows = gather_table_rows(shade_table, sidx)
    attrs = shade_from_table(rows, position, valid)
    if tri_id is None:
        tri_id = table_tri_id(rows, valid)
    extra = {}
    if mesh.textured:
        uv, layer = table_uv(rows, attrs["u"], attrs["v"])
        extra = {"uv": uv, "tex_layer": torch.where(valid, layer, -1)}
    flip = _viewer_facing(attrs["gnormal"], dirs)
    return {
        "position": position,
        "normal": attrs["normal"] * flip,
        "gnormal": attrs["gnormal"] * flip,
        "albedo": attrs["albedo"],
        "depth": view_depth(cam, position, valid),
        "t": t,
        "tri_id": tri_id,
        "valid": valid,
        "view_dir": dirs,
        **extra,
    }


def gbuf_from_attr_channels(ch: Dict[str, torch.Tensor], origins, dirs,
                            cam: Camera, mesh: Mesh
                            ) -> Dict[str, torch.Tensor]:
    """Attribute-channel dict (``kernels/traverse._attr_channels``) ->
    full G-buffer: position, smooth and geometric normals flipped toward
    the viewer, albedo, depth, t, tri_id, valid, view_dir; for a textured
    mesh also the kernel's interpolated ``uv`` and ``tex_layer`` (i32, -1
    off the valid mask)."""
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
    flip = _viewer_facing(gnormal, dirs)
    extra = {}
    if mesh.textured:
        extra = {"uv": ch["uv"],
                 "tex_layer": torch.where(valid, ch["layer"], -1.0)
                 .to(torch.int32)}
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
        **extra,
    }


def _bin_and_rasterize(mesh: Mesh, cam: Camera, width: int, height: int,
                       cap_pairs: Optional[int], fmt: str):
    """The binning (``bin_rows``, span ``tpurt.gbuffer.bin``, its pair
    count the traced frame's counter ``raster_pairs``) and ONE rasterizer
    launch of the records ``fmt`` (span ``tpurt.gbuffer.raster``) ->
    (bins, the rasterizer's outputs)."""
    if cap_pairs is None:
        cap_pairs = default_cap_rows(mesh.num_triangles)
    with span("tpurt.gbuffer.bin"):
        bins = bin_rows(cam, mesh, width, height, cap_pairs, fmt=fmt)
        count("raster_pairs", bins.pairs)
    raster = rasterize_rows if fmt == "full" else rasterize_rows16
    with span("tpurt.gbuffer.raster"):
        return bins, raster(bins, width, height)


def gbuffer_raster_pass(mesh: Mesh, cam: Camera, width: int, height: int,
                        shade_table_orig=None,
                        cap_pairs: Optional[int] = None,
                        deferred: bool = False) -> Dict[str, torch.Tensor]:
    """Primary visibility by tile rasterization, the reference program's
    own strategy: bin the mesh (``raster.setup.bin_rows``), ONE rasterizer
    launch, then decode. The position is the winning triangle's v0 + u e1
    + v e2 and t its distance from the camera, so a shadow ray starts on
    the surface: 1/w, from which ``tpurt`` rebuilds them along the view
    ray, is off by up to 5e-2 relative on small far triangles, which puts
    such points under their surface by more than the shadow bias; depth
    stays 1/(1/w). ``mesh`` holds tensors on the device (``Mesh.on``).
    ``shade_table_orig`` is read only with ``deferred=True``
    (``raster_deferred``), which takes ``_gbuffer_raster_deferred``, and
    then it is required. The dict gains ``raster_overflow`` (bool[]): the
    pair capacity dropped coverage and the frame must be rendered again
    with a bigger one. The binning transforms the mesh with a block
    camera's clip words (``raster.setup.clip_transform``)."""
    if deferred:
        if shade_table_orig is None:
            raise ValueError("the deferred raster G-buffer needs the "
                             "original-order shade table")
        return _gbuffer_raster_deferred(mesh, cam, width, height,
                                        shade_table_orig, cap_pairs)
    dev = mesh.vertices.device
    bins, (tri_id, at) = _bin_and_rasterize(mesh, cam, width, height,
                                            cap_pairs, "full")
    valid = tri_id >= 0
    origins, dirs = generate_rays(cam, width, height, dev)
    depth = torch.where(valid, 1.0 / torch.clamp(at[2], min=1e-30),
                        as_f32(cam.zfar, dev))
    tri = mesh.indices[torch.clamp(tri_id, min=0).long()].long()
    corners = mesh.vertices[tri]                            # [H, W, 3, 3]
    v0 = corners[..., 0, :]
    position = v0 + at[0][..., None] * (corners[..., 1, :] - v0) \
        + at[1][..., None] * (corners[..., 2, :] - v0)
    position = torch.where(valid[..., None], position, 0.0)
    vview = position - origins
    t = torch.where(valid, torch.sqrt((vview * vview).sum(-1)), torch.inf)
    smooth = at[3:6].permute(1, 2, 0)
    gnormal = at[6:9].permute(1, 2, 0)
    flip = _viewer_facing(gnormal, dirs)
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


def _gbuffer_raster_deferred(mesh: Mesh, cam: Camera, width: int,
                             height: int, shade_table_orig,
                             cap_pairs: Optional[int]
                             ) -> Dict[str, torch.Tensor]:
    """The deferred raster G-buffer (``tpurt``'s
    ``_gbuffer_raster_deferred``): z-only records (``bin_rows(...,
    fmt="z16")``), ONE launch of the z-only rasterizer for (tri_id, u, v,
    1/w), then ONE row gather per pixel of the original-order shade table.
    The position is the winner's v0 + u e1 + v e2 (no round trip through
    1/w and the view ray), the view vector and t come from it, and no
    camera ray is generated."""
    bins, (tri_id, u, v, invw) = _bin_and_rasterize(mesh, cam, width, height,
                                                    cap_pairs, "z16")
    valid = tri_id >= 0
    n = shade_table_orig.shape[0]
    rows = shade_table_orig[torch.clamp(tri_id, 0, n - 1).long()]
    attrs = shade_from_table_uv(rows, u, v, valid)
    position = rows[..., 0:3] + u[..., None] * rows[..., 3:6] \
        + v[..., None] * rows[..., 6:9]
    position = torch.where(valid[..., None], position, 0.0)
    dev = position.device
    depth = torch.where(valid, 1.0 / torch.clamp(invw, min=1e-30),
                        as_f32(cam.zfar, dev))
    vview = position - as_f32(cam.position, dev)
    norm = torch.sqrt((vview * vview).sum(-1))
    t = torch.where(valid, norm, torch.inf)
    view_dir = vview / torch.clamp(t, min=1e-20)[..., None]
    flip = _viewer_facing(attrs["gnormal"], vview)
    return {
        "position": position,
        "normal": attrs["normal"] * flip,
        "gnormal": attrs["gnormal"] * flip,
        "albedo": attrs["albedo"],
        "depth": depth,
        "t": t,
        "tri_id": tri_id,
        "valid": valid,
        "view_dir": view_dir,
        "raster_overflow": bins.overflow,
    }
