"""Diffuse texture sampling (counterpart of ``tpurt/passes/texture.py``).

Every texture of a mesh is one layer of a square atlas f32[NT, R, R, 3]
(``io/obj.py`` resamples each map onto it), so a tap is one computed flat
index into one array. Sampling runs as a G-buffer post-pass: the textured
albedo replaces the flat per-triangle albedo where the hit triangle has a
layer. It reads the G-buffer's own ``uv`` and ``tex_layer`` where the
G-buffer carries them (the attribute-tracked kernels and the shade table
interpolate uv per pixel), and otherwise interpolates uv from the mesh at
(tri_id, position) (the raster G-buffer, the ray cast without a table).
Elementwise tensor code and gathers on the G-buffer's device.
"""

from __future__ import annotations

import torch

from ..types import Mesh
from .shading import barycentrics_from_position


def sample_atlas(atlas: torch.Tensor, layer: torch.Tensor, uv: torch.Tensor,
                 bilinear: bool = True) -> torch.Tensor:
    """Sample the atlas with REPEAT wrapping.

    atlas f32[NT, R, R, 3]; layer i32[...] (clamped into [0, NT-1]); uv
    f32[..., 2] in texture space ((0, 0) is the first texel's corner; rows
    index uv[1]). Texel indices wrap by a floor modulo, so negative uv
    wraps as positive uv does. Nearest takes the texel whose centre is
    closest (the tap index plus ``frac >= 0.5``). Returns f32[..., 3]."""
    nt, r = atlas.shape[0], atlas.shape[1]
    flat = atlas.reshape(-1, 3)
    u = uv[..., 0] * r - 0.5
    v = uv[..., 1] * r - 0.5
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    lay = torch.clamp(layer.to(torch.int64), 0, nt - 1)

    def tap(xi, yi):
        xi = torch.remainder(xi, r)
        yi = torch.remainder(yi, r)
        return flat[(lay * r + yi) * r + xi]

    if not bilinear:
        return tap(x0 + (fx[..., 0] >= 0.5).to(torch.int64),
                   y0 + (fy[..., 0] >= 0.5).to(torch.int64))
    c00 = tap(x0, y0)
    c10 = tap(x0 + 1, y0)
    c01 = tap(x0, y0 + 1)
    c11 = tap(x0 + 1, y0 + 1)
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


def interpolate_uv(mesh: Mesh, tri_id: torch.Tensor,
                   position: torch.Tensor) -> torch.Tensor:
    """Per-pixel texture coordinates at hit points (``mesh`` on the
    device): barycentrics from the hit position against the hit triangle
    (the shared solve of ``shading.barycentrics_from_position``), then the
    corners' uv interpolated. Misses read triangle 0."""
    tid = torch.clamp(tri_id, min=0).long()
    tri = mesh.indices.long()[tid]
    v0 = mesh.vertices[tri[..., 0]]
    e1 = mesh.vertices[tri[..., 1]] - v0
    e2 = mesh.vertices[tri[..., 2]] - v0
    u, v = barycentrics_from_position(v0, e1, e2, position)
    uv0 = mesh.uv[tri[..., 0]]
    uv1 = mesh.uv[tri[..., 1]]
    uv2 = mesh.uv[tri[..., 2]]
    return uv0 + u[..., None] * (uv1 - uv0) + v[..., None] * (uv2 - uv0)


def apply_textures(mesh: Mesh, gbuf: dict, bilinear: bool = True
                   ) -> torch.Tensor:
    """Textured albedo f32[H, W, 3] for a G-buffer (``mesh`` on its
    device): the atlas sample where the pixel is valid and its triangle
    has a layer, the G-buffer's flat albedo elsewhere. Takes the
    G-buffer's ``uv`` and ``tex_layer`` where present, else interpolates
    from (tri_id, position)."""
    if "uv" in gbuf and "tex_layer" in gbuf:
        uv = gbuf["uv"]
        layer = gbuf["tex_layer"]
    else:
        tid = torch.clamp(gbuf["tri_id"], min=0).long()
        layer = mesh.tri_tex[tid]
        uv = interpolate_uv(mesh, gbuf["tri_id"], gbuf["position"])
    tex = sample_atlas(mesh.tex_atlas, layer, uv, bilinear=bilinear)
    use_tex = (layer >= 0) & gbuf["valid"]
    return torch.where(use_tex[..., None], tex, gbuf["albedo"])
