"""Shading tables and their encodings (counterpart of
``tpurt/passes/shading.py``): the leaf attribute rows, built by a gather
keyed by the sorted original ids (``make_leaf_attr_rows``, once per
scene) or from columns that rode the rebuild's sort
(``attr_payload_columns`` -> ``leaf_attr_rows_from_sorted``), and their
transposed twin for the w8t accel (``make_leaf_attr_rows_t``); the packed
shade table (``make_shade_table``) and its per-pixel decode
(``table_tri_id``, ``table_uv``, ``barycentrics_from_position``,
``shade_from_table``); the original-order table of the deferred raster
G-buffer (``make_shade_table_orig``, decoded at the rasterizer's
barycentrics by ``shade_from_table_uv``);
and the animated mesh's vertex normals (``smooth_normals_device``).

The fused kernel selects the winning triangle's shading attributes from
leaf-major rows while the candidate is in registers, so the G-buffer needs
no per-pixel gather. Per-triangle lanes inside a row (base 16*j):

    [0:3]  oct(n0), oct(n1), oct(n2), each packed into one exact float
    [3]    packed 8-bit rgb albedo
    [4]    texture layer (-1 = untextured)
    [5:11] uv0, uv1-uv0, uv2-uv0
    [11]   original triangle id as an exact float
    [12:16] pad

Slots 0..7 of a leaf live in ``at0``, slots 8..13 in ``at1`` (a (1, 128)
dummy when leaf_size <= 8). ``torch.round`` rounds half to even, as
``jnp.round`` does, so the packed values are bit-identical.

The shade table is the G-buffer's table when the kernels track no
attributes (``inkernel_attrs=False``): one f32[Tpad, 24] row per sorted
triangle slot, read with ONE row gather per pixel keyed by the kernel's
sorted hit index:

    [0:9]   v0, e1, e2
    [9:15]  oct(n0), oct(n1), oct(n2), unpacked pairs
    [15]    packed 8-bit rgb albedo
    [16]    the original triangle id as int32 BITS (not a value: ids at
            and above 2^23 read as denormals or NaNs as floats), so the
            column is only ever concatenated, gathered and viewed, through
            int32 views, never computed on
    [17:23] uv0, uv1, uv2 (zeros untextured)
    [23]    texture layer (-1 untextured)

The original-order table (``make_shade_table_orig``) holds lanes 0-15 of
the same layout per triangle of the mesh, keyed by the original id, with
no id lane and no texture lanes: f32[T, 16].
"""

from __future__ import annotations

import torch

from ..bvh.lbvh import LBVH
from ..camera import _cross, normalize
from ..types import Mesh

ATTR_STRIDE = 16


def _sign1(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, -1.0)


def oct_encode(n: torch.Tensor) -> torch.Tensor:
    """Unit vectors [..., 3] -> octahedral [..., 2] in [-1, 1]."""
    a = n.abs()
    s = a[..., 0:1] + a[..., 1:2] + a[..., 2:3]
    p = n[..., :2] / torch.clamp(s, min=1e-20)
    x, y = p[..., 0], p[..., 1]
    wrap_x = (1.0 - y.abs()) * _sign1(x)
    wrap_y = (1.0 - x.abs()) * _sign1(y)
    neg = n[..., 2] < 0
    return torch.stack([torch.where(neg, wrap_x, x),
                        torch.where(neg, wrap_y, y)], dim=-1)


def oct_decode(e: torch.Tensor) -> torch.Tensor:
    """Octahedral [..., 2] -> unit vectors [..., 3]."""
    x, y = e[..., 0], e[..., 1]
    z = 1.0 - x.abs() - y.abs()
    neg = z < 0
    xf = torch.where(neg, (1.0 - y.abs()) * _sign1(x), x)
    yf = torch.where(neg, (1.0 - x.abs()) * _sign1(y), y)
    return normalize(torch.stack([xf, yf, z], dim=-1))


def pack_rgb(albedo: torch.Tensor) -> torch.Tensor:
    """[..., 3] in [0,1] -> one float holding three exact 8-bit channels."""
    q = torch.clamp(torch.round(albedo * 255.0), 0, 255)
    return q[..., 0] * 65536.0 + q[..., 1] * 256.0 + q[..., 2]


def unpack_rgb(f: torch.Tensor) -> torch.Tensor:
    r = torch.floor(f / 65536.0)
    g = torch.floor((f - r * 65536.0) / 256.0)
    b = f - r * 65536.0 - g * 256.0
    return torch.stack([r, g, b], dim=-1) / 255.0


def pack_oct12(e: torch.Tensor) -> torch.Tensor:
    """Octahedral pair [..., 2] in [-1, 1] -> ONE exact-integer float:
    12-bit fixed point per component (q0*4096 + q1 < 2^24)."""
    q = torch.clamp(torch.round((e + 1.0) * (0.5 * 4095.0)), 0, 4095)
    return q[..., 0] * 4096.0 + q[..., 1]


def unpack_oct12(p: torch.Tensor) -> torch.Tensor:
    """pack_oct12 inverse -> [..., 2] in [-1, 1] (12-bit quantized)."""
    hi = torch.floor(p * (1.0 / 4096.0))
    lo = p - hi * 4096.0
    return torch.stack([hi, lo], dim=-1) * (2.0 / 4095.0) - 1.0


def _pack_attr_rows(rows16: torch.Tensor, num_leaves: int, k: int):
    """[Tpad, 16] per-triangle attribute rows -> the (at0, at1) pair."""
    per_leaf = rows16.reshape(num_leaves, k * ATTR_STRIDE)
    lo = per_leaf[:, :min(k, 8) * ATTR_STRIDE]
    at0 = torch.nn.functional.pad(lo, (0, 128 - lo.shape[1]))
    if k > 8:
        hi = per_leaf[:, 8 * ATTR_STRIDE:]
        at1 = torch.nn.functional.pad(hi, (0, 128 - hi.shape[1]))
    else:
        at1 = torch.zeros((1, 128), dtype=torch.float32, device=rows16.device)
    return at0.contiguous(), at1.contiguous()


def _uv_columns(m: Mesh, tri: torch.Tensor):
    """(uv0 f32[n, 2], d1 = uv1 - uv0, d2 = uv2 - uv0) of the triangles
    ``tri`` (their vertex ids) of a textured mesh ``m`` on the device."""
    uv0 = m.uv[tri[:, 0]]
    return uv0, m.uv[tri[:, 1]] - uv0, m.uv[tri[:, 2]] - uv0


def make_leaf_attr_rows(bvh: LBVH, mesh: Mesh):
    """Leaf-major shading attributes (at0, at1) f32[num_blocks, 128] on the
    accel's device (mesh fields as numpy arrays or tensors). A textured
    mesh fills lanes 4-10 (layer, uv0, d1, d2); an untextured one holds
    layer -1 and zero uv there."""
    k = bvh.leaf_size
    if k > 14:
        raise ValueError("attr rows support leaf_size <= 14 (14*16 lanes)")
    dev = bvh.tri_id.device
    m = mesh.on(dev)
    tri_id = bvh.tri_id.long()
    tri = m.indices.long()[tri_id]                           # [Tpad, 3]
    n0 = pack_oct12(oct_encode(m.normals[tri[:, 0]]))[:, None]
    n1 = pack_oct12(oct_encode(m.normals[tri[:, 1]]))[:, None]
    n2 = pack_oct12(oct_encode(m.normals[tri[:, 2]]))[:, None]
    alb = pack_rgb(m.albedo[tri_id])[:, None]
    n = tri.shape[0]
    if mesh.textured:
        uv = torch.cat(_uv_columns(m, tri), dim=1)
        layer = m.tri_tex[tri_id].to(torch.float32)[:, None]
    else:
        uv = torch.zeros((n, 6), dtype=torch.float32, device=dev)
        layer = torch.full((n, 1), -1.0, dtype=torch.float32, device=dev)
    tid = bvh.tri_id.to(torch.float32)[:, None]   # exact for < 2^24 tris
    pad = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    rows16 = torch.cat([n0, n1, n2, alb, layer, uv, tid, pad], dim=1)
    return _pack_attr_rows(rows16, bvh.num_blocks, k)


def make_leaf_attr_rows_t(bvh: LBVH, mesh: Mesh):
    """The transposed leaf attribute rows (at0_t, at1_t) of the w8t
    attribute walk (``tpurt``'s ``make_leaf_attr_rows_t``), on the accel's
    device, in ``WideBVHT.tris_t``'s layout (``transpose_leaf_rows``), so
    a triangle's attributes lie at its geometry's address. at0_t's nine
    fields: the packed oct normals n0, n1, n2, the packed albedo, the
    original triangle id (an exact float), the layer, uv0.u, uv0.v, 0.
    at1_t, for a textured mesh: d1.u, d1.v, d2.u, d2.v (d1 = uv1 - uv0,
    d2 = uv2 - uv0), then zeros; otherwise a f32[1, 8, 128] dummy, and
    at0_t holds layer -1 and zero uv0."""
    from ..bvh.wide import transpose_leaf_rows
    k = bvh.leaf_size
    dev = bvh.tri_id.device
    m = mesh.on(dev)
    tri_id = bvh.tri_id.long()
    tri = m.indices.long()[tri_id]                           # [Tpad, 3]
    n = tri.shape[0]
    cols = [pack_oct12(oct_encode(m.normals[tri[:, c]])) for c in range(3)]
    cols += [pack_rgb(m.albedo[tri_id]), bvh.tri_id.to(torch.float32)]
    z = torch.zeros((n,), dtype=torch.float32, device=dev)
    if not mesh.textured:
        lay = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
        rows_a = torch.stack(cols + [lay, z, z, z], dim=1)
        return (transpose_leaf_rows(rows_a, k),
                torch.zeros((1, 8, 128), dtype=torch.float32, device=dev))
    uv0, d1, d2 = _uv_columns(m, tri)
    rows_a = torch.stack(cols + [m.tri_tex[tri_id].to(torch.float32),
                                 uv0[:, 0], uv0[:, 1], z], dim=1)
    rows_b = torch.stack([d1[:, 0], d1[:, 1], d2[:, 0], d2[:, 1], z, z, z,
                          z, z], dim=1)
    return transpose_leaf_rows(rows_a, k), transpose_leaf_rows(rows_b, k)


def attr_payload_columns(mesh: Mesh, device):
    """Per-triangle ORIGINAL-order attribute columns (f32[T] each) that
    ride the rebuild's Morton sort as payload (``build_lbvh``
    ``extra_payload``): the packed oct normals of the three corners and
    the packed albedo, then for a textured mesh the layer, uv0, d1 and d2
    (seven more columns)."""
    m = mesh.on(device)
    tri = m.indices.long()
    cols = (pack_oct12(oct_encode(m.normals[tri[:, 0]])),
            pack_oct12(oct_encode(m.normals[tri[:, 1]])),
            pack_oct12(oct_encode(m.normals[tri[:, 2]])),
            pack_rgb(m.albedo))
    if mesh.textured:
        uv0, d1, d2 = _uv_columns(m, tri)
        cols += (m.tri_tex.to(torch.float32), uv0[:, 0], uv0[:, 1],
                 d1[:, 0], d1[:, 1], d2[:, 0], d2[:, 1])
    return cols


def leaf_attr_rows_from_sorted(cols, tri_id: torch.Tensor, num_blocks: int,
                               k: int, textured: bool = False):
    """(at0, at1) from the SORTED payload columns (``attr_payload_columns``
    order) and the sorted original ids: the rebuild's twin of
    ``make_leaf_attr_rows``, with the same output. ``textured``: the
    columns carry the layer and uv lanes."""
    n = tri_id.shape[0]
    z = torch.zeros((n,), dtype=torch.float32, device=tri_id.device)
    if textured:
        lay, u0u, u0v, d1u, d1v, d2u, d2v = cols[4:11]
    else:
        lay = torch.full((n,), -1.0, dtype=torch.float32,
                         device=tri_id.device)
        u0u = u0v = d1u = d1v = d2u = d2v = z
    rows16 = torch.stack([cols[0], cols[1], cols[2], cols[3], lay,
                          u0u, u0v, d1u, d1v, d2u, d2v,
                          tri_id.to(torch.float32), z, z, z, z],
                         dim=1)                              # [Tpad, 16]
    return _pack_attr_rows(rows16, num_blocks, k)


def smooth_normals_device(vertices: torch.Tensor,
                          indices: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals on the vertices' device: the face
    normals scatter-added into their three corners, then normalised (the
    animated path's per-frame normals). On the CPU the adds run in index
    order, as XLA's scatter does; on the card they are atomic, so the
    normals' last bits can differ from run to run."""
    tri = indices.long()
    i0, i1, i2 = tri[:, 0], tri[:, 1], tri[:, 2]
    fn = torch.linalg.cross(vertices[i1] - vertices[i0],
                            vertices[i2] - vertices[i0])
    n = torch.zeros_like(vertices)
    for i in (i0, i1, i2):
        n.index_add_(0, i, fn)
    return normalize(n)


SHADE_TABLE_WIDTH = 24
TID_LANE = 16


def make_shade_table(bvh: LBVH, mesh: Mesh) -> torch.Tensor:
    """f32[Tpad, 24] shading rows in the accel's sorted triangle order, on
    the accel's device (``tpurt``'s ``make_shade_table``); a textured
    mesh fills lanes 17-23 (uv0, uv1, uv2, layer). Every padded slot (SBVH
    duplicates, the leaves' and the Morton build's repeat padding) holds
    a real triangle's id, so the mesh gathers stay in range. No host sync:
    the rebuild makes it every frame."""
    dev = bvh.tri_id.device
    m = mesh.on(dev)
    tri_id = bvh.tri_id.long()
    tri = m.indices.long()[tri_id]                           # [Tpad, 3]
    n = tri.shape[0]
    geometry = torch.cat(
        [bvh.tri_v0, bvh.tri_e1, bvh.tri_e2,
         oct_encode(m.normals[tri[:, 0]]), oct_encode(m.normals[tri[:, 1]]),
         oct_encode(m.normals[tri[:, 2]]),
         pack_rgb(m.albedo[tri_id])[:, None]], dim=1)       # [Tpad, 16]
    if mesh.textured:
        tail = torch.cat([m.uv[tri[:, 0]], m.uv[tri[:, 1]], m.uv[tri[:, 2]],
                          m.tri_tex[tri_id].to(torch.float32)[:, None]],
                         dim=1)
    else:
        tail = torch.cat([torch.zeros((n, 6), dtype=torch.float32,
                                      device=dev),
                          torch.full((n, 1), -1.0, dtype=torch.float32,
                                     device=dev)], dim=1)    # uv, layer
    # The id lane joins the float lanes as bits: an integer concatenation.
    return torch.cat([geometry.view(torch.int32),
                      bvh.tri_id.to(torch.int32)[:, None],
                      tail.view(torch.int32)], dim=1).view(torch.float32)


def make_shade_table_orig(mesh: Mesh) -> torch.Tensor:
    """f32[T, 16] shading rows in the mesh's own triangle order (no accel;
    ``mesh`` on the device): v0, e1, e2, the three oct normals and the
    packed albedo (``tpurt``'s ``make_shade_table_orig``). The deferred
    raster G-buffer keys it by the rasterizer's triangle id."""
    tri = mesh.indices.long()
    v0 = mesh.vertices[tri[:, 0]]
    v1 = mesh.vertices[tri[:, 1]]
    v2 = mesh.vertices[tri[:, 2]]
    return torch.cat([v0, v1 - v0, v2 - v0,
                      oct_encode(mesh.normals[tri[:, 0]]),
                      oct_encode(mesh.normals[tri[:, 1]]),
                      oct_encode(mesh.normals[tri[:, 2]]),
                      pack_rgb(mesh.albedo)[:, None]], dim=1)


def gather_table_rows(table: torch.Tensor, sidx: torch.Tensor
                      ) -> torch.Tensor:
    """One row per pixel: table[sidx] (misses read row 0) -> f32[..., 24],
    gathered through an int32 view so the id lane's bits are copied, not
    loaded as floats."""
    n = table.shape[0]
    idx = torch.clamp(sidx, 0, n - 1).long()
    return table.view(torch.int32)[idx].view(torch.float32)


def table_tri_id(rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Original triangle ids out of gathered rows (lane 16); -1 invalid."""
    tid = rows.view(torch.int32)[..., TID_LANE]
    return torch.where(valid, tid, -1)


def table_uv(rows: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Interpolated texture coordinates f32[..., 2] and the layer i32[...]
    out of gathered rows (lanes 17-23), at barycentrics (u, v)."""
    uv0 = rows[..., 17:19]
    uv1 = rows[..., 19:21]
    uv2 = rows[..., 21:23]
    uv = uv0 + u[..., None] * (uv1 - uv0) + v[..., None] * (uv2 - uv0)
    return uv, rows[..., 23].to(torch.int32)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def barycentrics_from_position(v0: torch.Tensor, e1: torch.Tensor,
                               e2: torch.Tensor, position: torch.Tensor):
    """(u, v) of ``position`` against triangle (v0, e1, e2), clipped to
    [0, 1]: the 2x2 normal-equations solve of p - v0 = u e1 + v e2 in the
    triangle's plane, without fused multiply-adds."""
    w = position - v0
    d11 = _dot3(e1, e1)
    d12 = _dot3(e1, e2)
    d22 = _dot3(e2, e2)
    dw1 = _dot3(w, e1)
    dw2 = _dot3(w, e2)
    det = torch.clamp(d11 * d22 - d12 * d12, min=1e-20)
    u = torch.clamp((d22 * dw1 - d12 * dw2) / det, 0.0, 1.0)
    v = torch.clamp((d11 * dw2 - d12 * dw1) / det, 0.0, 1.0)
    return u, v


def shade_from_table(rows: torch.Tensor, position: torch.Tensor,
                     valid: torch.Tensor):
    """Gathered table rows [..., 24] and hit positions -> {normal (smooth,
    interpolated at the position's barycentrics), gnormal, albedo, u, v},
    zero off the valid mask."""
    v0, e1, e2 = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
    u, v = barycentrics_from_position(v0, e1, e2, position)
    n0 = oct_decode(rows[..., 9:11])
    n1 = oct_decode(rows[..., 11:13])
    n2 = oct_decode(rows[..., 13:15])
    smooth = normalize(n0 + u[..., None] * (n1 - n0)
                       + v[..., None] * (n2 - n0))
    gnormal = normalize(_cross(e1, e2))
    albedo = unpack_rgb(rows[..., 15])
    zeros = torch.zeros_like(smooth)
    vmask = valid[..., None]
    return {
        "normal": torch.where(vmask, smooth, zeros),
        "gnormal": torch.where(vmask, gnormal, zeros),
        "albedo": torch.where(vmask, albedo, zeros),
        "u": u,
        "v": v,
    }


def shade_from_table_uv(rows: torch.Tensor, u: torch.Tensor,
                        v: torch.Tensor, valid: torch.Tensor):
    """``shade_from_table`` at known barycentrics (the rasterizer's
    perspective-correct u, v), from original-order rows [..., 16] ->
    {normal, gnormal, albedo}, zero off the valid mask."""
    n0 = oct_decode(rows[..., 9:11])
    n1 = oct_decode(rows[..., 11:13])
    n2 = oct_decode(rows[..., 13:15])
    smooth = normalize(n0 + u[..., None] * (n1 - n0)
                       + v[..., None] * (n2 - n0))
    gnormal = normalize(_cross(rows[..., 3:6], rows[..., 6:9]))
    albedo = unpack_rgb(rows[..., 15])
    zeros = torch.zeros_like(smooth)
    vmask = valid[..., None]
    return {
        "normal": torch.where(vmask, smooth, zeros),
        "gnormal": torch.where(vmask, gnormal, zeros),
        "albedo": torch.where(vmask, albedo, zeros),
    }
