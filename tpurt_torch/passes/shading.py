"""Leaf attribute rows and their encodings (counterpart of the
attribute-row part of ``tpurt/passes/shading.py``): built by a gather
keyed by the sorted original ids (``make_leaf_attr_rows``, once per
scene), or from columns that rode the rebuild's sort
(``attr_payload_columns`` -> ``leaf_attr_rows_from_sorted``), and the
animated mesh's vertex normals (``smooth_normals_device``).

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
"""

from __future__ import annotations

import torch

from ..bvh.lbvh import LBVH
from ..camera import normalize
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


def make_leaf_attr_rows(bvh: LBVH, mesh: Mesh):
    """Leaf-major shading attributes (at0, at1) f32[num_blocks, 128] on the
    accel's device, for an untextured mesh (fields as numpy arrays or
    tensors)."""
    k = bvh.leaf_size
    if k > 14:
        raise ValueError("attr rows support leaf_size <= 14 (14*16 lanes)")
    if mesh.textured:
        raise NotImplementedError("textured attribute rows are not ported")
    dev = bvh.tri_id.device
    m = mesh.on(dev)
    tri_id = bvh.tri_id.long()
    tri = m.indices.long()[tri_id]                           # [Tpad, 3]
    n0 = pack_oct12(oct_encode(m.normals[tri[:, 0]]))[:, None]
    n1 = pack_oct12(oct_encode(m.normals[tri[:, 1]]))[:, None]
    n2 = pack_oct12(oct_encode(m.normals[tri[:, 2]]))[:, None]
    alb = pack_rgb(m.albedo[tri_id])[:, None]
    n = tri.shape[0]
    uv = torch.zeros((n, 6), dtype=torch.float32, device=dev)
    layer = torch.full((n, 1), -1.0, dtype=torch.float32, device=dev)
    tid = bvh.tri_id.to(torch.float32)[:, None]   # exact for < 2^24 tris
    pad = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    rows16 = torch.cat([n0, n1, n2, alb, layer, uv, tid, pad], dim=1)
    return _pack_attr_rows(rows16, bvh.num_blocks, k)


def attr_payload_columns(mesh: Mesh, device):
    """Per-triangle ORIGINAL-order attribute columns (f32[T] each) that
    ride the rebuild's Morton sort as payload (``build_lbvh``
    ``extra_payload``): the packed oct normals of the three corners and
    the packed albedo. Untextured meshes only."""
    if mesh.textured:
        raise NotImplementedError("textured attribute rows are not ported")
    m = mesh.on(device)
    tri = m.indices.long()
    return (pack_oct12(oct_encode(m.normals[tri[:, 0]])),
            pack_oct12(oct_encode(m.normals[tri[:, 1]])),
            pack_oct12(oct_encode(m.normals[tri[:, 2]])),
            pack_rgb(m.albedo))


def leaf_attr_rows_from_sorted(cols, tri_id: torch.Tensor, num_blocks: int,
                               k: int):
    """(at0, at1) from the SORTED payload columns (``attr_payload_columns``
    order) and the sorted original ids: the rebuild's twin of
    ``make_leaf_attr_rows``, with the same output."""
    n = tri_id.shape[0]
    z = torch.zeros((n,), dtype=torch.float32, device=tri_id.device)
    lay = torch.full((n,), -1.0, dtype=torch.float32, device=tri_id.device)
    rows16 = torch.stack([cols[0], cols[1], cols[2], cols[3], lay,
                          z, z, z, z, z, z, tri_id.to(torch.float32),
                          z, z, z, z], dim=1)                 # [Tpad, 16]
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
