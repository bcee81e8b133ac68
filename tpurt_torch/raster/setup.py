"""Rasterizer front end: vertex transform, triangle setup, tile binning
(counterpart of ``tpurt/raster/setup.py``: its v1 (triangle, tile) pairs,
``bin_triangles``, and its v2 "full" and v3 "z16" row formats,
``bin_rows``).

The reference program rasterizes its G-buffer and ray-traces only the
shadows. ``tpurt`` rasterizes in 2D-homogeneous clip coordinates
(Olano-Greer): the three edge values at a pixel are the perspective-correct
barycentric weights, and triangles that cross the eye plane need no
clipping pass. This module makes the rasterizer's input on the device:

- a 32-float record per triangle (edges, 1/det, id, vertex normals,
  geometric normal, albedo, tile rect), four to a 128-float table row;
  or, for the deferred G-buffer (``fmt="z16"``), a 16-float z-only record
  (edges, 1/det, id, tile rect), eight to a row;
- (table row, 32x32 tile) pairs, expanded under a static capacity,
  stably sorted by tile, and the rows gathered into that order, so each
  tile's work is one contiguous run of rows;
- a "big list" of the eye-plane crossers, which every tile streams.

Every step is tensor code with static shapes and no host sync; the
per-pixel z-fight is the kernel's (``kernels/raster.py``). The sorts are
stable, as ``jnp.argsort``: the order of a tile's records decides ties of
the z-fight, where the first record keeps the pixel. The float constants
are computed on the host and rounded once to float32, as JAX's weakly
typed Python scalars are. The ``tile_rows`` band of the sharded raster is
not ported.

The v1 binner (``bin_triangles``, the input of ``rasterize_tiles``) emits
one (triangle, tile) pair per tile a triangle's screen rect spans, with
16-float records over uncentred pixel coordinates, and sends triangles
that span more than ``BIG_SPAN`` tiles or cross the eye plane to a big
list that every tile tests.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..camera import _cross, as_f32, camera_basis
from ..types import Camera, Mesh

TILE = 32           # pixels per tile side
W_EPS = 1e-6        # clip-w threshold for "crosses the eye plane"
REC = 16            # floats per v1 record (bin_triangles)
RECS_PER_ROW = 8    # v1 records per 128-float row
BIG_SPAN = 64       # tiles; v1 triangles spanning more go to the big list
REC32 = 32          # floats per record
RECS32_PER_ROW = 4  # records per 128-float row
REC16 = 16          # floats per z-only record (fmt="z16")
RECS16_PER_ROW = 8
_FAR_TILE = 10 ** 6  # row-rect fill of a row without a live member


class RasterRows(NamedTuple):
    """Kernel-ready binning (static shapes, tensors on one device).

    pair_rows  : f32[CAP, 128] 4-record (z16: 8-record) rows in sorted
                 (tile-major) order
    row_starts : i32[ntiles] first pair row of each tile
    row_counts : i32[ntiles] pair rows per tile
    big_rows   : f32[BIGCAP/4 (z16: /8), 128] big-list rows (streamed by
                 every tile)
    big_nrows  : i32[] valid big rows
    overflow   : bool[] pair or big capacity exceeded
    pairs      : i64[] (row, tile) pairs the binning made, those past the
                 capacity included (None where the rows came from
                 elsewhere)
    """

    pair_rows: torch.Tensor
    row_starts: torch.Tensor
    row_counts: torch.Tensor
    big_rows: torch.Tensor
    big_nrows: torch.Tensor
    overflow: torch.Tensor
    pairs: Optional[torch.Tensor] = None


class RasterBins(NamedTuple):
    """The v1 binning (``bin_triangles``; static shapes, tensors on one
    device).

    pair_rows  : f32[CAP/8, 128] 16-float records in sorted pair order
    starts     : i32[ntiles] first pair (record) index of each tile
    counts     : i32[ntiles] pairs per tile
    big_rows   : f32[BIGCAP/8, 128] big-list records
    big_count  : i32[] valid big records
    overflow   : bool[] pair or big capacity exceeded
    """

    pair_rows: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    big_rows: torch.Tensor
    big_count: torch.Tensor
    overflow: torch.Tensor


def _f32(x) -> float:
    """A Python float holding the float32 rounding of ``x``."""
    return float(np.float32(x))


def pixel_constants(width: int, height: int):
    """(0.5 * width, 1 / width, 0.5 * height, 1 / height) as float32
    values: the centred, unit-scaled pixel coordinates the records' edges
    are built over, sx = (x - 0.5 * width) * (1 / width), and the
    rasterizer evaluates them at."""
    return tuple(_f32(x) for x in (0.5 * width, 1.0 / width, 0.5 * height,
                                   1.0 / height))


def _projection(cam: Camera, width: int, height: int):
    """Host float32 constants of ``clip_transform``: (x scale, x offset,
    y scale, y offset), each rounded as JAX rounds them."""
    half = np.float32(float(cam.fov_y)) * np.float32(0.5)
    thy = np.float32(np.tan(np.float64(half)))
    thx = thy * np.float32(width / height)
    return (np.float32(width) / (np.float32(2.0) * thx),
            _f32((width - 1) / 2.0),
            -(np.float32(height) / (np.float32(2.0) * thy)),
            _f32((height - 1) / 2.0))


CLIP_WORDS = 13     # clip_constants: the camera basis (9), _projection (4)


def clip_constants(cam: Camera, width: int, height: int) -> np.ndarray:
    """``clip_transform``'s constants f32[13], computed on the host: the
    camera basis right(3), up(3), forward(3) (``camera_basis`` on the
    CPU) and ``_projection``'s (x scale, x offset, y scale, y offset). A
    frame's block of constants holds them (``frame_block.py``)."""
    basis = torch.cat(camera_basis(cam, "cpu")).numpy()
    return np.concatenate([basis, np.float32(_projection(cam, width,
                                                         height))])


def clip_transform(cam: Camera, width: int, height: int,
                   vertices: torch.Tensor,
                   contract: bool = False) -> torch.Tensor:
    """World vertices f32[V, 3] -> 2DH clip coords (x, y, w): (x/w, y/w)
    are screen coordinates in pixels with integers at pixel centres (the
    grid ``camera.generate_rays`` shoots through), w the camera-space depth
    along the forward axis. The constants (``clip_constants``) and the
    camera position enter as scalars: a block camera's views of them
    (``frame_block.BlockCamera.clip``, so a CUDA graph of the binning reads
    each frame's camera), else Python floats computed on the host; either
    way no copy to the device and no host sync, and the same float32
    products. ``contract`` rounds each dot product as XLA's CPU compiler
    contracts it, fma(q2, b2, fma(q1, b1, q0 b0)) (the v1 binner's
    pixel-scale records, ROADMAP decision 24), from host floats."""
    k = None if contract else getattr(cam, "clip", None)
    if k is None:
        k = clip_constants(cam, width, height).tolist()
        pos = as_f32(cam.position, "cpu").tolist()
    else:
        pos = cam.position
    right, up, forward = k[0:3], k[3:6], k[6:9]
    sx, ox, sy, oy = k[9:13]
    q = [vertices[:, i] - pos[i] for i in range(3)]

    def dot(b):
        if contract:
            from ..kernels.build import fma32
            acc = q[0] * b[0]
            for i in (1, 2):
                acc = fma32(q[i], torch.full_like(acc, b[i]), acc)
            return acc
        return q[0] * b[0] + q[1] * b[1] + q[2] * b[2]
    z = dot(forward)
    cx = sx * dot(right) + ox * z
    cy = sy * dot(up) + oy * z
    return torch.stack([cx, cy, z], dim=-1)


def _edges_centered(clip: torch.Tensor, tri: torch.Tensor, width: int,
                    height: int):
    """2DH edge vectors over centred, unit-scaled screen coordinates (the
    d-ratios that give coverage, u, v and 1/w are invariant to this affine
    rescale, and pixel-scale coordinates cancel catastrophically in the
    cross products), ``pixel_constants``. Returns (e0, e1, e2, dinv)."""
    half_w, inv_w, half_h, inv_h = pixel_constants(width, height)
    w = clip[:, 2]
    cs = torch.stack([(clip[:, 0] - half_w * w) * inv_w,
                      (clip[:, 1] - half_h * w) * inv_h, w], dim=-1)
    tl = tri.long()
    c0, c1, c2 = cs[tl[:, 0]], cs[tl[:, 1]], cs[tl[:, 2]]
    e0 = _cross(c1, c2)
    e1 = _cross(c2, c0)
    e2 = _cross(c0, c1)
    p = e0 * c0
    d = p[:, 0] + p[:, 1] + p[:, 2]
    dinv = torch.where(d.abs() > 1e-30, 1.0 / d, 0.0)
    return e0, e1, e2, dinv


def _setup_records32(clip: torch.Tensor, mesh: Mesh, width: int,
                     height: int, tri_ids: torch.Tensor, rect
                     ) -> torch.Tensor:
    """Self-shading setup record f32[T, 32]:

    [0:9]   E0, E1, E2 (2DH edge vectors; d_i(p) = E_i . (sx, sy, 1))
    [9]     Dinv (1/w(p) = (d0 + d1 + d2) * Dinv)
    [10]    tri_id (-1 = dead slot)
    [11]    pad
    [12:21] n0, n1, n2 (vertex normals)
    [21:24] geometric normal
    [24:27] albedo
    [27:31] tile rect x0, y0, x1, y1 (the big list's per-tile cull)
    [31]    pad
    """
    tri = mesh.indices.long()
    e0, e1, e2, dinv = _edges_centered(clip, tri, width, height)
    v = mesh.vertices
    v0w = v[tri[:, 0]]
    gn = _cross(v[tri[:, 1]] - v0w, v[tri[:, 2]] - v0w)
    g2 = gn * gn
    gn = gn / torch.clamp(torch.sqrt(g2[:, 0:1] + g2[:, 1:2] + g2[:, 2:3]),
                          min=1e-20)
    n = mesh.normals
    zero = torch.zeros_like(dinv)[:, None]
    return torch.cat([
        e0, e1, e2, dinv[:, None], tri_ids.to(torch.float32)[:, None], zero,
        n[tri[:, 0]], n[tri[:, 1]], n[tri[:, 2]], gn, mesh.albedo,
        *(r.to(torch.float32)[:, None] for r in rect), zero], dim=1)


def _setup_records16(clip: torch.Tensor, mesh: Mesh, width: int,
                     height: int, tri_ids: torch.Tensor, rect
                     ) -> torch.Tensor:
    """Z-only setup record f32[T, 16] of the deferred G-buffer, whose
    shading comes from one shade-table row per pixel afterwards:

    [0:9]   E0, E1, E2
    [9]     Dinv
    [10]    tri_id (-1 = dead slot)
    [11]    pad
    [12:16] tile rect x0, y0, x1, y1
    """
    e0, e1, e2, dinv = _edges_centered(clip, mesh.indices.long(), width,
                                       height)
    zero = torch.zeros_like(dinv)[:, None]
    return torch.cat([
        e0, e1, e2, dinv[:, None], tri_ids.to(torch.float32)[:, None], zero,
        *(r.to(torch.float32)[:, None] for r in rect)], dim=1)


def _pack_rows32(rec: torch.Tensor) -> torch.Tensor:
    """f32[N, 32] -> f32[ceil(N/4), 128] (f32[N, 16] -> f32[ceil(N/8),
    128]); padding slots are dead (lane 10 = -1)."""
    n, w = rec.shape
    rpr = 128 // w
    npad = -(-n // rpr) * rpr
    if npad != n:
        pad = torch.zeros((npad - n, w), dtype=rec.dtype, device=rec.device)
        pad[:, 10].fill_(-1.0)
        rec = torch.cat([rec, pad])
    return rec.reshape(npad // rpr, 128)


def _row_reduce(a: torch.Tensor, small: torch.Tensor, fill: int,
                op, rpr: int) -> torch.Tensor:
    """Per table row of ``rpr`` triangles: op over its live (small)
    members, ``fill`` where it has none."""
    n = a.shape[0]
    npad = -(-n // rpr) * rpr
    aa = torch.full((npad,), fill, dtype=a.dtype, device=a.device)
    aa[:n] = torch.where(small, a, fill)
    return op(aa.reshape(-1, rpr), dim=1).values


def _compact(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """The first ``size`` indices where ``mask`` holds, in order, then
    ``fill`` (``jnp.nonzero(size=, fill_value=)``) without a host sync:
    a running count gives each index its slot, and a scatter places it;
    indices past ``size`` land in one extra slot that is dropped."""
    dev = mask.device
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=dev)
    out.scatter_(0, slot, torch.arange(mask.shape[0], device=dev))
    return out[:size]


def bin_rows(cam: Camera, mesh: Mesh, width: int, height: int,
             cap_pairs: int, cap_big: int = 2048,
             fmt: str = "full") -> RasterRows:
    """(table row, tile) pairs, tile-sorted, rows gathered whole.

    ``mesh`` holds tensors on the device the binning runs on
    (``Mesh.on``). cap_pairs: static pair capacity (``default_cap_rows``);
    pairs past it are dropped and ``overflow`` is set, as it is when more
    than ``cap_big`` triangles cross the eye plane. ``fmt``: "full", the
    32-float records of ``rasterize_rows``, or "z16", the 16-float z-only
    records of ``rasterize_rows16`` (eight to a row, so rows and pairs
    are about half as many)."""
    setup_fn = {"full": _setup_records32, "z16": _setup_records16}[fmt]
    rec_w = {"full": REC32, "z16": REC16}[fmt]
    rpr = 128 // rec_w
    dev = mesh.vertices.device
    i32, i64 = torch.int32, torch.int64
    wt = -(-width // TILE)
    ht = -(-height // TILE)
    ntiles = wt * ht
    tri = mesh.indices.long()
    t_count = tri.shape[0]
    clip = clip_transform(cam, width, height, mesh.vertices)

    # Per-triangle screen rects (valid only when every w > eps; otherwise
    # the projected rect is unbounded and the triangle is a crosser).
    c = clip[tri]                                      # [T, 3, 3]
    w_ok = torch.all(c[:, :, 2] > W_EPS, dim=1)
    sxy = c[:, :, 0:2] / torch.clamp(c[:, :, 2:3], min=W_EPS)
    mn = sxy.amin(dim=1) - 0.5
    mx = sxy.amax(dim=1) + 0.5

    def tile_of(x, n):
        return torch.clamp(torch.floor(x / TILE), 0, n - 1).to(i64)
    tx0, ty0 = tile_of(mn[:, 0], wt), tile_of(mn[:, 1], ht)
    tx1, ty1 = tile_of(mx[:, 0], wt), tile_of(mx[:, 1], ht)
    onscreen = (mx[:, 0] >= 0) & (mx[:, 1] >= 0) & \
        (mn[:, 0] <= width - 1) & (mn[:, 1] <= height - 1)
    ids = torch.arange(t_count, device=dev)
    rec = setup_fn(clip, mesh, width, height, ids, (
        torch.where(w_ok, tx0, 0), torch.where(w_ok, ty0, 0),
        torch.where(w_ok, tx1, wt - 1), torch.where(w_ok, ty1, ht - 1)))
    degenerate = rec[:, 9].abs() == 0.0
    all_behind = torch.all(c[:, :, 2] < W_EPS, dim=1)
    # Only eye-plane crossers go to the big list; huge but well-projected
    # triangles bin normally (their spans are bounded by the grid).
    small = w_ok & onscreen & ~degenerate
    big = ~w_ok & ~degenerate & ~all_behind

    # Dead slots in the table: offscreen, degenerate and big triangles
    # must not rasterize from the pair path.
    rec[:, 10] = torch.where(small, rec[:, 10], -1.0)
    table = _pack_rows32(rec)                          # [nrows, 128]
    nrows = table.shape[0]

    # Per-row tile rects: the union over live members.
    rx0 = _row_reduce(tx0, small, _FAR_TILE, torch.min, rpr)
    ry0 = _row_reduce(ty0, small, _FAR_TILE, torch.min, rpr)
    rx1 = _row_reduce(tx1, small, -1, torch.max, rpr)
    ry1 = _row_reduce(ty1, small, -1, torch.max, rpr)
    live = rx1 >= rx0
    span_x = torch.where(live, rx1 - rx0 + 1, 0)
    counts = span_x * torch.where(live, ry1 - ry0 + 1, 0)

    # Pair expansion without a search: each live row's id goes to its
    # segment's first pair (scatter-max; the extra last slot takes what
    # falls past the capacity), and a running max carries it over the
    # segment (zero-count rows never scatter).
    starts = torch.cumsum(counts, 0) - counts
    total = starts[-1] + counts[-1]
    p = torch.arange(cap_pairs, device=dev)
    seg = torch.full((cap_pairs + 1,), -1, dtype=i64, device=dev)
    seg.scatter_reduce_(0, torch.where((counts > 0) & (starts < cap_pairs),
                                       starts, cap_pairs),
                        torch.arange(nrows, device=dev), "amax")
    pair_row = torch.clamp(torch.cummax(seg[:cap_pairs], 0).values,
                           0, nrows - 1)
    k = p - starts[pair_row]
    alive = (p < total) & (k >= 0) & (k < counts[pair_row])
    sx = torch.clamp(span_x[pair_row], min=1)
    tx = rx0[pair_row] + k % sx
    ty = ry0[pair_row] + k // sx
    tile_id = torch.where(alive, ty * wt + tx, ntiles)

    tile_sorted, order = torch.sort(tile_id, stable=True)
    pair_rows = table[pair_row[order]]                 # [cap, 128]
    tile_range = torch.arange(ntiles, device=dev)
    t_starts = torch.searchsorted(tile_sorted, tile_range, side="left")
    t_ends = torch.searchsorted(tile_sorted, tile_range, side="right")

    # Big list: whole rows again, dead slots killed.
    big_rec = rec.clone()
    big_rec[:, 10] = torch.where(big, ids.to(torch.float32), -1.0)
    dead = torch.zeros((1, rec_w), dtype=torch.float32, device=dev)
    dead[:, 10].fill_(-1.0)
    big_all = torch.cat([big_rec, dead])
    big_rows = _pack_rows32(big_all[_compact(big, cap_big, t_count)])
    n_big = big.to(i64).sum()

    overflow = (total > cap_pairs) | (n_big > cap_big)
    big_nrows = torch.div(torch.clamp(n_big, max=cap_big) + rpr - 1, rpr,
                          rounding_mode="floor")
    return RasterRows(pair_rows=pair_rows, row_starts=t_starts.to(i32),
                      row_counts=(t_ends - t_starts).to(i32),
                      big_rows=big_rows, big_nrows=big_nrows.to(i32),
                      overflow=overflow, pairs=total)


def _setup_records(clip: torch.Tensor, tri: torch.Tensor,
                   tri_ids: torch.Tensor) -> torch.Tensor:
    """v1 setup record f32[T, 16]: [E0(3), E1(3), E2(3), Dinv, tri_id,
    0...], the edges cross products of the clip-space (x, y, w) corners
    (d_i(p) = E_i . (sx, sy, 1) over pixel coordinates), Dinv = 1/det(c0,
    c1, c2) (0 where |det| <= 1e-30), so 1/w(p) = (d0 + d1 + d2) Dinv.

    Over pixel-scale coordinates the cross products cancel, so each
    component is rounded as XLA's CPU compiler contracts ``jnp.cross``:
    fma(a_i, b_j, -(a_j b_i)) (ROADMAP decision 24); the determinant is
    summed without FMA, as there."""
    from ..kernels.build import fma32
    tl = tri.long()
    c0, c1, c2 = clip[tl[:, 0]], clip[tl[:, 1]], clip[tl[:, 2]]

    def cross(a, b):
        return torch.stack([fma32(a[:, i], b[:, j], -(a[:, j] * b[:, i]))
                            for i, j in ((1, 2), (2, 0), (0, 1))], dim=1)
    e0 = cross(c1, c2)
    e1 = cross(c2, c0)
    e2 = cross(c0, c1)
    p = e0 * c0
    d = p[:, 0] + p[:, 1] + p[:, 2]
    dinv = torch.where(d.abs() > 1e-30, 1.0 / d, 0.0)
    zero = torch.zeros((tri.shape[0], 5), dtype=torch.float32,
                       device=clip.device)
    return torch.cat([e0, e1, e2, dinv[:, None],
                      tri_ids.to(torch.float32)[:, None], zero], dim=1)


def _pack_rows(rec: torch.Tensor) -> torch.Tensor:
    """f32[N, 16] -> f32[ceil(N/8), 128] (8 records a row, zero-padded as
    ``tpurt`` pads)."""
    n = rec.shape[0]
    npad = -(-n // RECS_PER_ROW) * RECS_PER_ROW
    if npad != n:
        rec = torch.cat([rec, rec.new_zeros((npad - n, REC))])
    return rec.reshape(npad // RECS_PER_ROW, 128)


def bin_triangles(cam: Camera, mesh: Mesh, width: int, height: int,
                  cap_pairs: int, cap_big: int = 4096) -> RasterBins:
    """Bin every triangle into 32x32-pixel tiles (``tpurt``'s v1
    ``bin_triangles``; static shapes, no host sync). ``mesh`` holds
    tensors on the device the binning runs on. A triangle whose every
    corner lies in front of the eye (w > W_EPS), on screen, spanning at
    most ``BIG_SPAN`` tiles and not degenerate makes one pair per tile of
    its rect; one that crosses the eye plane or spans more goes to the big
    list (not when degenerate or wholly behind). Pairs past ``cap_pairs``
    are dropped and set ``overflow``, as more than ``cap_big`` big
    triangles do. The pairs are sorted by tile with a stable sort, so a
    tile's records keep triangle order; dead big slots carry id -1."""
    dev = mesh.vertices.device
    i32, i64 = torch.int32, torch.int64
    wt = -(-width // TILE)
    ht = -(-height // TILE)
    ntiles = wt * ht
    tri = mesh.indices.long()
    t_count = tri.shape[0]
    clip = clip_transform(cam, width, height, mesh.vertices, contract=True)
    ids = torch.arange(t_count, device=dev)
    rec = _setup_records(clip, tri, ids)

    # Screen rect per triangle (valid only when every w > eps).
    c = clip[tri]                                      # [T, 3, 3]
    w_ok = torch.all(c[:, :, 2] > W_EPS, dim=1)
    sxy = c[:, :, 0:2] / torch.clamp(c[:, :, 2:3], min=W_EPS)
    mn = sxy.amin(dim=1) - 0.5
    mx = sxy.amax(dim=1) + 0.5

    def tile_of(x, n):
        return torch.clamp(torch.floor(x / TILE), 0, n - 1).to(i64)
    tx0, ty0 = tile_of(mn[:, 0], wt), tile_of(mn[:, 1], ht)
    tx1, ty1 = tile_of(mx[:, 0], wt), tile_of(mx[:, 1], ht)
    onscreen = (mx[:, 0] >= 0) & (mx[:, 1] >= 0) & \
        (mn[:, 0] <= width - 1) & (mn[:, 1] <= height - 1)
    degenerate = rec[:, 9].abs() == 0.0
    all_behind = torch.all(c[:, :, 2] < W_EPS, dim=1)
    span_x = tx1 - tx0 + 1
    span = span_x * (ty1 - ty0 + 1)
    small = w_ok & onscreen & (span <= BIG_SPAN) & ~degenerate
    big = (~w_ok | (w_ok & onscreen & (span > BIG_SPAN))) & ~degenerate \
        & ~all_behind

    # Pair expansion under the static capacity: pair p belongs to the
    # triangle whose [start, start + count) holds it.
    counts = torch.where(small, span, 0)
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    total = ends[-1]
    p = torch.arange(cap_pairs, device=dev)
    pair_tri = torch.clamp(torch.searchsorted(ends, p, right=True), 0,
                           t_count - 1)
    k = p - starts[pair_tri]
    alive = (p < total) & (k >= 0) & (k < counts[pair_tri])
    sx = torch.clamp(span_x[pair_tri], min=1)
    tx = tx0[pair_tri] + k % sx
    ty = ty0[pair_tri] + torch.div(k, sx, rounding_mode="floor")
    tile_id = torch.where(alive, ty * wt + tx, ntiles)

    tile_sorted, order = torch.sort(tile_id, stable=True)
    pair_rows = _pack_rows(rec[pair_tri[order]])
    tile_range = torch.arange(ntiles, device=dev)
    t_starts = torch.searchsorted(tile_sorted, tile_range, side="left")
    t_ends = torch.searchsorted(tile_sorted, tile_range, side="right")

    # Big list: the first cap_big big triangles in order, dead slots -1.
    big_idx = _compact(big, cap_big, 0)
    n_big = big.to(i64).sum()
    big_rec = rec[big_idx]
    dead = torch.arange(cap_big, device=dev) >= n_big
    big_rec[:, 10] = torch.where(dead, -1.0, big_rec[:, 10])

    overflow = (total > cap_pairs) | (n_big > cap_big)
    return RasterBins(pair_rows=pair_rows, starts=t_starts.to(i32),
                      counts=(t_ends - t_starts).to(i32),
                      big_rows=_pack_rows(big_rec),
                      big_count=torch.clamp(n_big, max=cap_big).to(i32),
                      overflow=overflow)


def default_cap_pairs(num_tris: int) -> int:
    """Static (triangle, tile)-pair capacity of ``bin_triangles``: six
    tiles per triangle, bucketed to 2^16 pairs (``tpurt``'s formula)."""
    return max(1 << 17, -(-6 * num_tris // (1 << 16)) * (1 << 16))


def default_cap_rows(num_tris: int) -> int:
    """Static (row, tile)-pair capacity for ``bin_rows``: about 1.8 tiles
    per 4-triangle row, bucketed (``tpurt``'s formula). The Renderer grows
    it when a viewpoint overflows it."""
    rows = -(-num_tris // RECS32_PER_ROW)
    return max(1 << 15, -(-18 * rows // 10 // (1 << 14)) * (1 << 14))
