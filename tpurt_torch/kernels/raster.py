"""The tile rasterizers (counterparts of ``tpurt/kernels/raster.py``
``rasterize_rows`` -> ``_raster_kernel32``, ``rasterize_rows16`` ->
``_raster_kernel16``, the deferred G-buffer's z-only variant, and
``rasterize_tiles`` -> ``_raster_kernel``, the v1 rasterizer over
``bin_triangles``' (triangle, tile) pairs).

For each pixel of each 32x32 tile, stream the binned 32-float records
(``raster/setup.py``) in this order: the big list, each record culled by
its stored tile rect, then the tile's contiguous run of pair rows. A
covered record with a live id and 1/w > the best so far takes the pixel
(the first record wins a tie) and carries its d1, d2, d-sum, id,
d-weighted vertex normals, geometric normal and albedo. The epilogue
writes u, v = d/dsum, 1/w, the normalised normal with sign(dsum) folded
in, the geometric normal and the albedo; pixels without a hit get id -1
and zeros. The z-only variant reads 16-float records (``bin_rows(...,
fmt="z16")``: eight to a row, 11 lanes tested, the cull on lanes 12-15),
keeps (1/w, d1, d2, d-sum, id) and writes id, u, v and 1/w.

The v1 rasterizer reads ``bin_triangles``' 16-float records, eight to a
row, at the integer pixel coordinates ``tx*32 + x``, ``ty*32 + y``: the
big list's records [0, big_count) with no cull, then the tile's records
[start, start + count), a run that may start inside a row. It keeps and
writes what the z-only variant does. The record test it shares with the
other two also asks for a live id, which ``tpurt``'s v1 kernel does not;
every record in those two ranges has one, so the results are the same.

Three pieces each, as in ``kernels/traverse.py``:

- ``rasterize_rows_cuda``, ``rasterize_rows16_cuda``: the hand-written
  CUDA kernel (``csrc/raster.cu``, one template, an instantiation per
  record width). It takes CUDA tensors only and launches or raises;
  ``.launches`` counts its launches.
- ``rasterize_rows_reference``, ``rasterize_rows16_reference``: the same
  function in plain PyTorch, vectorised over tiles, in the kernel's order
  and arithmetic. The wrapper takes it only for CPU tensors.
- ``rasterize_rows``, ``rasterize_rows16``: the wrappers the G-buffers
  call; ``rasterize_tiles`` (with ``rasterize_tiles_cuda`` and
  ``rasterize_tiles_reference``), the v1 rasterizer's own entry point.

Outputs, ``tpurt``'s contract: tri_id i32[H, W] and attrs f32[12, H, W],
channels [u, v, 1/w, nx, ny, nz, gnx, gny, gnz, ar, ag, ab]; the z-only
variant's (tri_id i32[H, W], u, v, 1/w f32[H, W]). The TPU
kernel's padding of the row arrays with a chunk of dead rows only keeps
its fixed-size DMA in bounds; the CUDA kernel stages only rows inside a
run, so neither version copies the rows to pad them.
"""

from __future__ import annotations

import ctypes

import torch

from ..raster.setup import (REC, REC16, REC32, TILE, RasterBins,
                             RasterRows, pixel_constants)
from ._build import _check, _pick

N_ATTR = 12
N_ATTR16 = 3
PIXELS = TILE * TILE
# Per record width: the lane of the tile rect's x0 (the big list's cull).
_RECT_LANE = {REC32: 27, REC16: 12}


def _tiles(width: int, height: int):
    wt = -(-width // TILE)
    ht = -(-height // TILE)
    return wt, ht, wt * ht


def _check_bins(bins: RasterRows, width: int, height: int, device) -> None:
    _, _, ntiles = _tiles(width, height)
    cap = bins.pair_rows.shape[0]
    _check(bins.pair_rows, "pair_rows", torch.float32, (cap, 128), device)
    _check(bins.row_starts, "row_starts", torch.int32, (ntiles,), device)
    _check(bins.row_counts, "row_counts", torch.int32, (ntiles,), device)
    _check(bins.big_rows, "big_rows", torch.float32,
           (bins.big_rows.shape[0], 128), device)
    _check(bins.big_nrows, "big_nrows", torch.int32, (), device)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

class _State:
    """Per-pixel z-fight state of the tiles, [ntiles, 1024] each: best 1/w,
    d1, d2, d-sum, id and, for 32-float records (``full``), the d-weighted
    normal, the geometric normal, the albedo. ``stats`` (a dict, or None)
    counts the work the kernel's bound is computed from: "record_tests",
    the (record, pixel) pairs tested, and "takes", those where the record
    took the pixel."""

    def __init__(self, ntiles: int, device, stats=None, full: bool = True):
        self.stats = stats
        self.full = full

        def f(v):
            return torch.full((ntiles, PIXELS), v, dtype=torch.float32,
                              device=device)
        self.best, self.d1, self.d2, self.dsum = f(0.0), f(0.0), f(0.0), \
            f(1.0)
        self.tri = torch.full((ntiles, PIXELS), -1, dtype=torch.int32,
                              device=device)
        self.nw = [f(0.0) for _ in range(3)]
        self.gn = [f(0.0) for _ in range(3)]
        self.alb = [f(0.0) for _ in range(3)]

    def eval_record(self, n: int, rec, sx, sy, gate) -> None:
        """Test one record per tile (rec [n, 32], a lane per column) on
        the first n tiles; ``gate`` bool[n]: the record is live for the
        tile (the cull, or None)."""
        def lane(k):
            return rec[:, k:k + 1]
        sx, sy = sx[:n], sy[:n]
        d0 = lane(0) * sx + lane(1) * sy + lane(2)
        d1 = lane(3) * sx + lane(4) * sy + lane(5)
        d2 = lane(6) * sx + lane(7) * sy + lane(8)
        dsum = d0 + d1 + d2
        cov = ((d0 >= 0.0) & (d1 >= 0.0) & (d2 >= 0.0)) | \
            ((d0 <= 0.0) & (d1 <= 0.0) & (d2 <= 0.0))
        invw = dsum * lane(9)
        ok = cov & (invw > self.best[:n]) & (lane(10) >= 0.0)
        if gate is not None:
            ok = ok & gate[:, None]
        if self.stats is not None:
            tests = PIXELS * (n if gate is None else gate.sum())
            self.stats["record_tests"] = self.stats.get("record_tests",
                                                        0) + tests
            self.stats["takes"] = self.stats.get("takes", 0) + ok.sum()
        def take(dst, new):
            dst[:n] = torch.where(ok, new, dst[:n])
        take(self.best, invw)
        take(self.d1, d1)
        take(self.d2, d2)
        take(self.dsum, dsum)
        take(self.tri, lane(10).to(torch.int32))
        if not self.full:
            return
        nw = [d0 * lane(12 + c) + d1 * lane(15 + c) + d2 * lane(18 + c)
              for c in range(3)]
        for c in range(3):
            take(self.nw[c], nw[c])
            take(self.gn[c], lane(21 + c))
            take(self.alb[c], lane(24 + c))

    def epilogue(self) -> torch.Tensor:
        """-> f32[12 (z-only: 3), ntiles, 1024] channels (id apart)."""
        hit = self.tri >= 0
        safe = torch.where(self.dsum.abs() > 1e-30, self.dsum, 1.0)
        if not self.full:
            ch = [self.d1 / safe, self.d2 / safe, self.best]
            return torch.stack([torch.where(hit, c, 0.0) for c in ch])
        nx, ny, nz = self.nw
        rn = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                          min=1e-30))
        rn = rn * torch.where(self.dsum < 0.0, -1.0, 1.0)
        ch = [self.d1 / safe, self.d2 / safe, self.best,
              nx * rn, ny * rn, nz * rn, *self.gn, *self.alb]
        return torch.stack([torch.where(hit, c, 0.0) for c in ch])


def _to_image(x: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """[..., ntiles, 1024] tile-major pixels -> [..., H, W]."""
    wt, ht, _ = _tiles(width, height)
    lead = x.shape[:-2]
    t = x.reshape(*lead, ht, wt, TILE, TILE).transpose(-3, -2)
    return t.reshape(*lead, ht * TILE, wt * TILE)[..., :height, :width]


def _rasterize_reference(bins: RasterRows, width: int, height: int,
                         rec_w: int, stats=None):
    """Plain version of the kernel for ``rec_w``-float records, vectorised
    over tiles. The state holds the tiles ordered by their run length
    (longest first), so the tiles that still have a j-th pair row are a
    prefix and every step works on views. Each pixel sees its records in
    the kernel's order: the big list row by row, then its run; the
    arithmetic is the kernel's, operation for operation. Reads
    ``big_nrows`` and the run lengths on the host. Returns (tri_id i32[H,
    W], channels f32[12 or 3, H, W]); ``stats``: see ``_State``."""
    rpr = 128 // rec_w
    x0 = _RECT_LANE[rec_w]
    dev = bins.pair_rows.device
    wt, _, ntiles = _tiles(width, height)
    half_w, inv_w, half_h, inv_h = pixel_constants(width, height)
    counts = bins.row_counts.long()
    order = torch.sort(counts, descending=True, stable=True).indices
    tile = order[:, None]
    pix = torch.arange(PIXELS, device=dev)[None, :]
    sx = ((tile % wt * TILE + pix % TILE).to(torch.float32) - half_w) * inv_w
    sy = ((tile // wt * TILE + pix // TILE).to(torch.float32) - half_h) \
        * inv_h
    txf = (order % wt).to(torch.float32)
    tyf = (order // wt).to(torch.float32)
    st = _State(ntiles, dev, stats, full=rec_w == REC32)

    big = bins.big_rows.reshape(-1, rpr, rec_w)
    for b in range(int(bins.big_nrows)):
        for r in range(rpr):
            rec = big[b, r]
            hit = (rec[x0] <= txf) & (txf <= rec[x0 + 2]) & \
                (rec[x0 + 1] <= tyf) & (tyf <= rec[x0 + 3])
            st.eval_record(ntiles, rec[None, :], sx, sy, hit)

    runs = counts[order].tolist()
    starts = bins.row_starts.long()[order]
    pairs = bins.pair_rows.reshape(-1, rpr, rec_w)
    n = ntiles
    for j in range(runs[0] if runs else 0):
        while runs[n - 1] <= j:
            n -= 1
        rows = pairs[starts[:n] + j]                   # [n, rpr, rec_w]
        for r in range(rpr):
            st.eval_record(n, rows[:, r], sx, sy, None)

    inv = torch.empty_like(order)
    inv[order] = torch.arange(ntiles, device=dev)
    tri = _to_image(st.tri[inv], width, height)
    attrs = _to_image(st.epilogue()[:, inv], width, height)
    if stats is not None:
        for key in ("record_tests", "takes"):
            stats[key] = int(stats.get(key, 0))
    return tri.contiguous(), attrs.contiguous()


def rasterize_rows_reference(bins: RasterRows, width: int, height: int,
                             stats=None):
    """Plain version of ``_raster_kernel32``: 32-float records -> (tri_id
    i32[H, W], attrs f32[12, H, W])."""
    return _rasterize_reference(bins, width, height, REC32, stats)


def rasterize_rows16_reference(bins: RasterRows, width: int, height: int,
                               stats=None):
    """Plain version of ``_raster_kernel16``: 16-float z-only records ->
    (tri_id i32[H, W], u, v, 1/w f32[H, W])."""
    tri, ch = _rasterize_reference(bins, width, height, REC16, stats)
    return tri, ch[0], ch[1], ch[2]


def _check_tile_bins(bins: RasterBins, width: int, height: int,
                     device) -> None:
    _, _, ntiles = _tiles(width, height)
    _check(bins.pair_rows, "pair_rows", torch.float32,
           (bins.pair_rows.shape[0], 128), device)
    _check(bins.starts, "starts", torch.int32, (ntiles,), device)
    _check(bins.counts, "counts", torch.int32, (ntiles,), device)
    _check(bins.big_rows, "big_rows", torch.float32,
           (bins.big_rows.shape[0], 128), device)
    _check(bins.big_count, "big_count", torch.int32, (), device)


def rasterize_tiles_reference(bins: RasterBins, width: int, height: int,
                              stats=None):
    """Plain version of ``_raster_kernel`` (v1): each pixel sees the big
    list's records in order, then its tile's run, in the kernel's
    arithmetic, vectorised over tiles as ``_rasterize_reference`` is.
    Reads ``big_count`` and the run lengths on the host. Returns (tri_id
    i32[H, W], u, v, 1/w f32[H, W]); ``stats``: see ``_State``."""
    dev = bins.pair_rows.device
    wt, _, ntiles = _tiles(width, height)
    counts = bins.counts.long()
    order = torch.sort(counts, descending=True, stable=True).indices
    tile = order[:, None]
    pix = torch.arange(PIXELS, device=dev)[None, :]
    sx = (tile % wt * TILE + pix % TILE).to(torch.float32)
    sy = (tile // wt * TILE + pix // TILE).to(torch.float32)
    st = _State(ntiles, dev, stats, full=False)
    big = bins.big_rows.reshape(-1, REC)
    for b in range(min(int(bins.big_count), big.shape[0])):
        st.eval_record(ntiles, big[b][None, :], sx, sy, None)
    runs = counts[order].tolist()
    starts = bins.starts.long()[order]
    recs = bins.pair_rows.reshape(-1, REC)
    n = ntiles
    for j in range(runs[0] if runs else 0):
        while runs[n - 1] <= j:
            n -= 1
        st.eval_record(n, recs[starts[:n] + j], sx, sy, None)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(ntiles, device=dev)
    tri = _to_image(st.tri[inv], width, height).contiguous()
    ch = _to_image(st.epilogue()[:, inv], width, height).contiguous()
    if stats is not None:
        for key in ("record_tests", "takes"):
            stats[key] = int(stats.get(key, 0))
    return tri, ch[0], ch[1], ch[2]


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def _launch(entry: str, nch: int, bins: RasterRows, width: int,
            height: int):
    """Check the bins, allocate tri_id i32[H, W] and ``nch`` channels
    f32[nch, H, W], launch ``entry`` of ``csrc/raster.cu`` on the current
    stream; raises on a refused launch."""
    from ._build import load_library
    dev = bins.pair_rows.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {dev}")
    _check_bins(bins, width, height, dev)
    for name in ("pair_rows", "big_rows"):
        if getattr(bins, name).data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    wt, _, ntiles = _tiles(width, height)
    half_w, inv_w, half_h, inv_h = pixel_constants(width, height)
    tri = torch.empty((height, width), dtype=torch.int32, device=dev)
    attrs = torch.empty((nch, height, width), dtype=torch.float32,
                        device=dev)
    lib = load_library()
    err = getattr(lib, entry)(
        bins.pair_rows.data_ptr(), bins.pair_rows.shape[0],
        bins.row_starts.data_ptr(), bins.row_counts.data_ptr(),
        bins.big_rows.data_ptr(), bins.big_rows.shape[0],
        bins.big_nrows.data_ptr(), wt, ntiles, width, height,
        ctypes.c_float(half_w), ctypes.c_float(inv_w),
        ctypes.c_float(half_h), ctypes.c_float(inv_h),
        tri.data_ptr(), attrs.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    return tri, attrs


def rasterize_rows_cuda(bins: RasterRows, width: int, height: int):
    """The kernel of ``rasterize_rows_reference`` (``csrc/raster.cu``): one
    block per tile, the tile's rows staged through shared memory."""
    res = _launch("tpurt_raster_rows_launch", N_ATTR, bins, width, height)
    rasterize_rows_cuda.launches += 1
    return res


def rasterize_rows16_cuda(bins: RasterRows, width: int, height: int):
    """The kernel of ``rasterize_rows16_reference``: the 16-float
    instantiation of ``csrc/raster.cu``'s template."""
    tri, ch = _launch("tpurt_raster_rows16_launch", N_ATTR16, bins, width,
                      height)
    rasterize_rows16_cuda.launches += 1
    return tri, ch[0], ch[1], ch[2]


def rasterize_tiles_cuda(bins: RasterBins, width: int, height: int):
    """The kernel of ``rasterize_tiles_reference`` (``csrc/raster.cu``
    ``raster_tiles_kernel``): one block per tile, the records of the big
    list and of the tile's run staged through shared memory and masked by
    record index."""
    from ._build import load_library
    dev = bins.pair_rows.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {dev}")
    _check_tile_bins(bins, width, height, dev)
    for name in ("pair_rows", "big_rows"):
        if getattr(bins, name).data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    wt, _, ntiles = _tiles(width, height)
    tri = torch.empty((height, width), dtype=torch.int32, device=dev)
    ch = torch.empty((N_ATTR16, height, width), dtype=torch.float32,
                     device=dev)
    lib = load_library()
    err = lib.tpurt_raster_tiles_launch(
        bins.pair_rows.data_ptr(), bins.pair_rows.shape[0],
        bins.starts.data_ptr(), bins.counts.data_ptr(),
        bins.big_rows.data_ptr(), bins.big_rows.shape[0],
        bins.big_count.data_ptr(), wt, ntiles, width, height,
        tri.data_ptr(), ch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tpurt_raster_tiles_launch failed: CUDA error "
                           f"{err}")
    rasterize_tiles_cuda.launches += 1
    return tri, ch[0], ch[1], ch[2]


def rasterize_tiles(bins: RasterBins, width: int, height: int):
    """Rasterize ``bin_triangles``' pairs at width x height (``tpurt``'s
    v1 ``rasterize_tiles``) -> (tri_id i32[H, W] (-1 background), u, v,
    1/w f32[H, W] (0 on background pixels)); the kernel for CUDA tensors,
    its plain version for CPU tensors."""
    fn = _pick(bins.pair_rows.device, rasterize_tiles_cuda,
               rasterize_tiles_reference)
    return fn(bins, width, height)


def rasterize_rows(bins: RasterRows, width: int, height: int):
    """Rasterize binned rows (``raster.setup.bin_rows``) at width x height
    -> (tri_id i32[H, W], attrs f32[12, H, W]); the kernel for CUDA
    tensors, its plain version for CPU tensors."""
    fn = _pick(bins.pair_rows.device, rasterize_rows_cuda,
               rasterize_rows_reference)
    return fn(bins, width, height)


def rasterize_rows16(bins: RasterRows, width: int, height: int):
    """Rasterize z-only rows (``bin_rows(..., fmt="z16")``) -> (tri_id
    i32[H, W], u, v, 1/w f32[H, W]); the kernel for CUDA tensors, its
    plain version for CPU tensors."""
    fn = _pick(bins.pair_rows.device, rasterize_rows16_cuda,
               rasterize_rows16_reference)
    return fn(bins, width, height)


RASTER_KERNELS = (rasterize_rows_cuda, rasterize_rows16_cuda,
                  rasterize_tiles_cuda)
for _fn in RASTER_KERNELS:
    _fn.launches = 0
