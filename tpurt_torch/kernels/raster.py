"""The tile rasterizer (counterpart of ``tpurt/kernels/raster.py``
``rasterize_rows`` -> ``_raster_kernel32``).

For each pixel of each 32x32 tile, stream the binned 32-float records
(``raster/setup.py``) in this order: the big list, each record culled by
its stored tile rect, then the tile's contiguous run of pair rows. A
covered record with a live id and 1/w > the best so far takes the pixel
(the first record wins a tie) and carries its d1, d2, d-sum, id,
d-weighted vertex normals, geometric normal and albedo. The epilogue
writes u, v = d/dsum, 1/w, the normalised normal with sign(dsum) folded
in, the geometric normal and the albedo; pixels without a hit get id -1
and zeros.

Three pieces, as in ``kernels/traverse.py``:

- ``rasterize_rows_cuda``: the hand-written CUDA kernel
  (``csrc/raster.cu``). It takes CUDA tensors only and launches or raises;
  ``.launches`` counts its launches.
- ``rasterize_rows_reference``: the same function in plain PyTorch,
  vectorised over tiles, in the kernel's order and arithmetic. The
  wrapper takes it only for CPU tensors.
- ``rasterize_rows``: the wrapper the G-buffer calls.

Outputs, ``tpurt``'s contract: tri_id i32[H, W] and attrs f32[12, H, W],
channels [u, v, 1/w, nx, ny, nz, gnx, gny, gnz, ar, ag, ab]. The TPU
kernel's padding of the row arrays with a chunk of dead rows only keeps
its fixed-size DMA in bounds; the CUDA kernel stages only rows inside a
run, so neither version copies the rows to pad them.
"""

from __future__ import annotations

import ctypes

import torch

from ..raster.setup import (REC32, RECS32_PER_ROW, TILE, RasterRows,
                            pixel_constants)
from ._build import _check, _pick

N_ATTR = 12
PIXELS = TILE * TILE


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
    d1, d2, d-sum, id, the d-weighted normal, the geometric normal, the
    albedo. ``stats`` (a dict, or None) counts the work the kernel's bound
    is computed from: "record_tests", the (record, pixel) pairs tested, and
    "takes", those where the record took the pixel."""

    def __init__(self, ntiles: int, device, stats=None):
        self.stats = stats

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
        nw = [d0 * lane(12 + c) + d1 * lane(15 + c) + d2 * lane(18 + c)
              for c in range(3)]

        def take(dst, new):
            dst[:n] = torch.where(ok, new, dst[:n])
        take(self.best, invw)
        take(self.d1, d1)
        take(self.d2, d2)
        take(self.dsum, dsum)
        take(self.tri, lane(10).to(torch.int32))
        for c in range(3):
            take(self.nw[c], nw[c])
            take(self.gn[c], lane(21 + c))
            take(self.alb[c], lane(24 + c))

    def epilogue(self) -> torch.Tensor:
        """-> f32[12, ntiles, 1024] channels (id apart)."""
        hit = self.tri >= 0
        safe = torch.where(self.dsum.abs() > 1e-30, self.dsum, 1.0)
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


def rasterize_rows_reference(bins: RasterRows, width: int, height: int,
                             stats=None):
    """Plain version of the kernel, vectorised over tiles. The state holds
    the tiles ordered by their run length (longest first), so the tiles
    that still have a j-th pair row are a prefix and every step works on
    views. Each pixel sees its records in the kernel's order: the big list
    row by row, then its run; the arithmetic is the kernel's, operation for
    operation. Reads ``big_nrows`` and the run lengths on the host.
    Returns (tri_id i32[H, W], attrs f32[12, H, W]); ``stats``: see
    ``_State``."""
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
    st = _State(ntiles, dev, stats)

    big = bins.big_rows.reshape(-1, RECS32_PER_ROW, REC32)
    for b in range(int(bins.big_nrows)):
        for r in range(RECS32_PER_ROW):
            rec = big[b, r]
            hit = (rec[27] <= txf) & (txf <= rec[29]) & \
                (rec[28] <= tyf) & (tyf <= rec[30])
            st.eval_record(ntiles, rec[None, :], sx, sy, hit)

    runs = counts[order].tolist()
    starts = bins.row_starts.long()[order]
    pairs = bins.pair_rows.reshape(-1, RECS32_PER_ROW, REC32)
    n = ntiles
    for j in range(runs[0] if runs else 0):
        while runs[n - 1] <= j:
            n -= 1
        rows = pairs[starts[:n] + j]                   # [n, 4, 32]
        for r in range(RECS32_PER_ROW):
            st.eval_record(n, rows[:, r], sx, sy, None)

    inv = torch.empty_like(order)
    inv[order] = torch.arange(ntiles, device=dev)
    tri = _to_image(st.tri[inv], width, height)
    attrs = _to_image(st.epilogue()[:, inv], width, height)
    if stats is not None:
        for key in ("record_tests", "takes"):
            stats[key] = int(stats.get(key, 0))
    return tri.contiguous(), attrs.contiguous()


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def rasterize_rows_cuda(bins: RasterRows, width: int, height: int):
    """The kernel of ``rasterize_rows_reference`` (``csrc/raster.cu``): one
    block per tile, the tile's rows staged through shared memory."""
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
    attrs = torch.empty((N_ATTR, height, width), dtype=torch.float32,
                        device=dev)
    lib = load_library()
    err = lib.tpurt_raster_rows_launch(
        bins.pair_rows.data_ptr(), bins.pair_rows.shape[0],
        bins.row_starts.data_ptr(), bins.row_counts.data_ptr(),
        bins.big_rows.data_ptr(), bins.big_rows.shape[0],
        bins.big_nrows.data_ptr(), wt, ntiles, width, height,
        ctypes.c_float(half_w), ctypes.c_float(inv_w),
        ctypes.c_float(half_h), ctypes.c_float(inv_h),
        tri.data_ptr(), attrs.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tpurt_raster_rows_launch failed: CUDA error "
                           f"{err}")
    rasterize_rows_cuda.launches += 1
    return tri, attrs


def rasterize_rows(bins: RasterRows, width: int, height: int):
    """Rasterize binned rows (``raster.setup.bin_rows``) at width x height
    -> (tri_id i32[H, W], attrs f32[12, H, W]); the kernel for CUDA
    tensors, its plain version for CPU tensors."""
    fn = _pick(bins.pair_rows.device, rasterize_rows_cuda,
               rasterize_rows_reference)
    return fn(bins, width, height)


RASTER_KERNELS = (rasterize_rows_cuda,)
for _fn in RASTER_KERNELS:
    _fn.launches = 0
