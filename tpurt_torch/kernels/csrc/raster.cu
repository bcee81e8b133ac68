// The tile rasterizer (counterpart of tpurt/kernels/raster.py
// rasterize_rows (:504) -> _raster_kernel32 (:217), records read as
// _eval_records32 (:165) reads them, epilogue :289-313).
//
// For each pixel of a 32x32 tile: stream the big list (every record culled
// by its stored tile rect, lanes 27-30), then the tile's contiguous run of
// 4-record pair rows; a covered record with a live id and 1/w > the best so
// far takes the pixel (the first record wins a tie) and carries d1, d2,
// the d-sum, the id, the d-weighted vertex normals, the geometric normal
// and the albedo. The epilogue writes tri_id and 12 planar channels
// [u, v, 1/w, n, gn, albedo]; pixels past the image are not written.
//
// Plain C entry point, launched on the caller's stream; it returns the CUDA
// error of the launch (0 on success). The wrapper in
// tpurt_torch/kernels/raster.py allocates the outputs.
//
// What bounds it on the H100: about 58 float32 operations per record per
// pixel against 512 bytes per row of four records shared by the tile's
// 1024 pixels, so operations, not bytes (the bytes floor is a fraction of
// the operations floor). The design:
// - one block per tile, 256 threads, 4 pixels per thread (rows y, y + 8,
//   y + 16, y + 24 of one column), so each record's 27 lanes are loaded
//   from shared memory once per thread and used for 4 pixels;
// - the tile's rows are staged from device memory into shared memory in
//   chunks of 16 rows (8 KB), double-buffered with cp.async, and every
//   thread reads the same record: a shared-memory broadcast, the card's
//   form of the Pallas kernel's SMEM scalar reads;
// - the big list's cull is uniform across the block;
// - the z-fight state lives in registers; outputs are written once,
//   coalesced along tile rows.
// Bit parity with the plain version: built with --fmad=false, the edge
// evaluations keep d = (a*sx + b*sy) + c, invw = dsum * dinv, and the
// normal's 1/|n| is an IEEE division by an IEEE square root.
// The TPU kernel's B_TILES tiles per grid step, pad tiles, (8, 128)
// packets and scalar-prefetched metadata have no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int PIX = TILE * TILE / THREADS;  // pixels per thread
constexpr int ROW = 128;                    // floats per row
constexpr int REC = 32;                     // floats per record
constexpr int RECS_PER_ROW = ROW / REC;
constexpr int CHUNK = 16;                   // rows per staged chunk
constexpr int N_ATTR = 12;

struct Pixel {
  float best, d1, d2, dsum;
  int tri;
  float nx, ny, nz, gx, gy, gz, ar, ag, ab;
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + n) of src into dst (n <= CHUNK), 16 bytes a copy;
// every thread commits one group, empty or not.
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long row0, int n) {
  for (int i = threadIdx.x; i < n * (ROW / 4); i += THREADS) {
    int r = i / (ROW / 4);
    int seg = i % (ROW / 4);
    cp_async16(dst + r * ROW + seg * 4, src + (row0 + r) * ROW + seg * 4);
  }
  cp_async_commit();
}

// One record against this thread's pixels (rec in shared memory).
__device__ __forceinline__ void eval_record(const float* rec,
                                            const float (&sx)[PIX],
                                            const float (&sy)[PIX],
                                            Pixel (&px)[PIX]) {
  const float a0 = rec[0], b0 = rec[1], c0 = rec[2];
  const float a1 = rec[3], b1 = rec[4], c1 = rec[5];
  const float a2 = rec[6], b2 = rec[7], c2 = rec[8];
  const float dinv = rec[9];
  const float tid = rec[10];
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    float d0 = a0 * sx[k] + b0 * sy[k] + c0;
    float d1 = a1 * sx[k] + b1 * sy[k] + c1;
    float d2 = a2 * sx[k] + b2 * sy[k] + c2;
    float dsum = d0 + d1 + d2;
    bool cov = (d0 >= 0.0f && d1 >= 0.0f && d2 >= 0.0f) ||
               (d0 <= 0.0f && d1 <= 0.0f && d2 <= 0.0f);
    float invw = dsum * dinv;
    if (cov && invw > px[k].best && tid >= 0.0f) {
      px[k].best = invw;
      px[k].d1 = d1;
      px[k].d2 = d2;
      px[k].dsum = dsum;
      px[k].tri = static_cast<int>(tid);
      px[k].nx = d0 * rec[12] + d1 * rec[15] + d2 * rec[18];
      px[k].ny = d0 * rec[13] + d1 * rec[16] + d2 * rec[19];
      px[k].nz = d0 * rec[14] + d1 * rec[17] + d2 * rec[20];
      px[k].gx = rec[21];
      px[k].gy = rec[22];
      px[k].gz = rec[23];
      px[k].ar = rec[24];
      px[k].ag = rec[25];
      px[k].ab = rec[26];
    }
  }
}

// Rows [row_lo, row_lo + n) of src through the two shared buffers. CULL:
// test each record's tile rect against (txf, tyf) first (the big list).
template <bool CULL>
__device__ __forceinline__ void stream(const float* __restrict__ src,
                                       long long row_lo, int n, float* buf,
                                       float txf, float tyf,
                                       const float (&sx)[PIX],
                                       const float (&sy)[PIX],
                                       Pixel (&px)[PIX]) {
  int nchunks = (n + CHUNK - 1) / CHUNK;
  if (nchunks == 0) return;
  stage(buf, src, row_lo, min(CHUNK, n));
  for (int ci = 0; ci < nchunks; ++ci) {
    const float* cur = buf + (ci & 1) * CHUNK * ROW;
    if (ci + 1 < nchunks) {
      int next = (ci + 1) * CHUNK;
      stage(buf + ((ci + 1) & 1) * CHUNK * ROW, src, row_lo + next,
            min(CHUNK, n - next));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int rows = min(CHUNK, n - ci * CHUNK);
    for (int r = 0; r < rows; ++r) {
#pragma unroll
      for (int q = 0; q < RECS_PER_ROW; ++q) {
        const float* rec = cur + r * ROW + q * REC;
        if (CULL && !(rec[27] <= txf && txf <= rec[29] && rec[28] <= tyf &&
                      tyf <= rec[30])) {
          continue;
        }
        eval_record(rec, sx, sy, px);
      }
    }
    __syncthreads();  // the buffer is free for the chunk after next
  }
}

__global__ void __launch_bounds__(THREADS)
    raster_rows_kernel(const float* __restrict__ pair_rows, int cap_rows,
                       const int* __restrict__ row_starts,
                       const int* __restrict__ row_counts,
                       const float* __restrict__ big_rows, int big_cap_rows,
                       const int* __restrict__ big_nrows, int wt, int width,
                       int height, float half_w, float inv_w, float half_h,
                       float inv_h, int* __restrict__ tri,
                       float* __restrict__ attrs) {
  __shared__ __align__(16) float buf[2 * CHUNK * ROW];
  const int tile = blockIdx.x;
  const int tx = tile % wt;
  const int ty = tile / wt;
  const int col = threadIdx.x % TILE;
  const int row0 = threadIdx.x / TILE;  // rows row0 + 8k
  float sx[PIX], sy[PIX];
  Pixel px[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    // Centred, unit-scaled coordinates, as raster/setup._edges_centered.
    sx[k] = (static_cast<float>(tx * TILE + col) - half_w) * inv_w;
    sy[k] = (static_cast<float>(ty * TILE + row0 + 8 * k) - half_h) * inv_h;
    px[k] = Pixel{0.0f, 0.0f, 0.0f, 1.0f, -1, 0.0f, 0.0f, 0.0f,
                  0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  }

  int nbig = min(max(*big_nrows, 0), big_cap_rows);
  stream<true>(big_rows, 0, nbig, buf, static_cast<float>(tx),
               static_cast<float>(ty), sx, sy, px);
  int start = min(max(row_starts[tile], 0), cap_rows);
  int count = min(max(row_counts[tile], 0), cap_rows - start);
  stream<false>(pair_rows, start, count, buf, 0.0f, 0.0f, sx, sy, px);

  const long long plane = static_cast<long long>(width) * height;
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    int x = tx * TILE + col;
    int y = ty * TILE + row0 + 8 * k;
    if (x >= width || y >= height) continue;
    const Pixel& p = px[k];
    bool hit = p.tri >= 0;
    float safe = fabsf(p.dsum) > 1e-30f ? p.dsum : 1.0f;
    float rn = 1.0f / sqrtf(fmaxf(p.nx * p.nx + p.ny * p.ny + p.nz * p.nz,
                                  1e-30f));
    rn = rn * (p.dsum < 0.0f ? -1.0f : 1.0f);
    float ch[N_ATTR] = {p.d1 / safe, p.d2 / safe, p.best,
                        p.nx * rn,   p.ny * rn,   p.nz * rn,
                        p.gx,        p.gy,        p.gz,
                        p.ar,        p.ag,        p.ab};
    long long idx = static_cast<long long>(y) * width + x;
    tri[idx] = p.tri;
#pragma unroll
    for (int c = 0; c < N_ATTR; ++c) {
      attrs[c * plane + idx] = hit ? ch[c] : 0.0f;
    }
  }
}

}  // namespace

extern "C" int tpurt_raster_rows_launch(
    const float* pair_rows, int cap_rows, const int* row_starts,
    const int* row_counts, const float* big_rows, int big_cap_rows,
    const int* big_nrows, int wt, int ntiles, int width, int height,
    float half_w, float inv_w, float half_h, float inv_h, int* tri,
    float* attrs, cudaStream_t stream) {
  if (ntiles > 0) {
    raster_rows_kernel<<<ntiles, THREADS, 0, stream>>>(
        pair_rows, cap_rows, row_starts, row_counts, big_rows, big_cap_rows,
        big_nrows, wt, width, height, half_w, inv_w, half_h, inv_h, tri,
        attrs);
  }
  return static_cast<int>(cudaGetLastError());
}
