// The per-frame rebuild's kernels (counterparts of tpurt/kernels/build.py):
//
//   morton codes   <- morton_codes_pallas (:353) -> _codes_kernel (:325)
//   topology       <- topology_pallas (:265) -> _topology_call (:215)
//                     -> _build_kernel (:60, with_boxes=False,
//                     with_depth=False), root renumbered as _renumber (:249)
//   area collapse  <- collapse_area_pallas (:742) -> _collapse_area_kernel
//                     (:648)
//
// Plain C entry points, launched on the caller's stream; each returns the
// CUDA error of its launches (0 on success). The wrappers in
// tpurt_torch/kernels/build.py allocate every output and scratch buffer.
//
// What bounds them on the H100, and what the design does about it:
// - Morton codes: 12 bytes in, 4 out per triangle, a few dozen integer
//   operations: bound by bytes. One thread per point, coalesced.
// - Topology: the TPU kernel is one serial monotonic-stack sweep on the
//   scalar core. Here every gap g finds, in parallel, L[g] = the nearest
//   j < g with D[j] <= D[g] and R[g] = the nearest j > g with D[j] < D[g]
//   by binary lifting over a sparse table of range minima of D (log2(ni)
//   levels built level by level), then derives parent, side, first and
//   last as lbvh.karras_topology_scan does. The min-Cartesian tree over
//   (D[g], g) is unique, so the result equals the stack sweep's exactly,
//   ties included. Bound by the latency of the dependent table reads
//   (2 log2(ni) per gap); the bytes are a few MB.
// - Area collapse: the TPU kernel is a serial BFS whose wide ids are queue
//   positions. BFS order is level order with children numbered by
//   (parent position, slot), so one block walks the levels: one thread per
//   wide node of the level runs the 6-step greedy expansion (first maximum
//   wins), a block-wide exclusive scan of the internal-slot counts gives
//   the children's positions. Bound by latency: a few thousand wide nodes
//   in ~20 dependent levels, each thread's expansion a chain of dependent
//   loads. One block is the simple form; it leaves 131 SMs idle.

#include <cuda_runtime.h>

#define EMPTY_REF (-2147483647 - 1)  // wide.EMPTY, int32 min

// ---------------------------------------------------------------------------
// Morton codes
// ---------------------------------------------------------------------------

__device__ __forceinline__ int expand_bits_10(int v) {
  v &= 0x3FF;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

__device__ __forceinline__ int quantize(float u) {
  // jnp.clip(u * 1024, 0, 1023), truncated toward zero (exact: < 2^10).
  float q = fminf(fmaxf(u * 1024.0f, 0.0f), 1023.0f);
  return static_cast<int>(q);
}

__global__ void morton_codes_kernel(const float* __restrict__ unit, int n,
                                    int* __restrict__ codes) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int qx = quantize(unit[3 * i + 0]);
  int qy = quantize(unit[3 * i + 1]);
  int qz = quantize(unit[3 * i + 2]);
  codes[i] = (expand_bits_10(qx) << 2) | (expand_bits_10(qy) << 1)
      | expand_bits_10(qz);
}

extern "C" int tpurt_morton_codes_launch(const float* unit, int n, int* codes,
                                         cudaStream_t stream) {
  if (n > 0) {
    morton_codes_kernel<<<(n + 255) / 256, 256, 0, stream>>>(unit, n, codes);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Topology: the min-Cartesian tree over adjacent deltas
// ---------------------------------------------------------------------------

// Level k of the sparse table: T_k[i] = min(D[i .. i + 2^k - 1]) wherever
// that range lies inside [0, ni). Level 0 is D itself; level k >= 1 lives
// at table + (k - 1) * ni.
__host__ __device__ __forceinline__ const int* level_ptr(const int* d,
                                                const int* table, int ni,
                                                int k) {
  return k == 0 ? d : table + static_cast<long long>(k - 1) * ni;
}

__global__ void sparse_level_kernel(const int* __restrict__ prev,
                                    int* __restrict__ next, int ni,
                                    int half) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ni) return;
  int a = prev[i];
  next[i] = (i + half < ni) ? min(a, prev[i + half]) : a;
}

// L[g] (-1: none) and R[g] (ni: none) into lr[g], lr[ni + g]; the root is
// the one gap with neither.
__global__ void nearest_smaller_kernel(const int* __restrict__ d,
                                       const int* __restrict__ table, int ni,
                                       int levels, int* __restrict__ lr,
                                       int* __restrict__ root) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= ni) return;
  int dg = d[g];
  // Longest run d[p .. g-1] with every value > dg, greedily by powers of
  // two (the predicate is monotone in the run's length).
  int p = g;
  for (int k = levels - 1; k >= 0; --k) {
    int len = 1 << k;
    if (p >= len && level_ptr(d, table, ni, k)[p - len] > dg) p -= len;
  }
  // Longest run d[g+1 .. q-1] with every value >= dg.
  int q = g + 1;
  for (int k = levels - 1; k >= 0; --k) {
    int len = 1 << k;
    if (q + len <= ni && level_ptr(d, table, ni, k)[q] >= dg) q += len;
  }
  int L = p - 1;
  int R = q;
  lr[g] = L;
  lr[ni + g] = R;
  if (L < 0 && R >= ni) *root = g;
}

__device__ __forceinline__ int renum(int x, int root) {
  return x == root ? 0 : (x == 0 ? root : x);
}

// One thread per leaf l in [0, ni]; thread g < ni also places gap g. Node
// ids are gap ids with the root swapped to 0 (rows and values).
__global__ void assemble_kernel(const int* __restrict__ d,
                                const int* __restrict__ lr, int ni,
                                const int* __restrict__ root_ptr,
                                int* __restrict__ child,
                                int* __restrict__ first,
                                int* __restrict__ last) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > ni) return;
  int root = *root_ptr;
  if (i < ni) {
    int g = i;
    int L = lr[g];
    int R = lr[ni + g];
    int row = renum(g, root);
    first[row] = L + 1;
    last[row] = R;
    if (g != root) {
      // Parent: the larger of (D[L], L) and (D[R], R); ties go to R.
      int p = L < 0 ? R : (R >= ni ? L : (d[L] > d[R] ? L : R));
      int side = g < p ? 0 : 1;
      child[2 * renum(p, root) + side] = row;
    }
  }
  // Leaf l sits between gaps l-1 and l; its parent is the larger of them.
  int l = i;
  int n = ni + 1;
  int lp = l == 0 ? 0 : (l == n - 1 ? ni - 1 : (d[l - 1] > d[l] ? l - 1 : l));
  int side = l <= lp ? 0 : 1;
  child[2 * renum(lp, root) + side] = -(l + 1);
}

extern "C" int tpurt_topology_launch(const int* d, int ni, int levels,
                                     int* table, int* lr, int* root,
                                     int* child, int* first, int* last,
                                     cudaStream_t stream) {
  const int threads = 256;
  int blocks = (ni + threads - 1) / threads;
  for (int k = 1; k < levels; ++k) {
    const int* prev = level_ptr(d, table, ni, k - 1);
    int* next = table + static_cast<long long>(k - 1) * ni;
    sparse_level_kernel<<<blocks, threads, 0, stream>>>(prev, next, ni,
                                                        1 << (k - 1));
  }
  nearest_smaller_kernel<<<blocks, threads, 0, stream>>>(d, table, ni, levels,
                                                         lr, root);
  assemble_kernel<<<(ni + 1 + threads - 1) / threads, threads, 0, stream>>>(
      d, lr, ni, root, child, first, last);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Area-greedy 8-wide collapse, level by level in one block
// ---------------------------------------------------------------------------

constexpr int COLLAPSE_THREADS = 1024;

// Exclusive prefix sum of v over the block; *total gets the block's sum.
// Every thread of the block must call it.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sum[COLLAPSE_THREADS / 32];
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  int before = warp > 0 ? warp_sum[warp - 1] : 0;
  *total = warp_sum[COLLAPSE_THREADS / 32 - 1];
  __syncthreads();
  return before + x - v;
}

__device__ __forceinline__ float area_of(const float* area, int ref) {
  return ref >= 0 ? area[ref] : -1.0f;
}

__global__ void __launch_bounds__(COLLAPSE_THREADS)
collapse_area_kernel(const int* __restrict__ child,
                     const float* __restrict__ area, int nw_pad,
                     int* __restrict__ front, int* __restrict__ src,
                     int* __restrict__ count) {
  for (int i = threadIdx.x; i < nw_pad * 8; i += COLLAPSE_THREADS) {
    front[i] = EMPTY_REF;
  }
  // src doubles as the BFS queue: position -> binary node id. The root
  // (binary node 0) is position 0; pad rows keep 0.
  for (int i = threadIdx.x; i < nw_pad; i += COLLAPSE_THREADS) src[i] = 0;
  __syncthreads();

  int lo = 0, hi = 1;  // the current level's positions [lo, hi)
  while (lo < min(hi, nw_pad)) {
    int end = min(hi, nw_pad);  // positions past the pad are never expanded
    int next = hi;              // first position of the next level's chunk
    for (int base = lo; base < end; base += COLLAPSE_THREADS) {
      int q = base + threadIdx.x;
      bool active = q < end;
      int sl[8];
      int n_int = 0;
      if (active) {
        int x = src[q];
        float key[8];
        sl[0] = child[2 * x];
        sl[1] = child[2 * x + 1];
        key[0] = area_of(area, sl[0]);
        key[1] = area_of(area, sl[1]);
#pragma unroll
        for (int s = 2; s < 8; ++s) {
          sl[s] = EMPTY_REF;
          key[s] = -1.0f;
        }
        int cnt = 2;
#pragma unroll
        for (int step = 0; step < 6; ++step) {
          // Argmax over the slot keys, the first maximum winning.
          float best = key[0];
          int bj = 0;
#pragma unroll
          for (int s = 1; s < 8; ++s) {
            if (key[s] > best) {
              best = key[s];
              bj = s;
            }
          }
          bool can = cnt < 8 && best >= 0.0f;
          if (can) {
            int ref = sl[0];
#pragma unroll
            for (int s = 1; s < 8; ++s) ref = bj == s ? sl[s] : ref;
            int lc = child[2 * ref];
            int rc = child[2 * ref + 1];
            float al = area_of(area, lc);
            float ar = area_of(area, rc);
            // Slot bj takes the left child, slot cnt the right one.
#pragma unroll
            for (int s = 0; s < 8; ++s) {
              bool put_l = bj == s;
              bool put_r = cnt == s;
              sl[s] = put_l ? lc : (put_r ? rc : sl[s]);
              key[s] = put_l ? al : (put_r ? ar : key[s]);
            }
            ++cnt;
          }
        }
#pragma unroll
        for (int s = 0; s < 8; ++s) n_int += sl[s] >= 0;
      }
      int total;
      int pos = next + block_exclusive_scan(n_int, &total);
      if (active) {
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          int ref = sl[s];
          if (ref >= 0) {
            if (pos < nw_pad) src[pos] = ref;  // pushed only inside the pad
            front[q * 8 + s] = pos++;
          } else {
            front[q * 8 + s] = ref;
          }
        }
      }
      next += total;
    }
    __syncthreads();  // the next level reads the positions written here
    lo = hi;
    hi = next;
  }
  if (threadIdx.x == 0) *count = hi;
}

extern "C" int tpurt_collapse_area_launch(const int* child, const float* area,
                                          int ni, int nw_pad, int* front,
                                          int* src, int* count,
                                          cudaStream_t stream) {
  (void)ni;
  collapse_area_kernel<<<1, COLLAPSE_THREADS, 0, stream>>>(child, area, nw_pad,
                                                           front, src, count);
  return static_cast<int>(cudaGetLastError());
}
