// The per-frame rebuild's kernels (counterparts of tpurt/kernels/build.py):
//
//   morton codes   <- morton_codes_pallas (:353) -> _codes_kernel (:325)
//   60-bit codes   <- morton_codes60_pallas (:410) -> _codes60_kernel (:384)
//   topology       <- topology_pallas (:265) -> _topology_call (:215)
//                     -> _build_kernel (:60, with_boxes=False), root
//                     renumbered as _renumber (:249); with want_depth
//                     (with_depth=True, the sweep :190-213) also every
//                     node's depth
//   topology and   <- topology_and_boxes_pallas (:288) -> _topology_call
//   node boxes        (:215) -> _build_kernel (:60, with_boxes=True): the
//                     topology's launches, then node_boxes_kernel
//   area collapse  <- collapse_area_pallas (:742) -> _collapse_area_kernel
//                     (:648)
//   sweep-SAH      <- sweep_sah_priorities (:582) -> _sweep_sah_kernel
//                     (:469), top_sah's re-chosen top splits
//
// Plain C entry points, launched on the caller's stream; each returns the
// CUDA error of its launches (0 on success). The wrappers in
// tpurt_torch/kernels/build.py allocate every output and scratch buffer.
//
// What bounds them on the H100, and what the design does about it:
// - Morton codes: 12 bytes in, 4 out per triangle (8 for the 60-bit
//   keys), a few dozen integer operations: bound by bytes. One thread per
//   point, coalesced.
// - Topology: the TPU kernel is one serial monotonic-stack sweep on the
//   scalar core. Here every gap g finds, in parallel, L[g] = the nearest
//   j < g with D[j] <= D[g] and R[g] = the nearest j > g with D[j] < D[g]
//   by binary lifting over a sparse table of range minima of D (log2(ni)
//   levels built level by level), then derives parent, side, first and
//   last as lbvh.karras_topology_scan does. The min-Cartesian tree over
//   (D[g], g) is unique, so the result equals the stack sweep's exactly,
//   ties included. Bound by the latency of the dependent table reads
//   (2 log2(ni) per gap); the bytes are a few MB. The depth output: the
//   TPU kernel replays its finalize order backwards on the scalar core.
//   Here placement also writes each node's parent, and one thread per
//   node counts the steps up the parent pointers to the root. A Karras
//   tree is at most D_MAX - 1 = 95 levels deep (deltas grow strictly from
//   a node to its children; top_sah's steered priorities D' reach D_MAX -
//   1 + maxd, and the wrapper passes that bound), so a thread makes at
//   most 95 (116 steered) dependent loads of a 100 KB array that stays in
//   L2. The node boxes: the TPU kernel unions a node's child boxes when it
//   pops in the serial sweep. Here a thread per leaf climbs the parent
//   pointers and the second child to arrive at a node (an atomic counter
//   per node) carries the union up: bound by the latency of the climb
//   (at most 95 levels) and one atomic per node; the bytes are about
//   1.6 MB for 25,640 gaps.
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

// 60-bit keys: each coordinate on the 2^20 lattice (jnp.clip(u * 2^20, 0,
// 2^20 - 1), truncated; exact below 2^24), hi the interleave of its top 10
// bits, lo of its low 10.
__device__ __forceinline__ int quantize20(float u) {
  float q = fminf(fmaxf(u * 1048576.0f, 0.0f), 1048575.0f);
  return static_cast<int>(q);
}

__global__ void morton_codes60_kernel(const float* __restrict__ unit, int n,
                                      int* __restrict__ hi,
                                      int* __restrict__ lo) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int qx = quantize20(unit[3 * i + 0]);
  int qy = quantize20(unit[3 * i + 1]);
  int qz = quantize20(unit[3 * i + 2]);
  hi[i] = (expand_bits_10(qx >> 10) << 2) | (expand_bits_10(qy >> 10) << 1)
      | expand_bits_10(qz >> 10);
  lo[i] = (expand_bits_10(qx) << 2) | (expand_bits_10(qy) << 1)
      | expand_bits_10(qz);
}

extern "C" int tpurt_morton_codes60_launch(const float* unit, int n, int* hi,
                                           int* lo, cudaStream_t stream) {
  if (n > 0) {
    morton_codes60_kernel<<<(n + 255) / 256, 256, 0, stream>>>(unit, n, hi,
                                                               lo);
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
// ids are gap ids with the root swapped to 0 (rows and values). parent
// (null: not wanted) gets each node's parent, -1 for the root.
__global__ void assemble_kernel(const int* __restrict__ d,
                                const int* __restrict__ lr, int ni,
                                const int* __restrict__ root_ptr,
                                int* __restrict__ child,
                                int* __restrict__ first,
                                int* __restrict__ last,
                                int* __restrict__ parent) {
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
      if (parent) parent[row] = renum(p, root);
    } else if (parent) {
      parent[row] = -1;
    }
  }
  // Leaf l sits between gaps l-1 and l; its parent is the larger of them.
  int l = i;
  int n = ni + 1;
  int lp = l == 0 ? 0 : (l == n - 1 ? ni - 1 : (d[l - 1] > d[l] ? l - 1 : l));
  int side = l <= lp ? 0 : 1;
  child[2 * renum(lp, root) + side] = -(l + 1);
}

// depth[n] = the steps from node n up to the root (row 0): at most
// max_depth, the Karras bound, so a damaged parent array cannot loop.
__global__ void depth_kernel(const int* __restrict__ parent, int ni,
                             int max_depth, int* __restrict__ depth) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= ni) return;
  int x = n, steps = 0;
  while (steps < max_depth) {
    int p = parent[x];
    if (p < 0) break;
    x = p;
    ++steps;
  }
  depth[n] = steps;
}

// parent and depth: both null (no depth), or both i32[ni] (the depth
// output; parent is scratch).
extern "C" int tpurt_topology_launch(const int* d, int ni, int levels,
                                     int* table, int* lr, int* root,
                                     int* child, int* first, int* last,
                                     int* parent, int* depth, int max_depth,
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
      d, lr, ni, root, child, first, last, parent);
  if (depth) {
    depth_kernel<<<blocks, threads, 0, stream>>>(parent, ni, max_depth,
                                                 depth);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Node boxes, bottom up (topology_and_boxes)
// ---------------------------------------------------------------------------

// One thread per leaf l in [0, ni]: write the leaf's box into its parent's
// record (side 0: lanes 0-5 [Lmin, Lmax], side 1: lanes 6-11 [Rmin,
// Rmax]), fence, and count the arrival at the parent; the first of the
// parent's two children to arrive stops, the second reads the other
// half (through L2: the other thread's write is not in this SM's L1),
// forms the union min(L, R), max(L, R) and climbs one level. Each node's
// union is written once, by the thread of its last child to arrive; the
// root's union is the root box. A union is a min and a max, so the
// result equals the TPU kernel's serial finalize order bit for bit.
__global__ void node_boxes_kernel(const int* __restrict__ d, int ni,
                                  const int* __restrict__ root_ptr,
                                  const int* __restrict__ child,
                                  const int* __restrict__ parent,
                                  const float* __restrict__ leaf_min,
                                  const float* __restrict__ leaf_max,
                                  int* arrive, float* nbox,
                                  float* root_box) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l > ni) return;
  int root = *root_ptr;
  int n = ni + 1;
  int lp = l == 0 ? 0 : (l == n - 1 ? ni - 1 : (d[l - 1] > d[l] ? l - 1 : l));
  int side = l <= lp ? 0 : 1;
  int x = renum(lp, root);
  float lo[3], hi[3];
  for (int a = 0; a < 3; ++a) {
    lo[a] = leaf_min[3 * l + a];
    hi[a] = leaf_max[3 * l + a];
  }
  while (true) {
    float* rec = nbox + 12 * static_cast<long long>(x);
    for (int a = 0; a < 3; ++a) {
      rec[6 * side + a] = lo[a];
      rec[6 * side + 3 + a] = hi[a];
    }
    __threadfence();
    if (atomicAdd(arrive + x, 1) == 0) return;
    __threadfence();
    const float* other = rec + 6 * (1 - side);
    for (int a = 0; a < 3; ++a) {
      float olo = __ldcg(other + a), ohi = __ldcg(other + 3 + a);
      lo[a] = side == 0 ? fminf(lo[a], olo) : fminf(olo, lo[a]);
      hi[a] = side == 0 ? fmaxf(hi[a], ohi) : fmaxf(ohi, hi[a]);
    }
    int p = parent[x];
    if (p < 0) {
      for (int a = 0; a < 3; ++a) {
        root_box[a] = lo[a];
        root_box[3 + a] = hi[a];
      }
      return;
    }
    side = child[2 * p] == x ? 0 : 1;
    x = p;
  }
}

// After tpurt_topology_launch with a parent array: arrive i32[ni] zeroed,
// nbox f32[ni, 12], root_box f32[6] (min, max).
extern "C" int tpurt_node_boxes_launch(const int* d, int ni, const int* root,
                                       const int* child, const int* parent,
                                       const float* leaf_min,
                                       const float* leaf_max, int* arrive,
                                       float* nbox, float* root_box,
                                       cudaStream_t stream) {
  const int threads = 256;
  node_boxes_kernel<<<(ni + 1 + threads - 1) / threads, threads, 0,
                      stream>>>(d, ni, root, child, parent, leaf_min,
                                leaf_max, arrive, nbox, root_box);
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

// ---------------------------------------------------------------------------
// Sweep-SAH priorities (top_sah): the stack walk in one block
// ---------------------------------------------------------------------------
//
// The TPU kernel (_sweep_sah_kernel) is serial on the scalar core: pop a
// block range, sweep it backwards for the suffix SA of every split, then
// forwards for the prefix SA and the cost's argmin, emit the split and
// push both halves. Which splits survive the maxn cap depends on the stack
// order, so the walk stays serial here too, but each range's two passes
// run across the block: a block-wide scan of box unions (min and max,
// exact in any order) gives the suffix and the prefix boxes, and a
// block-wide argmin that keeps the smallest j picks the split, as the
// serial strict '<' does. SA and cost are rounded as the JAX package's
// kernel is under XLA's CPU compiler: SA = fma(dz, dx, fma(dx, dy, dy dz)),
// cost = fma(SA(j+1..b), b - j, SA(a..j) (j - a + 1)), with explicit fmas
// (the file builds with --fmad=false). Bound by latency: about 2 maxn
// dependent range steps, each a few block barriers; the bytes (the block
// boxes, nb x 24) and the operations (about 40 per block per split range)
// are small.

constexpr int SWEEP_THREADS = 256;
constexpr int SWEEP_WARPS = SWEEP_THREADS / 32;
constexpr float SWEEP_BIG = 3.4e38f;

struct Box6 {
  float lx, ly, lz, hx, hy, hz;
};

__device__ __forceinline__ Box6 box_empty() {
  return Box6{SWEEP_BIG, SWEEP_BIG, SWEEP_BIG,
              -SWEEP_BIG, -SWEEP_BIG, -SWEEP_BIG};
}

__device__ __forceinline__ Box6 box_union(const Box6& a, const Box6& b) {
  return Box6{fminf(a.lx, b.lx), fminf(a.ly, b.ly), fminf(a.lz, b.lz),
              fmaxf(a.hx, b.hx), fmaxf(a.hy, b.hy), fmaxf(a.hz, b.hz)};
}

__device__ __forceinline__ Box6 box_shfl_up(const Box6& v, int o) {
  return Box6{__shfl_up_sync(0xffffffffu, v.lx, o),
              __shfl_up_sync(0xffffffffu, v.ly, o),
              __shfl_up_sync(0xffffffffu, v.lz, o),
              __shfl_up_sync(0xffffffffu, v.hx, o),
              __shfl_up_sync(0xffffffffu, v.hy, o),
              __shfl_up_sync(0xffffffffu, v.hz, o)};
}

__device__ __forceinline__ float sweep_sa(const Box6& v) {
  float dx = fmaxf(v.hx - v.lx, 0.0f);
  float dy = fmaxf(v.hy - v.ly, 0.0f);
  float dz = fmaxf(v.hz - v.lz, 0.0f);
  return __fmaf_rn(dz, dx, __fmaf_rn(dx, dy, dy * dz));
}

// Inclusive union scan of v over the block in thread order; *total gets
// the union of the whole block. Every thread of the block must call it.
__device__ Box6 block_scan_box(Box6 v, Box6* total) {
  __shared__ Box6 warp_box[SWEEP_WARPS];
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    Box6 y = box_shfl_up(v, o);
    if (lane >= o) v = box_union(v, y);
  }
  if (lane == 31) warp_box[warp] = v;
  __syncthreads();
  if (warp == 0) {
    Box6 w = lane < SWEEP_WARPS ? warp_box[lane] : box_empty();
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      Box6 y = box_shfl_up(w, o);
      if (lane >= o) w = box_union(w, y);
    }
    if (lane < SWEEP_WARPS) warp_box[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = box_union(warp_box[warp - 1], v);
  *total = warp_box[SWEEP_WARPS - 1];
  __syncthreads();
  return v;
}

// (c, j) of the block's smallest c, the smallest j among equal ones, on
// every thread. Every thread of the block must call it.
__device__ void block_argmin(float& c, int& j) {
  __shared__ float warp_c[SWEEP_WARPS];
  __shared__ int warp_j[SWEEP_WARPS];
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float oc = __shfl_down_sync(0xffffffffu, c, o);
    int oj = __shfl_down_sync(0xffffffffu, j, o);
    if (oc < c || (oc == c && oj < j)) {
      c = oc;
      j = oj;
    }
  }
  if (lane == 0) {
    warp_c[warp] = c;
    warp_j[warp] = j;
  }
  __syncthreads();
  if (warp == 0) {
    c = lane < SWEEP_WARPS ? warp_c[lane] : __int_as_float(0x7f800000);
    j = lane < SWEEP_WARPS ? warp_j[lane] : 0x7fffffff;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      float oc = __shfl_down_sync(0xffffffffu, c, o);
      int oj = __shfl_down_sync(0xffffffffu, j, o);
      if (oc < c || (oc == c && oj < j)) {
        c = oc;
        j = oj;
      }
    }
    if (lane == 0) {
      warp_c[0] = c;
      warp_j[0] = j;
    }
  }
  __syncthreads();
  c = warp_c[0];
  j = warp_j[0];
  __syncthreads();
}

__device__ __forceinline__ Box6 load_box(const float* __restrict__ bx,
                                         int j) {
  const float* p = bx + 6 * static_cast<long long>(j);
  return Box6{p[0], p[1], p[2], p[3], p[4], p[5]};
}

// bx: f32[nb * 6] block boxes; suffix: f32[nb] scratch (SA of the box of
// blocks j..b of the current range); stack: i32[3 (maxn + 2)] scratch
// (a, b, depth per entry); gaps, ranks: i32[maxn], unused slots (ni, 0).
__global__ void __launch_bounds__(SWEEP_THREADS)
sweep_sah_kernel(const float* __restrict__ bx, int nb, int ni, int block,
                 int maxd, int min_blocks, int maxn,
                 float* __restrict__ suffix, int* __restrict__ stack,
                 int* __restrict__ gaps, int* __restrict__ ranks) {
  const float inf = __int_as_float(0x7f800000);
  const int tid = threadIdx.x;
  for (int i = tid; i < maxn; i += SWEEP_THREADS) {
    gaps[i] = ni;
    ranks[i] = 0;
  }
  if (tid == 0) {
    stack[0] = 0;
    stack[1] = nb - 1;
    stack[2] = 0;
  }
  __syncthreads();
  // Every thread keeps sp and nout: they change alike on every thread.
  int sp = 1, nout = 0;
  while (sp > 0) {
    --sp;
    int a = stack[3 * sp], b = stack[3 * sp + 1], dep = stack[3 * sp + 2];
    __syncthreads();  // thread 0 overwrites these entries below
    if (!(b - a + 1 > min_blocks && dep < maxd && nout < maxn)) continue;
    // Backward: suffix[j] = SA(blocks j..b) for j in (a, b], in chunks from
    // the end, thread t at j = hi - t.
    Box6 carry = box_empty(), total;
    for (int hi = b; hi > a; hi -= SWEEP_THREADS) {
      int j = hi - tid;
      bool in = j > a;
      Box6 v = block_scan_box(in ? load_box(bx, j) : box_empty(), &total);
      v = box_union(v, carry);
      carry = box_union(carry, total);
      if (in) suffix[j] = sweep_sa(v);
    }
    __syncthreads();
    // Forward: prefix boxes of blocks a..j for j in [a, b), the cost of the
    // split after j, and its first minimum.
    carry = box_empty();
    float best = inf;
    int bj = 0x7fffffff;
    for (int lo = a; lo < b; lo += SWEEP_THREADS) {
      int j = lo + tid;
      bool in = j < b;
      Box6 v = block_scan_box(in ? load_box(bx, j) : box_empty(), &total);
      v = box_union(v, carry);
      carry = box_union(carry, total);
      float c = inf;
      int cj = 0x7fffffff;
      if (in) {
        float nl = static_cast<float>(j - a + 1);
        float nr = static_cast<float>(b - j);
        float cost = __fmaf_rn(suffix[j + 1], nr, sweep_sa(v) * nl);
        if (cost < SWEEP_BIG) {
          c = cost;
          cj = j;
        }
      }
      block_argmin(c, cj);
      if (c < best) {  // an earlier chunk keeps a tie
        best = c;
        bj = cj;
      }
    }
    if (!(best < inf)) bj = a;
    if (tid == 0) {
      gaps[nout] = (bj + 1) * block - 1;
      ranks[nout] = dep;
      stack[3 * sp] = a;
      stack[3 * sp + 1] = bj;
      stack[3 * sp + 2] = dep + 1;
      stack[3 * sp + 3] = bj + 1;
      stack[3 * sp + 4] = b;
      stack[3 * sp + 5] = dep + 1;
    }
    sp += 2;
    ++nout;
    __syncthreads();
  }
}

extern "C" int tpurt_sweep_sah_launch(const float* bx, int nb, int ni,
                                      int block, int maxd, int min_blocks,
                                      int maxn, float* suffix, int* stack,
                                      int* gaps, int* ranks,
                                      cudaStream_t stream) {
  if (nb > 0) {
    sweep_sah_kernel<<<1, SWEEP_THREADS, 0, stream>>>(
        bx, nb, ni, block, maxd, min_blocks, maxn, suffix, stack, gaps,
        ranks);
  }
  return static_cast<int>(cudaGetLastError());
}
