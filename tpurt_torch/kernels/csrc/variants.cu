// The per-packet stats walk over an 8-wide BVH, for Hopper: mode
// ANY_STATS replaces tpurt/kernels/_variants.py _any_hit_kernel_w8_stats
// (:37, reached by trace_any_pallas_stats :347), the any hit of given rays
// plus the iterations of each 1024-ray packet's shared walk. Its plain
// PyTorch version is any_stats_reference in
// tpurt_torch/kernels/_variants.py. The contract, with Params (walk.cuh):
//
//   rays      f32[PB,10,8,128]  o.xyz, d.xyz, clamped 1/d.xyz, t_max; a
//             ray with t_max <= t_min is inactive
//   nodes, tris, counts: as in shadow_rays.cu
//   mask_out  i32[PB,8,128]  occlusion 0/1
//   cnt_out   i32[PB,8,128]  the packet's iterations on its every lane
//
// The walk (ROADMAP decision 22) is the TPU kernel's, whose packet shares
// one stack: the root is pushed; the loop runs only if some ray of the
// packet is active; an iteration pops the top node, slab-tests its eight
// child boxes for the rays live at its start (active, not occluded), and
// for each slot that some live ray hits (min x <= max x), in slot order
// 0..7, tests a leaf for every active ray or pushes an internal child;
// after the body of every 4th iteration the packet stops if no ray is
// live; the stack empties or the cap max_iters ends it. Pushes past
// stack_size are dropped and counted, a walk cut at the cap with live
// rays counts as capped.
//
// Design: one block of 1024 threads per packet, a thread per ray. The
// stack lives in shared memory and every thread holds the same stack
// pointer, iteration count and liveness (the loop's condition is uniform
// across the block). A child's packet-wide vote is a warp OR of each
// ray's 8-bit hit mask (__reduce_or_sync), one shared atomicOr a warp
// into a vote word and one __syncthreads; the vote words rotate over
// three slots, so the word an iteration reads is never reset or written
// before every thread has read it. Every thread then writes the same
// pushes into the shared stack: a pop reads only entries its own thread
// wrote last, after the barrier that ends the iteration that wrote them.
// The liveness vote is __syncthreads_or. A ray that is inactive or
// already occluded skips the leaf test, whose OR could not change it.
//
// What bounds it on this card: the packet's serial walk, one barrier per
// iteration and one more every 4th, and the leaf tests of every active
// ray of the packet; the float work the bound counts is the slab tests of
// the live rays and the triangle tests of the rays that test a leaf, as
// the kernel does them (PERF.md). Built with --fmad=false:
// the slab test has no product to contract, the triangle test keeps the
// plain version's order, so both agree bit for bit.

#include "walk.cuh"

enum Mode { ANY_STATS = 0 };

#define LIVENESS_PERIOD 4

__global__ void __launch_bounds__(LANES) any_stats_kernel(Params P) {
  __shared__ int stack[STACK_CAPACITY];
  __shared__ unsigned vote[3];
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  const float* rb = P.rays + (size_t)p * 10 * LANES + lane;
  Ray r;
  r.ox = rb[0];
  r.oy = rb[LANES];
  r.oz = rb[2 * LANES];
  r.dx = rb[3 * LANES];
  r.dy = rb[4 * LANES];
  r.dz = rb[5 * LANES];
  r.ix = rb[6 * LANES];
  r.iy = rb[7 * LANES];
  r.iz = rb[8 * LANES];
  const float tmax = rb[9 * LANES];
  const bool active0 = tmax > P.t_min;
  bool occ = false;
  if (lane < 3) vote[lane] = 0u;
  if (lane == 0) stack[0] = 0;
  int sp = 1, it = 0, overflow = 0;
  bool alive = __syncthreads_or(active0) != 0;
  while (sp > 0 && it < P.max_iters && alive) {
    const float* row = P.nodes + (size_t)stack[--sp] * 128;
    const bool live = active0 && !occ;
    unsigned m = live ? child_hits(row, r, P.t_min, tmax) : 0u;
    m = __reduce_or_sync(0xffffffffu, m);
    const int slot = it % 3;
    if ((lane & 31) == 0 && m) atomicOr(&vote[slot], m);
    if (lane == 0) vote[(it + 1) % 3] = 0u;
    __syncthreads();
    const unsigned votes = vote[slot];
    for (int c = 0; c < 8; ++c) {
      if (!(votes >> c & 1u)) continue;
      int ref = (int)__ldg(row + 16 * c + 6);
      if (ref < 0) {
        if (active0 && !occ) {
          occ = leaf_occluded(P.tris, max(-ref - 1, 0), P.k, r, P.t_min,
                              tmax);
        }
      } else if (sp < P.stack_size) {
        stack[sp++] = ref;
      } else {
        ++overflow;
      }
    }
    if ((it & (LIVENESS_PERIOD - 1)) == LIVENESS_PERIOD - 1) {
      alive = __syncthreads_or(active0 && !occ) != 0;
    }
    ++it;
  }
  const size_t gid = (size_t)p * LANES + lane;
  P.mask_out[gid] = occ ? 1 : 0;
  P.cnt_out[gid] = it;
  if (lane == 0) {
    if (overflow) atomicAdd(P.counts, overflow);
    if (sp > 0 && alive) atomicAdd(P.counts + 1, 1);
  }
}

// Launches ``mode`` on ``stream`` with the arguments in *P; one block per
// packet of P->num_rays / 1024. Allocates nothing and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unknown mode).
extern "C" int tpurt_variants_launch(int mode, const Params* P,
                                     void* stream) {
  if (P->num_rays <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case ANY_STATS:
      any_stats_kernel<<<P->num_rays / LANES, LANES, 0, st>>>(*P);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
