// Walks over the packed binary LBVH, for Hopper: one template, two modes,
// each replacing one TPU kernel of tpurt/kernels/traverse.py (reached
// through _common_call :2476 with bvh_width=2, or a plain build_lbvh tree
// handed to render_frame_fn):
//
//   BIN_CLOSEST  _closest_hit_kernel (:287)  closest hit in (t_min, t_max)
//                                            -> t f32 (BIG on a miss) and
//                                            the sorted index i32 (-1)
//   BIN_ANY      _any_hit_kernel (:222)      any hit in (t_min, t_max)
//                                            -> i32 0/1
//
// Their plain PyTorch versions are binary_closest_reference and
// binary_any_reference in tpurt_torch/kernels/traverse.py. The contract,
// with Params (walk.cuh) as the other walk kernels take it:
//
//   rays    f32[PB,10,8,128]  o.xyz, d.xyz, clamped 1/d.xyz, t_max; a ray
//           with t_max <= t_min is inactive (the clamped 1/d equals the
//           TPU kernels' in-kernel _inv3 bit for bit)
//   nodes   f32[Nr,128]  8 node records per row (tpurt_torch/kernels/
//           pack.py): [Lmin.xyz, Lmax.xyz, Rmin.xyz, Rmax.xyz, childL,
//           childR, 0, 0], child refs float values (>= 0 internal, < 0 a
//           leaf as -(leaf+1))
//   tris    f32[L,128]  one leaf per row, k x (v0, e1, e2)
//   out, sidx_out (BIN_CLOSEST) or mask_out (BIN_ANY): [PB,8,128]
//   counts  i32[2]  pushes dropped on a full stack, walks cut at the
//           iteration cap (2 * num_internal + 64)
//
// The walk, per ray: pop a node, slab-test both child boxes (against the
// running best t for BIN_CLOSEST, t_max for BIN_ANY), visit the left child
// and then the right; a leaf is tested when visited and never pushed, an
// internal child is pushed (the right one pops first). BIN_ANY stops at
// the first occluder. The TPU kernels walk a packet of 1024 rays with one
// shared stack; here each thread walks its own ray with its own stack in
// local memory, which visits a subset of the packet's nodes in the same
// order, so the answers agree (ties aside: decision 2 in ROADMAP.md).
//
// Design: one thread per ray, blocks of 128 threads. A node record is 64
// bytes, read as four 16-byte loads through the read-only cache (the
// TPU kernel's vector select of the record in its row has no counterpart:
// the record's address is computed). The leaf tests are walk.cuh's
// leaf_closest (no attributes tracked) and leaf_occluded.
//
// What bounds it on this card: a binary walk pops about seven times the
// nodes of the 8-wide walk and each pop is a dependent 64-byte load, so
// the latency of the pointer chase and the divergence of the walks bound
// it, not bytes or FLOPs. The float work of the slab and triangle tests
// (2 x 25 per pop, 56 per triangle) is the bound PERF.md states. Built
// with --fmad=false, as every walk, so it agrees with the plain version
// bit for bit.

#include "walk.cuh"

enum Mode { BIN_CLOSEST = 0, BIN_ANY = 1 };

// Pop-side work of one node: both boxes against ``cap``; bit 0 left hit,
// bit 1 right hit; the child refs in ``refs``.
__device__ __forceinline__ unsigned node_hits(const float4* __restrict__ rec,
                                              const Ray& r, float t_min,
                                              float cap, int refs[2]) {
  float4 a = __ldg(rec);       // Lmin.xyz, Lmax.x
  float4 b = __ldg(rec + 1);   // Lmax.yz, Rmin.xy
  float4 c = __ldg(rec + 2);   // Rmin.z, Rmax.xyz
  float4 e = __ldg(rec + 3);   // childL, childR, 0, 0
  refs[0] = (int)e.x;
  refs[1] = (int)e.y;
  unsigned mask = 0;
  if (slab_box(a.x, a.y, a.z, a.w, b.x, b.y, r, t_min, cap)) mask |= 1u;
  if (slab_box(b.z, b.w, c.x, c.y, c.z, c.w, r, t_min, cap)) mask |= 2u;
  return mask;
}

template <int MODE>
__global__ void __launch_bounds__(128) binary_kernel(Params P) {
  int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= P.num_rays) return;
  int p = gid / LANES, lane = gid % LANES;
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
  float tmax = rb[9 * LANES];
  bool active0 = tmax > P.t_min;
  const float4* nodes = reinterpret_cast<const float4*>(P.nodes);
  int stack[STACK_CAPACITY];
  WalkCounts wc;
  int sp = 1, it = 0;
  stack[0] = 0;
  if (MODE == BIN_CLOSEST) {
    Hit h;
    h.t = active0 ? tmax : -BIG;
    h.idx = -1;
    h.u = h.v = h.kd = h.tid = h.o0 = h.o1 = h.o2 = 0.0f;
    h.nx = h.ny = h.nz = 0.0f;
    while (sp > 0 && it < P.max_iters) {
      int refs[2];
      unsigned mask = node_hits(nodes + (size_t)stack[--sp] * 4, r, P.t_min,
                                active0 ? h.t : -BIG, refs);
      for (int c = 0; c < 2; ++c) {
        if (!(mask >> c & 1u)) continue;
        int ref = refs[c];
        if (ref < 0) {
          leaf_closest<TRACK_T>(P.tris, nullptr, nullptr, max(-ref - 1, 0),
                                P.k, r, P.t_min, active0, h);
        } else if (sp < P.stack_size) {
          stack[sp++] = ref;
        } else {
          ++wc.overflow;
        }
      }
      ++it;
    }
    wc.capped += sp > 0;
    write_hit(P.out, P.sidx_out, gid, h);
  } else {
    bool occ = false;
    while (sp > 0 && it < P.max_iters && !occ) {
      int refs[2];
      unsigned mask = node_hits(nodes + (size_t)stack[--sp] * 4, r, P.t_min,
                                active0 ? tmax : -BIG, refs);
      for (int c = 0; c < 2; ++c) {
        if (!(mask >> c & 1u)) continue;
        int ref = refs[c];
        if (ref < 0) {
          if (leaf_occluded(P.tris, max(-ref - 1, 0), P.k, r, P.t_min,
                            tmax)) {
            occ = true;
            break;
          }
        } else if (sp < P.stack_size) {
          stack[sp++] = ref;
        } else {
          ++wc.overflow;
        }
      }
      ++it;
    }
    wc.capped += (!occ && sp > 0);
    P.mask_out[gid] = occ ? 1 : 0;
  }
  if (wc.overflow) atomicAdd(P.counts, wc.overflow);
  if (wc.capped) atomicAdd(P.counts + 1, wc.capped);
}

// Launches ``mode`` on ``stream`` with the arguments in *P; allocates
// nothing and returns cudaGetLastError() (cudaErrorInvalidValue for an
// unknown mode).
extern "C" int tpurt_binary_launch(int mode, const Params* P, void* stream) {
  if (P->num_rays <= 0) return (int)cudaGetLastError();
  dim3 block(128);
  dim3 grid((P->num_rays + 127) / 128);
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case BIN_CLOSEST:
      binary_kernel<BIN_CLOSEST><<<grid, block, 0, st>>>(*P);
      break;
    case BIN_ANY:
      binary_kernel<BIN_ANY><<<grid, block, 0, st>>>(*P);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
