// The w8t walks over a WideBVHT (row-layout 8-wide nodes, transposed leaf
// triangles), for Hopper: one template, two modes and three variants,
// replacing the three transposed-leaf TPU kernels of
// tpurt/kernels/traverse.py (reached through _common_call_t :2302 and
// _attr_call_t :2259 from trace_any_pallas, trace_closest_pallas and
// trace_closest_attrs_pallas_t on a WideBVHT):
//
//   W8T_ANY               _any_hit_kernel_w8t (:1910)   any hit in
//                                                       (t_min, t_max)
//                                                       -> i32 0/1
//   W8T_CLOSEST attrs=0   _closest_hit_kernel_w8t       closest hit -> t
//                         (:1973)                       f32 (BIG on a miss)
//                                                       and the sorted
//                                                       index i32 (-1)
//   W8T_CLOSEST attrs=1   _closest_attr_kernel_w8t_b    closest hit and its
//               and 2     (:2238, textured False and    15 attribute
//                         True)                         channels
//
// Their plain PyTorch versions are w8t_any_reference, w8t_closest_reference
// and w8t_closest_attrs_reference in tpurt_torch/kernels/traverse.py. The
// contract, with Params (walk.cuh) as the other walk kernels take it:
//
//   rays     f32[PB,10,8,128]  o.xyz, d.xyz, clamped 1/d.xyz, t_max; a
//            ray with t_max <= t_min is inactive
//   nodes    f32[Nw,128]   8 children x [bmin.xyz, bmax.xyz, ref, pad]
//   tris     f32[nblk,8,128]  the transposed leaf blocks, P.k = 8 (14
//            leaves a block) or 16 (7): field f of triangle 8h + t of leaf
//            j at [blk, t, 9 (k/8) j + 9h + f]
//   at0/at1  f32[nblk,8,128]  the transposed attribute rows at the same
//            addresses: at0 n0, n1, n2 (packed oct), kd, the original
//            triangle id, layer, uv0.u, uv0.v; at1 d1.u, d1.v, d2.u, d2.v
//            (read with attrs=2 only)
//   out      attrs=1, 2: f32[PB,15,8,128] t, sidx, u, v, uv(2), kd, layer,
//            tri_id, packed oct n0..n2, geometric normal; attrs=1 writes
//            uv 0 and the layer -1 on every ray (the w8t kernel's lay0,
//            where the row kernel writes 0); attrs=0: t f32[PB,8,128] and
//            sidx_out i32[PB,8,128]
//   mask_out i32[PB,8,128]  W8T_ANY's occlusion
//   counts   i32[2]  pushes dropped on a full stack, walks cut at the
//            iteration cap (2 * num_wide + 64)
//
// Design: one thread per ray, blocks of 128 threads, its own 256-entry
// stack in local memory. The node walk is walk.cuh's closest_walk and
// anyhit_walk (slab tests against the running cap, children in slot
// order, leaves tested in place, internal children pushed); only the leaf
// test and its addressing differ (walk.cuh leaf_closest_t,
// leaf_occluded_t, t_offset). The TPU kernels put the 8 triangles of a
// group in the sublanes so that one (8, 128) operation tests 8 triangles
// against 128 rays, and align a leaf with lane rolls and one-hot sublane
// sums; a thread here reads each triangle's nine consecutive words
// directly, and the winner's attributes at the same address once per
// improving hit. The 1024-ray packet with one shared stack and its exit
// every 4 iterations do not carry over: each ray walks the boxes it hits
// itself and stops at its own first occluder, which gives the same
// answers (ties aside: decision 2 in ROADMAP.md). At k = 8 the closest
// hit tests the same triangles in the same order as mode NEAREST of
// fused_shadows.cu on the row layout of the same tree, so the two agree
// bit for bit in t and the sorted index.
//
// What bounds it on this card: as the row-layout walks, the latency of
// the dependent node loads and the divergence of the walks; the float work
// of the slab and triangle tests (25 per slab test, 56 per triangle, k
// triangles a visited leaf for the closest hit) is the bound PERF.md
// states. A leaf's triangles now span up to eight 128-word rows of a
// block instead of one row, so a leaf test touches more cache lines. Built
// with --fmad=false, as every walk, so it agrees with the plain version bit
// for bit.

#include "walk.cuh"

enum Mode { W8T_ANY = 0, W8T_CLOSEST = 1 };

template <int MODE, int TK, int ATTRS>
__global__ void __launch_bounds__(128) transposed_kernel(Params P) {
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

  int stack[STACK_CAPACITY];
  WalkCounts wc;
  if constexpr (MODE == W8T_ANY) {
    P.mask_out[gid] = anyhit_walk<TK>(P.nodes, P.tris, TK, r, tmax, P.t_min,
                                      P.max_iters, P.stack_size, stack, wc);
  } else {
    constexpr int TRACK = ATTRS == 2 ? TRACK_TEX
                          : ATTRS ? TRACK_ATTRS
                                  : TRACK_T;
    Hit h = closest_walk<TRACK, false, TK>(P.nodes, P.tris, P.at0, P.at1,
                                           TK, r, tmax, P.t_min, P.max_iters,
                                           P.stack_size, stack, wc);
    if constexpr (ATTRS)
      write_attrs(P.out, p, lane, h);
    else
      write_hit(P.out, P.sidx_out, gid, h);
  }
  if (wc.overflow) atomicAdd(P.counts, wc.overflow);
  if (wc.capped) atomicAdd(P.counts + 1, wc.capped);
}

template <int TK>
static int launch_leaf(int mode, const Params* P, dim3 grid, dim3 block,
                       cudaStream_t st) {
  if (mode == W8T_ANY) {
    if (P->attrs) return (int)cudaErrorInvalidValue;
    transposed_kernel<W8T_ANY, TK, 0><<<grid, block, 0, st>>>(*P);
  } else if (mode == W8T_CLOSEST) {
    if (P->attrs == 2)
      transposed_kernel<W8T_CLOSEST, TK, 2><<<grid, block, 0, st>>>(*P);
    else if (P->attrs == 1)
      transposed_kernel<W8T_CLOSEST, TK, 1><<<grid, block, 0, st>>>(*P);
    else
      transposed_kernel<W8T_CLOSEST, TK, 0><<<grid, block, 0, st>>>(*P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Launches ``mode`` in the variant P->attrs (0, 1 or 2; W8T_ANY only 0) at
// leaf size P->k (8 or 16) on ``stream`` with the arguments in *P;
// allocates nothing and returns cudaGetLastError() (cudaErrorInvalidValue
// for an unknown mode, variant or leaf size).
extern "C" int tpurt_transposed_launch(int mode, const Params* P,
                                       void* stream) {
  if (P->attrs < 0 || P->attrs > 2) return (int)cudaErrorInvalidValue;
  if (P->num_rays <= 0) return (int)cudaGetLastError();
  dim3 block(128);
  dim3 grid((P->num_rays + 127) / 128);
  cudaStream_t st = (cudaStream_t)stream;
  switch (P->k) {
    case 8:
      return launch_leaf<8>(mode, P, grid, block, st);
    case 16:
      return launch_leaf<16>(mode, P, grid, block, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
