// Standalone shadow rays over an 8-wide BVH, for Hopper: the unfused shadow
// pass's kernels, one template, three modes, each replacing one TPU kernel
// of tpurt/kernels/traverse.py:
//
//   ANY        _any_hit_kernel_w8_b       any hit in (t_min, t_max) of given
//                                         rays -> i32 0/1
//   ANY_SOFT   _any_hit_kernel_w8_soft    spp cone samples around the sun
//                                         axis from given origins -> counts
//   ANY_PSOFT  _any_hit_kernel_w8_psoft   spp jittered-disk samples on a
//                                         point light from given origins
//                                         -> counts
//
// Their plain PyTorch versions are any_reference, any_soft_reference and
// any_point_soft_reference in tpurt_torch/kernels/traverse.py. The
// contract, with Params (walk.cuh) as fused_shadows.cu takes it:
//
//   rays    ANY: f32[PB,10,8,128]  o.xyz, d.xyz, clamped 1/d.xyz, t_max;
//                a ray with t_max <= t_min is inactive
//           ANY_SOFT, ANY_PSOFT: f32[PB,4,8,128]  biased origin xyz and a
//                valid flag (> 0); an invalid ray walks with t = -BIG
//   scal    ANY_SOFT: f32[16] axis(3), t0(3), t1(3), cone_cos, root min(3),
//                root max(3); ANY_PSOFT: f32[4] position(3), radius
//   nodes, tris, counts: as in fused_shadows.cu (no attribute rows)
//   out     i32[PB,8,128]  occlusion (mask_out) or counts in [0, spp]
//           (cnt_out)
//
// Design: the walk and the samplers of the fused kernels (walk.cuh), one
// thread per ray, blocks of 128 threads, a per-ray stack in local memory.
// The soft modes draw u1, u2 from Philox4x32-10 keyed by (seed, light) and
// counted by (ray index in the packed block, sample); with light 0 they
// draw exactly the samples of the fused SOFT and PSOFT modes for the same
// rays. zero_stream gives u1 = u2 = 0, the JAX kernels' interpret mode.
//
// What bounds it on this card: as for the fused kernels, the dependent
// loads and the divergence of the walks, not bytes or FLOPs; the soft
// modes read one 16-byte origin per ray and walk spp times from it. The
// float work of the slab and triangle tests is the bound PERF.md states.
// Built with --fmad=false, as fused_shadows.cu.

#include "walk.cuh"

enum Mode { ANY = 0, ANY_SOFT = 1, ANY_PSOFT = 2 };

template <int MODE>
__global__ void __launch_bounds__(128) shadow_rays_kernel(Params P) {
  int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= P.num_rays) return;
  int p = gid / LANES, lane = gid % LANES;
  int stack[STACK_CAPACITY];
  WalkCounts wc;
  if (MODE == ANY) {
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
    P.mask_out[gid] = anyhit_walk(P.nodes, P.tris, P.k, r, rb[9 * LANES],
                                  P.t_min, P.max_iters, P.stack_size, stack,
                                  wc);
  } else {
    const float* rb = P.rays + (size_t)p * 4 * LANES + lane;
    Ray s;
    s.ox = rb[0];
    s.oy = rb[LANES];
    s.oz = rb[2 * LANES];
    s.dx = s.dy = s.dz = s.ix = s.iy = s.iz = 0.0f;
    bool valid = rb[3 * LANES] > 0.0f;
    const float* sc = P.scal;
    Disk db = {};
    if (MODE == ANY_PSOFT) db = disk_basis(sc, sc[3], s);
    int cnt = 0;
    for (int i = 0; i < P.spp; ++i) {
      float u1, u2;
      sample_u1u2(P.seed, P.light, P.zero_stream, (uint32_t)gid, (uint32_t)i,
                  u1, u2);
      float stmax = MODE == ANY_PSOFT
                        ? disk_sample(db, u1, u2, valid, s)
                        : cone_sample(sc, sc[9], u1, u2, valid, sc + 10, s);
      cnt += anyhit_walk(P.nodes, P.tris, P.k, s, stmax, P.t_min,
                         P.max_iters, P.stack_size, stack, wc);
    }
    P.cnt_out[gid] = cnt;
  }
  if (wc.overflow) atomicAdd(P.counts, wc.overflow);
  if (wc.capped) atomicAdd(P.counts + 1, wc.capped);
}

// Launches ``mode`` on ``stream`` with the arguments in *P; allocates
// nothing and returns cudaGetLastError() (cudaErrorInvalidValue for an
// unknown mode).
extern "C" int tpurt_shadow_rays_launch(int mode, const Params* P,
                                        void* stream) {
  if (P->num_rays <= 0) return (int)cudaGetLastError();
  dim3 block(128);
  dim3 grid((P->num_rays + 127) / 128);
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case ANY:
      shadow_rays_kernel<ANY><<<grid, block, 0, st>>>(*P);
      break;
    case ANY_SOFT:
      shadow_rays_kernel<ANY_SOFT><<<grid, block, 0, st>>>(*P);
      break;
    case ANY_PSOFT:
      shadow_rays_kernel<ANY_PSOFT><<<grid, block, 0, st>>>(*P);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
