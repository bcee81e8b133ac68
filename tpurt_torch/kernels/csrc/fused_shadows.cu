// Closest hit, alone or fused with shadows, over an 8-wide BVH, for
// Hopper: one kernel template, six modes, each replacing one TPU kernel of
// tpurt/kernels/traverse.py in its attrs=1 variant (attribute tracking, no
// textures):
//
//   HARD        _closest_shadow_kernel_w8_b         light 0's hard shadow,
//                                                   directional or point
//                                                   -> i32 0/1
//   MULTI       _closest_multi_shadow_kernel_w8_b   one hard walk per light
//                                                   -> i32 bitmask
//   SOFT        _closest_soft_shadow_kernel_w8_b    spp cone samples around
//                                                   the sun axis -> counts
//   PSOFT       _closest_psoft_shadow_kernel_w8_b   spp jittered-disk samples
//                                                   on a point light -> counts
//   SOFT_MULTI  _closest_soft_multi_shadow_kernel_w8_b  light 0 soft (cone or
//                                                   disk) -> counts; hard
//                                                   directional extras -> mask
//   CLOSEST     _closest_attr_kernel_w8_b           the closest hit and its
//                                                   attributes alone (the
//                                                   unfused G-buffer)
//
// Their plain PyTorch versions are closest_{,multi_,soft_,point_soft_,
// soft_multi_}shadow_reference and closest_attrs_reference in
// tpurt_torch/kernels/traverse.py. All follow one contract:
//
//   rays    f32[PB,10,8,128]  o.xyz, d.xyz, clamped 1/d.xyz, t_max (SoA)
//   nodes   f32[Nw,128]       8 children x [bmin.xyz, bmax.xyz, ref, pad]
//   tris    f32[L,128]        k x (v0, e1, e2) per leaf
//   at0/at1 f32[L,128]        leaf attribute rows (at1 read only if k > 8)
//   out     f32[PB,15,8,128]  t, sidx, u, v, uv(2), kd, layer, tri_id,
//                             packed oct n0..n2, geometric normal
//   counts  i32[2]            stack overflows, walks cut at the cap
//
// with the JAX wrappers' scalar blocks:
//
//   HARD        f32[13] dir(3), clamped 1/dir(3), bias, root min(3),
//               root max(3); or (point_mask 1) f32[4] position(3), bias
//   MULTI       [bias, root min(3), root max(3)], then per light a
//               position(3) (bit l of point_mask) or dir(3) + clamped 1/dir(3)
//   SOFT        f32[17] axis(3), t0(3), t1(3), cone_cos, root min(3),
//               root max(3), bias
//   PSOFT       f32[5] position(3), radius, bias
//   SOFT_MULTI  [bias, root min(3), root max(3)], light 0 (disk: position(3),
//               radius; cone: axis(3), t0(3), t1(3), cone_cos), then per
//               extra light dir(3) + clamped 1/dir(3)
//   CLOSEST     none
//
// and i32[PB,8,128] outputs: mask (bit l = light l occluded; SOFT_MULTI:
// bit i = extra light i) and/or counts in [0, spp].
//
// Design: one thread per ray, blocks of 128 threads. The ray index is
// (packet, lane), so neighbouring threads read neighbouring words of the
// SoA ray block. Phase 1 is the attribute-tracked closest walk (all that
// CLOSEST runs); phase 2 runs every light or sample in the same thread,
// from the same biased hit point, reusing the per-ray stack in local
// memory; each shadow walk has its own iteration cap, and dropped pushes
// and capped walks of all walks are summed into counts (the walks are in
// walk.cuh). Nodes, leaves and attribute rows are read from global memory
// through the read-only path.
// The soft modes draw u1, u2 from Philox4x32-10 keyed by (seed, light 0)
// and counted by (ray index in the packed block, sample), so a sample
// never depends on the thread layout; zero_stream gives u1 = u2 = 0, the
// stream of the JAX kernels' interpret mode.
//
// What bounds it on this card: each walk is a chain of dependent global
// loads (pop -> node row -> slab tests -> push) with divergent trip counts
// within a warp, so latency and divergence rather than bandwidth or FLOPs.
// The float work of the slab and triangle tests gives the operation bound
// that PERF.md states; it grows with the number of shadow walks while the
// bytes (rays in, channels out) do not. The walk's data for a 287k-
// triangle scene (5.8 MB of node rows, 15.3 MB of leaf rows) fits the
// 50 MB L2; the attribute rows (another 30.7 MB) are read only when a
// candidate wins. This first version hides latency only by occupancy and
// does nothing about the divergence between a ray's samples. The TPU
// kernels' 1024-ray packets with one shared stack and their "any lane hit"
// reductions are not carried over: each ray tests only the boxes it hits
// itself. A node cache in shared memory, warp-cooperative walks and
// sample-major scheduling are later work.
//
// Built with --fmad=false: every product is evaluated in the plain
// version's order without contraction, so the two agree bit for bit on
// most rays.

#include "walk.cuh"

enum Mode {
  HARD = 0,
  MULTI = 1,
  SOFT = 2,
  PSOFT = 3,
  SOFT_MULTI = 4,
  CLOSEST = 5
};

// Hard directional light at scal d[0..5] (dir, inverse).
__device__ __forceinline__ float dir_ray(const float* d, bool hitm,
                                         const float* rb, Ray& s) {
  s.dx = d[0];
  s.dy = d[1];
  s.dz = d[2];
  s.ix = d[3];
  s.iy = d[4];
  s.iz = d[5];
  return scene_exit_cap(hitm, s, rb);
}

// Hard point light at scal p[0..2].
__device__ __forceinline__ float point_ray(const float* p, bool hitm,
                                           Ray& s) {
  return toward(hitm, p[0] - s.ox, p[1] - s.oy, p[2] - s.oz, s);
}

// Phase 2 of the fused modes: light 0's shadow, every hard light, or light
// 0's samples (and the hard extras), from the biased hit point of ray gid.
template <int MODE>
__device__ __forceinline__ void shadow_phase(const Params& P, const Ray& r,
                                             const Hit& h, int gid,
                                             int* stack, WalkCounts& wc) {
  const float* sc = P.scal;
  bool hitm = h.idx >= 0;
  bool hard_point = MODE == HARD && (P.point_mask & 1);
  float bias = MODE == HARD ? sc[hard_point ? 3 : 6]
             : MODE == SOFT ? sc[16]
             : MODE == PSOFT ? sc[4] : sc[0];
  Ray s = biased_origin(r, h, bias);
  const float* root = MODE == HARD ? sc + 7 : MODE == SOFT ? sc + 10 : sc + 1;

  if (MODE == HARD) {
    float stmax = hard_point ? point_ray(sc, hitm, s)
                             : dir_ray(sc, hitm, root, s);
    P.mask_out[gid] = anyhit_walk(P.nodes, P.tris, P.k, s, stmax, 0.0f,
                                  P.max_iters, P.stack_size, stack, wc);
  } else if (MODE == MULTI) {
    int mask = 0, at = 7;
    for (int l = 0; l < P.nlights; ++l) {
      float stmax;
      if (P.point_mask >> l & 1) {
        stmax = point_ray(sc + at, hitm, s);
        at += 3;
      } else {
        stmax = dir_ray(sc + at, hitm, root, s);
        at += 6;
      }
      if (anyhit_walk(P.nodes, P.tris, P.k, s, stmax, 0.0f, P.max_iters,
                      P.stack_size, stack, wc))
        mask |= 1 << l;
    }
    P.mask_out[gid] = mask;
  } else {
    // Light 0's samples.
    bool disk = MODE == PSOFT || (MODE == SOFT_MULTI && P.disk);
    const float* l0 = MODE == SOFT_MULTI ? sc + 7 : sc;
    Disk db = {};
    if (disk) db = disk_basis(l0, l0[3], s);
    int cnt = 0;
    for (int i = 0; i < P.spp; ++i) {
      float u1, u2;
      sample_u1u2(P.seed, 0u, P.zero_stream, (uint32_t)gid, (uint32_t)i, u1,
                  u2);
      float stmax = disk ? disk_sample(db, u1, u2, hitm, s)
                         : cone_sample(l0, l0[9], u1, u2, hitm, root, s);
      cnt += anyhit_walk(P.nodes, P.tris, P.k, s, stmax, 0.0f, P.max_iters,
                         P.stack_size, stack, wc);
    }
    P.cnt_out[gid] = cnt;
    if (MODE == SOFT_MULTI) {
      const float* ex = sc + (P.disk ? 11 : 17);
      int mask = 0;
      for (int l = 0; l < P.n_extra; ++l) {
        float stmax = dir_ray(ex + 6 * l, hitm, root, s);
        if (anyhit_walk(P.nodes, P.tris, P.k, s, stmax, 0.0f, P.max_iters,
                        P.stack_size, stack, wc))
          mask |= 1 << l;
      }
      P.mask_out[gid] = mask;
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(128) fused_shadows_kernel(Params P) {
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
  Hit h = closest_walk(P.nodes, P.tris, P.at0, P.at1, P.k, r, tmax, P.t_min,
                       P.max_iters, P.stack_size, stack, wc);
  write_attrs(P.out, p, lane, h);
  if constexpr (MODE != CLOSEST)
    shadow_phase<MODE>(P, r, h, gid, stack, wc);
  if (wc.overflow) atomicAdd(P.counts, wc.overflow);
  if (wc.capped) atomicAdd(P.counts + 1, wc.capped);
}

extern "C" int tpurt_stack_capacity() { return STACK_CAPACITY; }

extern "C" int tpurt_params_size() { return (int)sizeof(Params); }

// Launches ``mode`` on ``stream`` with the arguments in *P; allocates
// nothing and returns cudaGetLastError() (cudaErrorInvalidValue for an
// unknown mode).
extern "C" int tpurt_fused_shadows_launch(int mode, const Params* P,
                                          void* stream) {
  if (P->num_rays <= 0) return (int)cudaGetLastError();
  dim3 block(128);
  dim3 grid((P->num_rays + 127) / 128);
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case HARD:
      fused_shadows_kernel<HARD><<<grid, block, 0, st>>>(*P);
      break;
    case MULTI:
      fused_shadows_kernel<MULTI><<<grid, block, 0, st>>>(*P);
      break;
    case SOFT:
      fused_shadows_kernel<SOFT><<<grid, block, 0, st>>>(*P);
      break;
    case PSOFT:
      fused_shadows_kernel<PSOFT><<<grid, block, 0, st>>>(*P);
      break;
    case SOFT_MULTI:
      fused_shadows_kernel<SOFT_MULTI><<<grid, block, 0, st>>>(*P);
      break;
    case CLOSEST:
      fused_shadows_kernel<CLOSEST><<<grid, block, 0, st>>>(*P);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
