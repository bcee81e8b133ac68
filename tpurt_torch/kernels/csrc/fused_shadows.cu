// Closest hit, alone or fused with shadows, over an 8-wide BVH, for
// Hopper: one kernel template, eight modes, each replacing one TPU kernel
// of tpurt/kernels/traverse.py:
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
//   NEAREST     _closest_hit_kernel_w8_b            the closest hit alone:
//                                                   t and the sorted index
//                                                   (the shade-table
//                                                   G-buffer's unfused cast)
//   FIRST_HIT   _first_hit_kernel_w8_b              the seed of the seeded
//                                                   G-buffer: NEAREST's
//                                                   walk, stopped once the
//                                                   ray has some hit -> an
//                                                   upper bound (t, index)
//
// The second template parameter is the JAX kernels' ``attrs``: the five
// shadow modes come in all three variants, CLOSEST in attrs=1 and 2,
// NEAREST and FIRST_HIT in attrs=0. attrs=1 walks with the leaf
// attribute rows and writes the 15 attribute channels; attrs=2 (textured
// meshes, _w8_closest_walk_attr(textured=True)) also reads each winner's
// layer and corner uvs and writes its interpolated uv (channels 4-5) and
// layer (channel 7), which attrs=1 writes as 0; attrs=0 (and NEAREST,
// FIRST_HIT) reads no attribute row and writes t and the sorted index,
// which key the shade table (the G-buffer's one row gather per pixel).
// attrs=0 phase 1 still keeps the winner's geometric normal, which the
// shadow phase offsets the hit point along (_w8_closest_walk_n); NEAREST
// and FIRST_HIT keep nothing but t and the index.
//
// Their plain PyTorch versions are closest_{,multi_,soft_,point_soft_,
// soft_multi_}shadow_reference (attrs=0: the *_st_reference twins,
// attrs=2: *_tex_reference),
// closest_attrs_reference, closest_reference and first_hit_reference in
// tpurt_torch/kernels/traverse.py. All follow one contract:
//
//   rays    f32[PB,10,8,128]  o.xyz, d.xyz, clamped 1/d.xyz, t_max (SoA)
//   nodes   f32[Nw,128]       8 children x [bmin.xyz, bmax.xyz, ref, pad]
//   tris    f32[L,128]        k x (v0, e1, e2) per leaf
//   at0/at1 f32[L,128]        leaf attribute rows (at1 read only if k > 8;
//                             attrs=1 and 2 only)
//   out     f32[PB,15,8,128]  attrs=1, 2: t, sidx, u, v, uv(2), kd, layer,
//                             tri_id, packed oct n0..n2, geometric normal
//                             (uv and layer 0 with attrs=1)
//   out     f32[PB,8,128]     attrs=0: t (BIG on a miss)
//   sidx_out i32[PB,8,128]    attrs=0: sorted index (-1 on a miss)
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
//   CLOSEST, NEAREST, FIRST_HIT  none
//
// and i32[PB,8,128] outputs: mask (bit l = light l occluded; SOFT_MULTI:
// bit i = extra light i) and/or counts in [0, spp].
//
// Design: one thread per ray, blocks of 128 threads. The ray index is
// (packet, lane), so neighbouring threads read neighbouring words of the
// SoA ray block. Phase 1 is the closest walk (all that CLOSEST, NEAREST
// and FIRST_HIT run; NEAREST honours each ray's t_max, row 9, which the
// seeded G-buffer's second pass sets to FIRST_HIT's loosened t). The
// TPU's seed walk stops its 1024-ray packet once every lane has a hit;
// here each ray stops for itself, checked every FIRST_HIT_PERIOD
// iterations as there. Phase 2 of HARD, MULTI, SOFT and SOFT_MULTI runs
// every light or sample in the same thread, from the same biased hit
// point, reusing the per-ray stack in local memory. PSOFT (psoft_kernel)
// runs phase 2 with one thread per (ray, sample): each thread stages its
// ray's biased origin and hit flag in shared memory, and after a barrier
// the block's 128 threads take the flat (ray, sample) index of its 128
// rays (walk.cuh's disk_samples), so a ray's samples walk side by side
// in neighbouring lanes, with child records read as 16-byte loads; the
// counts are summed in shared memory and written once. Each shadow walk
// has its own iteration cap, and dropped pushes and capped walks of all
// walks are summed into counts (the walks are in walk.cuh). Nodes, leaves
// and attribute rows are read from global memory through the read-only
// path. The soft modes draw u1, u2 from Philox4x32-10 keyed by (seed,
// light 0) and counted by (ray index in the packed block, sample), so a
// sample never depends on the thread layout; zero_stream gives u1 = u2 =
// 0, the stream of the JAX kernels' interpret mode.
//
// What bounds it on this card: each walk is a chain of dependent global
// loads (pop -> node row -> slab tests -> push) with divergent trip counts
// within a warp, so latency and divergence rather than bandwidth or FLOPs.
// The float work of the slab and triangle tests gives the operation bound
// that PERF.md states; it grows with the number of shadow walks while the
// bytes (rays in, channels out) do not. The walk's data for a 287k-
// triangle scene (5.8 MB of node rows, 15.3 MB of leaf rows) fits the
// 50 MB L2; the attribute rows (another 30.7 MB) are read only when a
// candidate wins. The thread-per-ray modes hide latency only by occupancy,
// and their sample loops (SOFT, SOFT_MULTI) make a warp of 32 rays wait,
// every round, for its longest walk. PSOFT's samples of one ray start
// from one origin toward one small disk, visit nearly the same nodes and
// stop (or not) together, so in one warp they diverge little (PERF.md:
// 1.6x faster than the thread-per-ray loop on the 1080p lamp).
// The TPU kernels' 1024-ray packets with one shared stack and their "any
// lane hit" reductions are not carried over: each ray tests only the
// boxes it hits itself.
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
  CLOSEST = 5,
  NEAREST = 6,
  FIRST_HIT = 7
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

// Phase 2 of the fused modes but PSOFT: light 0's shadow, every hard
// light, or light 0's samples (and the hard extras), from the biased hit
// point of ray gid.
template <int MODE>
__device__ __forceinline__ void shadow_phase(const Params& P, const Ray& r,
                                             const Hit& h, int gid,
                                             int* stack, WalkCounts& wc) {
  static_assert(MODE != PSOFT, "PSOFT runs psoft_kernel");
  const float* sc = P.scal;
  bool hitm = h.idx >= 0;
  bool hard_point = MODE == HARD && (P.point_mask & 1);
  float bias = MODE == HARD ? sc[hard_point ? 3 : 6]
             : MODE == SOFT ? sc[16] : sc[0];
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
    bool disk = MODE == SOFT_MULTI && P.disk;
    const float* l0 = MODE == SOFT_MULTI ? sc + 7 : sc;
    Disk db = {};
    if (disk) db = disk_basis(l0, l0[3], s);
    int cnt = 0;
    const uint32_t seed = *P.seed;
    for (int i = 0; i < P.spp; ++i) {
      float u1, u2;
      sample_u1u2(seed, 0u, P.zero_stream, (uint32_t)gid, (uint32_t)i, u1,
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

template <int MODE, int ATTRS>
__global__ void __launch_bounds__(128) fused_shadows_kernel(Params P) {
  constexpr bool WALK_ONLY = MODE == NEAREST || MODE == FIRST_HIT;
  constexpr int TRACK = ATTRS == 2 ? TRACK_TEX
                        : ATTRS ? TRACK_ATTRS
                                : (WALK_ONLY ? TRACK_T : TRACK_NORMAL);
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
  Hit h = closest_walk<TRACK, MODE == FIRST_HIT>(
      P.nodes, P.tris, P.at0, P.at1, P.k, r, tmax, P.t_min, P.max_iters,
      P.stack_size, stack, wc);
  if constexpr (ATTRS)
    write_attrs(P.out, p, lane, h);
  else
    write_hit(P.out, P.sidx_out, gid, h);
  if constexpr (MODE != CLOSEST && !WALK_ONLY)
    shadow_phase<MODE>(P, r, h, gid, stack, wc);
  if (wc.overflow) atomicAdd(P.counts, wc.overflow);
  if (wc.capped) atomicAdd(P.counts + 1, wc.capped);
}

// Mode PSOFT: phase 1 as fused_shadows_kernel (one closest walk per
// thread, the same outputs), then the biased origin and hit flag of the
// block's PSOFT_PIXELS rays staged in shared memory and, after a barrier,
// their spp disk samples of light 0 with one thread per (ray, sample)
// (walk.cuh's disk_samples). Nine blocks an SM cap it at 56 registers
// (ptxas: 72 at attrs=0 and 64 otherwise without the cap, 32 B of spills
// with it), which ran 1.1-1.4% faster at attrs=0 and 1 on the 1080p lamp
// (PERF.md); ANY_PSOFT ran 0.5% slower so and keeps its 64.
template <int ATTRS>
__global__ void __launch_bounds__(PSOFT_PIXELS, 9) psoft_kernel(Params P) {
  constexpr int TRACK = ATTRS == 2 ? TRACK_TEX
                        : ATTRS ? TRACK_ATTRS : TRACK_NORMAL;
  __shared__ float org[4 * PSOFT_PIXELS];
  __shared__ int cnt[PSOFT_PIXELS];
  int t = threadIdx.x;
  int base = blockIdx.x * PSOFT_PIXELS;
  int gid = base + t;
  int npx = min(PSOFT_PIXELS, P.num_rays - base);
  int stack[STACK_CAPACITY];
  WalkCounts wc;
  cnt[t] = 0;
  if (t < npx) {
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
    Hit h = closest_walk<TRACK>(P.nodes, P.tris, P.at0, P.at1, P.k, r,
                                rb[9 * LANES], P.t_min, P.max_iters,
                                P.stack_size, stack, wc);
    if constexpr (ATTRS)
      write_attrs(P.out, p, lane, h);
    else
      write_hit(P.out, P.sidx_out, gid, h);
    Ray s = biased_origin(r, h, P.scal[4]);
    org[t] = s.ox;
    org[PSOFT_PIXELS + t] = s.oy;
    org[2 * PSOFT_PIXELS + t] = s.oz;
    org[3 * PSOFT_PIXELS + t] = h.idx >= 0 ? 1.0f : 0.0f;
  }
  __syncthreads();
  disk_samples(P, org, PSOFT_PIXELS, P.scal, 0u, 0.0f, base, npx, cnt, stack,
               wc);
  __syncthreads();
  if (t < npx) P.cnt_out[gid] = cnt[t];
  if (wc.overflow) atomicAdd(P.counts, wc.overflow);
  if (wc.capped) atomicAdd(P.counts + 1, wc.capped);
}

extern "C" int tpurt_stack_capacity() { return STACK_CAPACITY; }

extern "C" int tpurt_params_size() { return (int)sizeof(Params); }

template <int MODE>
static void launch_mode(const Params* P, dim3 grid, dim3 block,
                        cudaStream_t st) {
  if (P->attrs == 2)
    fused_shadows_kernel<MODE, 2><<<grid, block, 0, st>>>(*P);
  else if (P->attrs)
    fused_shadows_kernel<MODE, 1><<<grid, block, 0, st>>>(*P);
  else
    fused_shadows_kernel<MODE, 0><<<grid, block, 0, st>>>(*P);
}

// Launches ``mode`` in the variant P->attrs (0, 1 or 2) on ``stream``
// with the arguments in *P; allocates nothing and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unknown mode or
// variant: CLOSEST exists only with attrs=1 and 2, NEAREST and FIRST_HIT
// only with attrs=0).
extern "C" int tpurt_fused_shadows_launch(int mode, const Params* P,
                                          void* stream) {
  if (P->attrs < 0 || P->attrs > 2) return (int)cudaErrorInvalidValue;
  if (P->num_rays <= 0) return (int)cudaGetLastError();
  dim3 block(128);
  dim3 grid((P->num_rays + 127) / 128);
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case HARD:
      launch_mode<HARD>(P, grid, block, st);
      break;
    case MULTI:
      launch_mode<MULTI>(P, grid, block, st);
      break;
    case SOFT:
      launch_mode<SOFT>(P, grid, block, st);
      break;
    case PSOFT:
      if (P->attrs == 2)
        psoft_kernel<2><<<grid, block, 0, st>>>(*P);
      else if (P->attrs)
        psoft_kernel<1><<<grid, block, 0, st>>>(*P);
      else
        psoft_kernel<0><<<grid, block, 0, st>>>(*P);
      break;
    case SOFT_MULTI:
      launch_mode<SOFT_MULTI>(P, grid, block, st);
      break;
    case CLOSEST:
      if (!P->attrs) return (int)cudaErrorInvalidValue;
      if (P->attrs == 2)
        fused_shadows_kernel<CLOSEST, 2><<<grid, block, 0, st>>>(*P);
      else
        fused_shadows_kernel<CLOSEST, 1><<<grid, block, 0, st>>>(*P);
      break;
    case NEAREST:
      if (P->attrs) return (int)cudaErrorInvalidValue;
      fused_shadows_kernel<NEAREST, 0><<<grid, block, 0, st>>>(*P);
      break;
    case FIRST_HIT:
      if (P->attrs) return (int)cudaErrorInvalidValue;
      fused_shadows_kernel<FIRST_HIT, 0><<<grid, block, 0, st>>>(*P);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
