// Fused closest hit + light-0 hard shadow over an 8-wide BVH, for Hopper.
//
// Replaces the TPU kernel tpurt/kernels/traverse.py
// _closest_shadow_kernel_w8_b (reached through trace_closest_shadow_pallas),
// variant attrs=1 (attribute tracking, no textures), with a directional or
// a point light. Its plain PyTorch version is closest_shadow_reference in
// tpurt_torch/kernels/traverse.py; both follow one contract:
//
//   rays    f32[PB,10,8,128]  o.xyz, d.xyz, clamped 1/d.xyz, t_max (SoA)
//   nodes   f32[Nw,128]       8 children x [bmin.xyz, bmax.xyz, ref, pad]
//   tris    f32[L,128]        k x (v0, e1, e2) per leaf
//   at0/at1 f32[L,128]        leaf attribute rows (at1 read only if k > 8)
//   scal    f32[13] (dir, clamped 1/dir, bias, root min, root max)
//           or f32[4] (point position, bias)
//   out     f32[PB,15,8,128]  t, sidx, u, v, uv(2), kd, layer, tri_id,
//                             packed oct n0..n2, geometric normal
//   occ     i32[PB,8,128]
//   counts  i32[2]            stack overflows, walks cut at the cap
//
// Design: one thread per ray, blocks of 128 threads. The ray index is
// (packet, lane), so neighbouring threads read neighbouring words of the
// SoA ray block. Each ray walks its own stack in local memory; nodes,
// leaves and attribute rows are read from global memory through the
// read-only path. What should bound it on this card (not yet profiled):
// the walk is a chain of dependent global loads (pop -> node row -> slab
// tests -> push) with divergent trip counts within a warp, so latency and
// divergence rather than bandwidth or FLOPs. The walk's data for a
// 287k-triangle scene (5.8 MB of node rows, 15.3 MB of leaf rows) fits
// the 50 MB L2; the attribute rows (another 30.7 MB) are read only when a
// candidate wins. This first version hides latency only by occupancy.
// Caching the top of the tree in shared memory, warp-cooperative walks
// and wavefront scheduling are later work. The TPU kernel's 1024-ray
// packets with one shared stack and its "any lane hit" reductions are not
// carried over: each ray tests only the boxes it hits itself.
//
// Built with --fmad=false: the slab and Moller-Trumbore products are
// evaluated in the plain version's order without contraction, so the two
// agree bit for bit on most rays.

#include <cuda_runtime.h>
#include <stdint.h>

#define STACK_CAPACITY 256
#define ATTR_CH 15
#define LANES 1024
#define BIG 3.4e38f

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Slab test of one child record against [t_min, cap]. Empty slots carry
// inverted boxes, which the slab test alone accepts, so the caller also
// checks bmin.x <= bmax.x.
__device__ __forceinline__ bool slab(const float* __restrict__ b, const Ray& r,
                                     float t_min, float cap) {
  float t0 = (__ldg(b + 0) - r.ox) * r.ix;
  float t1 = (__ldg(b + 3) - r.ox) * r.ix;
  float lx = fminf(t0, t1), hx = fmaxf(t0, t1);
  t0 = (__ldg(b + 1) - r.oy) * r.iy;
  t1 = (__ldg(b + 4) - r.oy) * r.iy;
  float ly = fminf(t0, t1), hy = fmaxf(t0, t1);
  t0 = (__ldg(b + 2) - r.oz) * r.iz;
  t1 = (__ldg(b + 5) - r.oz) * r.iz;
  float lz = fminf(t0, t1), hz = fmaxf(t0, t1);
  float enter = fmaxf(fmaxf(lx, ly), fmaxf(lz, t_min));
  float exit_ = fminf(fminf(hx, hy), fminf(hz, cap));
  return enter <= exit_;
}

// Bit c set when child c of the row is non-empty and its box is hit.
__device__ __forceinline__ unsigned child_hits(const float* __restrict__ row,
                                               const Ray& r, float t_min,
                                               float cap) {
  unsigned mask = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float* b = row + 16 * c;
    if (__ldg(b) <= __ldg(b + 3) && slab(b, r, t_min, cap)) mask |= 1u << c;
  }
  return mask;
}

struct MT {
  float det, nu, nv, nt;
};

// Moller-Trumbore products shared by the closest and the any-hit test,
// in the plain version's order of operations.
__device__ __forceinline__ MT mt_terms(const float* __restrict__ tri,
                                       const Ray& r) {
  float v0x = __ldg(tri + 0), v0y = __ldg(tri + 1), v0z = __ldg(tri + 2);
  float e1x = __ldg(tri + 3), e1y = __ldg(tri + 4), e1z = __ldg(tri + 5);
  float e2x = __ldg(tri + 6), e2y = __ldg(tri + 7), e2z = __ldg(tri + 8);
  float px = r.dy * e2z - r.dz * e2y;
  float py = r.dz * e2x - r.dx * e2z;
  float pz = r.dx * e2y - r.dy * e2x;
  MT m;
  m.det = e1x * px + e1y * py + e1z * pz;
  float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  m.nu = tx * px + ty * py + tz * pz;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  m.nv = r.dx * qx + r.dy * qy + r.dz * qz;
  m.nt = e2x * qx + e2y * qy + e2z * qz;
  return m;
}

struct Hit {
  float t, u, v, kd, tid, o0, o1, o2, nx, ny, nz;
  int idx;
};

// Closest-hit test of one leaf: division by det, eps 1e-9, inclusive
// barycentric bounds, strictly smaller t wins (the first hit found wins a
// tie). The winner's attributes are read from the leaf attribute rows.
__device__ __forceinline__ void leaf_closest(
    const float* __restrict__ tris, const float* __restrict__ at0,
    const float* __restrict__ at1, int leaf, int k, const Ray& r,
    float t_min, bool active0, Hit& h) {
  const float* row = tris + (size_t)leaf * 128;
  for (int j = 0; j < k; ++j) {
    const float* tri = row + 9 * j;
    MT m = mt_terms(tri, r);
    bool ok = fabsf(m.det) >= 1e-9f;
    float inv_det = 1.0f / (ok ? m.det : 1.0f);
    float u = m.nu * inv_det;
    float v = m.nv * inv_det;
    float t = m.nt * inv_det;
    ok = ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f;
    t = ok ? t : BIG;
    if (t > t_min && t < h.t && active0) {
      const float* a = (j < 8) ? at0 + (size_t)leaf * 128 + 16 * j
                               : at1 + (size_t)leaf * 128 + 16 * (j - 8);
      float e1x = __ldg(tri + 3), e1y = __ldg(tri + 4), e1z = __ldg(tri + 5);
      float e2x = __ldg(tri + 6), e2y = __ldg(tri + 7), e2z = __ldg(tri + 8);
      h.t = t;
      h.idx = leaf * k + j;
      h.u = u;
      h.v = v;
      h.kd = __ldg(a + 3);
      h.tid = __ldg(a + 11);
      h.o0 = __ldg(a + 0);
      h.o1 = __ldg(a + 1);
      h.o2 = __ldg(a + 2);
      h.nx = e1y * e2z - e1z * e2y;
      h.ny = e1z * e2x - e1x * e2z;
      h.nz = e1x * e2y - e1y * e2x;
    }
  }
}

// Division-free occlusion test of one leaf.
__device__ __forceinline__ bool leaf_occluded(const float* __restrict__ tris,
                                              int leaf, int k, const Ray& r,
                                              float t_min, float tmax) {
  const float* row = tris + (size_t)leaf * 128;
  for (int j = 0; j < k; ++j) {
    MT m = mt_terms(row + 9 * j, r);
    float sgn = m.det < 0.0f ? -1.0f : 1.0f;
    float adet = m.det * sgn;
    float nu = m.nu * sgn, nv = m.nv * sgn, nt = m.nt * sgn;
    if (adet >= 1e-9f && nu >= 0.0f && nv >= 0.0f && nu + nv <= adet &&
        nt > t_min * adet && nt < tmax * adet)
      return true;
  }
  return false;
}

__global__ void __launch_bounds__(128) closest_shadow_kernel(
    const float* __restrict__ nodes, const float* __restrict__ tris,
    const float* __restrict__ at0, const float* __restrict__ at1,
    const float* __restrict__ rays, const float* __restrict__ scal,
    float* __restrict__ out, int* __restrict__ occ_out,
    int* __restrict__ counts, int num_rays, int k, int point, float t_min,
    int max_iters, int stack_size) {
  int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= num_rays) return;
  int p = gid / LANES, lane = gid % LANES;
  const float* rb = rays + (size_t)p * 10 * LANES + lane;
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
  int overflow = 0, capped = 0;

  // Phase 1: closest hit with attribute tracking.
  bool active0 = tmax > t_min;
  Hit h;
  h.t = active0 ? tmax : -BIG;
  h.idx = -1;
  h.u = h.v = h.kd = h.tid = h.o0 = h.o1 = h.o2 = 0.0f;
  h.nx = h.ny = h.nz = 0.0f;
  int sp = 1, it = 0;
  stack[0] = 0;
  while (sp > 0 && it < max_iters) {
    const float* row = nodes + (size_t)stack[--sp] * 128;
    unsigned mask = child_hits(row, r, t_min, active0 ? h.t : -BIG);
    for (int c = 0; c < 8; ++c) {
      if (!(mask >> c & 1u)) continue;
      int ref = (int)__ldg(row + 16 * c + 6);
      if (ref < 0) {
        leaf_closest(tris, at0, at1, max(-ref - 1, 0), k, r, t_min, active0,
                     h);
      } else if (sp < stack_size) {
        stack[sp++] = ref;
      } else {
        ++overflow;
      }
    }
    ++it;
  }
  capped += sp > 0;

  float* ob = out + (size_t)p * ATTR_CH * LANES + lane;
  bool hitm = h.idx >= 0;
  ob[0] = hitm ? h.t : BIG;
  ob[1 * LANES] = (float)h.idx;
  ob[2 * LANES] = h.u;
  ob[3 * LANES] = h.v;
  ob[4 * LANES] = 0.0f;
  ob[5 * LANES] = 0.0f;
  ob[6 * LANES] = h.kd;
  ob[7 * LANES] = 0.0f;
  ob[8 * LANES] = h.tid;
  ob[9 * LANES] = h.o0;
  ob[10 * LANES] = h.o1;
  ob[11 * LANES] = h.o2;
  ob[12 * LANES] = h.nx;
  ob[13 * LANES] = h.ny;
  ob[14 * LANES] = h.nz;

  // Phase 2: light 0's shadow ray from the hit, pushed by the bias along
  // the unit geometric normal turned toward the viewer.
  float bias = point ? scal[3] : scal[6];
  float rn = 1.0f / sqrtf(fmaxf(h.nx * h.nx + h.ny * h.ny + h.nz * h.nz,
                                1e-30f));
  float flip = (h.nx * r.dx + h.ny * r.dy + h.nz * r.dz > 0.0f) ? -1.0f : 1.0f;
  float off = bias * rn * flip;
  Ray s;
  s.ox = r.ox + h.t * r.dx + h.nx * off;
  s.oy = r.oy + h.t * r.dy + h.ny * off;
  s.oz = r.oz + h.t * r.dz + h.nz * off;
  float stmax;
  if (point) {
    float ex = scal[0] - s.ox, ey = scal[1] - s.oy, ez = scal[2] - s.oz;
    float d2 = fmaxf(ex * ex + ey * ey + ez * ez, 1e-24f);
    float drn = 1.0f / sqrtf(d2);
    s.dx = ex * drn;
    s.dy = ey * drn;
    s.dz = ez * drn;
    s.ix = fminf(fmaxf(1.0f / s.dx, -BIG), BIG);
    s.iy = fminf(fmaxf(1.0f / s.dy, -BIG), BIG);
    s.iz = fminf(fmaxf(1.0f / s.dz, -BIG), BIG);
    stmax = hitm ? d2 * drn * 0.9999f : -BIG;
  } else {
    s.dx = scal[0];
    s.dy = scal[1];
    s.dz = scal[2];
    s.ix = scal[3];
    s.iy = scal[4];
    s.iz = scal[5];
    float ex = fminf(
        fminf(fmaxf((scal[7] - s.ox) * s.ix, (scal[10] - s.ox) * s.ix),
              fmaxf((scal[8] - s.oy) * s.iy, (scal[11] - s.oy) * s.iy)),
        fmaxf((scal[9] - s.oz) * s.iz, (scal[12] - s.oz) * s.iz));
    stmax = hitm ? fmaxf(ex, 0.0f) * 1.0001f : -BIG;
  }

  bool active1 = stmax > 0.0f;
  int occ = 0;
  sp = 1;
  it = 0;
  stack[0] = 0;
  while (sp > 0 && it < max_iters && !occ) {
    const float* row = nodes + (size_t)stack[--sp] * 128;
    unsigned mask = child_hits(row, s, 0.0f, active1 ? stmax : -BIG);
    for (int c = 0; c < 8; ++c) {
      if (!(mask >> c & 1u)) continue;
      int ref = (int)__ldg(row + 16 * c + 6);
      if (ref < 0) {
        if (leaf_occluded(tris, max(-ref - 1, 0), k, s, 0.0f, stmax)) {
          occ = 1;
          break;
        }
      } else if (sp < stack_size) {
        stack[sp++] = ref;
      } else {
        ++overflow;
      }
    }
    ++it;
  }
  capped += (!occ && sp > 0);
  occ_out[(size_t)p * LANES + lane] = occ;
  if (overflow) atomicAdd(counts, overflow);
  if (capped) atomicAdd(counts + 1, capped);
}

extern "C" int tpurt_stack_capacity() { return STACK_CAPACITY; }

// Launches on ``stream``, allocates nothing, returns cudaGetLastError().
extern "C" int tpurt_closest_shadow_launch(
    const void* nodes, const void* tris, const void* at0, const void* at1,
    const void* rays, const void* scal, void* out, void* occ, void* counts,
    int num_rays, int k, int point, float t_min, int max_iters,
    int stack_size, void* stream) {
  if (num_rays <= 0) return (int)cudaGetLastError();
  dim3 block(128);
  dim3 grid((num_rays + 127) / 128);
  closest_shadow_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)nodes, (const float*)tris, (const float*)at0,
      (const float*)at1, (const float*)rays, (const float*)scal,
      (float*)out, (int*)occ, (int*)counts, num_rays, k, point, t_min,
      max_iters, stack_size);
  return (int)cudaGetLastError();
}
