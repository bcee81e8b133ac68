// Device walks over an 8-wide BVH, shared by the modes of the fused
// kernel (fused_shadows.cu): the slab and Moller-Trumbore
// tests, the attribute-tracked closest walk (tpurt/kernels/traverse.py
// _w8_closest_walk_attr), the any-hit walk (_w8_anyhit_walk), the biased
// shadow origin (_biased_hit_origin), the scene-exit cap
// (_scene_exit_cap), and the counter-based generator and sampling helpers
// of the soft kernels (_uniform01, _sincos_2pi, _lane_axis_onb).
//
// One thread walks one ray with its own stack in local memory. Every
// function evaluates in the order of the plain PyTorch version
// (tpurt_torch/kernels/traverse.py, sampling.py); with --fmad=false no
// product is contracted, so the two agree bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define STACK_CAPACITY 256
#define ATTR_CH 15
#define LANES 1024
#define BIG 3.4e38f

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Pushes dropped on a full stack and walks cut at the iteration cap.
struct WalkCounts {
  int overflow = 0, capped = 0;
};

__device__ __forceinline__ float clamp_big(float x) {
  return fminf(fmaxf(x, -BIG), BIG);
}

__device__ __forceinline__ void set_inverse(Ray& r) {
  r.ix = clamp_big(1.0f / r.dx);
  r.iy = clamp_big(1.0f / r.dy);
  r.iz = clamp_big(1.0f / r.dz);
}

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

// Moller-Trumbore products shared by the closest and the any-hit test.
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

// Phase 1: closest hit in (t_min, tmax) with attribute tracking.
__device__ __forceinline__ Hit closest_walk(
    const float* __restrict__ nodes, const float* __restrict__ tris,
    const float* __restrict__ at0, const float* __restrict__ at1, int k,
    const Ray& r, float tmax, float t_min, int max_iters, int stack_size,
    int* stack, WalkCounts& wc) {
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
        ++wc.overflow;
      }
    }
    ++it;
  }
  wc.capped += sp > 0;
  return h;
}

// Store phase 1's 15 attribute channels of ray (p, lane).
__device__ __forceinline__ void write_attrs(float* __restrict__ out, int p,
                                            int lane, const Hit& h) {
  float* ob = out + (size_t)p * ATTR_CH * LANES + lane;
  ob[0] = h.idx >= 0 ? h.t : BIG;
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
}

// Any hit in (t_min, tmax); a ray with tmax <= t_min tests no box.
__device__ __forceinline__ bool anyhit_walk(const float* __restrict__ nodes,
                                            const float* __restrict__ tris,
                                            int k, const Ray& s, float tmax,
                                            float t_min, int max_iters,
                                            int stack_size, int* stack,
                                            WalkCounts& wc) {
  bool active = tmax > t_min;
  bool occ = false;
  int sp = 1, it = 0;
  stack[0] = 0;
  while (sp > 0 && it < max_iters && !occ) {
    const float* row = nodes + (size_t)stack[--sp] * 128;
    unsigned mask = child_hits(row, s, t_min, active ? tmax : -BIG);
    for (int c = 0; c < 8; ++c) {
      if (!(mask >> c & 1u)) continue;
      int ref = (int)__ldg(row + 16 * c + 6);
      if (ref < 0) {
        if (leaf_occluded(tris, max(-ref - 1, 0), k, s, t_min, tmax)) {
          occ = true;
          break;
        }
      } else if (sp < stack_size) {
        stack[sp++] = ref;
      } else {
        ++wc.overflow;
      }
    }
    ++it;
  }
  wc.capped += (!occ && sp > 0);
  return occ;
}

// Shadow-ray origin: the hit point pushed by the bias along the unit
// geometric normal turned toward the viewer.
__device__ __forceinline__ Ray biased_origin(const Ray& r, const Hit& h,
                                             float bias) {
  float rn = 1.0f / sqrtf(fmaxf(h.nx * h.nx + h.ny * h.ny + h.nz * h.nz,
                                1e-30f));
  float flip = (h.nx * r.dx + h.ny * r.dy + h.nz * r.dz > 0.0f) ? -1.0f : 1.0f;
  float off = bias * rn * flip;
  Ray s;
  s.ox = r.ox + h.t * r.dx + h.nx * off;
  s.oy = r.oy + h.t * r.dy + h.ny * off;
  s.oz = r.oz + h.t * r.dz + h.nz * off;
  s.dx = s.dy = s.dz = s.ix = s.iy = s.iz = 0.0f;
  return s;
}

// Root-box exit x 1.0001 for a shadow ray with its inverse set; -BIG off
// the hit set. rb = root min(3), root max(3).
__device__ __forceinline__ float scene_exit_cap(bool hitm, const Ray& s,
                                                const float* rb) {
  float ex = fminf(
      fminf(fmaxf((rb[0] - s.ox) * s.ix, (rb[3] - s.ox) * s.ix),
            fmaxf((rb[1] - s.oy) * s.iy, (rb[4] - s.oy) * s.iy)),
      fmaxf((rb[2] - s.oz) * s.iz, (rb[5] - s.oz) * s.iz));
  return hitm ? fmaxf(ex, 0.0f) * 1.0001f : -BIG;
}

// Direction along (ex, ey, ez), its inverse, and t capped at the length x
// (1 - 1e-4): a point light, or one sample of a disk light.
__device__ __forceinline__ float toward(bool hitm, float ex, float ey,
                                        float ez, Ray& s) {
  float d2 = fmaxf(ex * ex + ey * ey + ez * ez, 1e-24f);
  float drn = 1.0f / sqrtf(d2);
  s.dx = ex * drn;
  s.dy = ey * drn;
  s.dz = ez * drn;
  set_inverse(s);
  return hitm ? d2 * drn * 0.9999f : -BIG;
}

// ---------------------------------------------------------------------------
// Counter-based generator: Philox4x32-10, key (seed, light), counter (ray
// index in the packed block, sample, 0, 0). Words 0 and 1 are u1 and u2.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint2 philox_u1u2(uint32_t seed, uint32_t light,
                                             uint32_t ray, uint32_t sample) {
  uint32_t c0 = ray, c1 = sample, c2 = 0u, c3 = 0u;
  uint32_t k0 = seed, k1 = light;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint2(c0, c1);
}

// 23 random mantissa bits onto [1, 2), minus 1 (_uniform01).
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return __int_as_float((int)((bits >> 9) | 0x3F800000u)) - 1.0f;
}

// (sin, cos) of 2 pi (t - 0.5): the JAX kernels' polynomial. Constants are
// the float32 roundings of the double values, as the plain version's.
__device__ __forceinline__ void sincos_2pi(float t, float& s, float& c) {
  float psi = (float)3.14159265 * (t - 0.5f);
  float p2 = psi * psi;
  float s1 = psi * (1.0f + p2 * ((float)(-1.0 / 6.0) +
                                 p2 * ((float)(1.0 / 120.0) +
                                       p2 * (float)(-1.0 / 5040.0))));
  float c1 = 1.0f + p2 * (-0.5f + p2 * ((float)(1.0 / 24.0) +
                                        p2 * (float)(-1.0 / 720.0)));
  s = 2.0f * s1 * c1;
  c = 1.0f - 2.0f * s1 * s1;
}
