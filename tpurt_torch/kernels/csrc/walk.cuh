// Device walks over an 8-wide BVH, shared by the kernels of
// fused_shadows.cu, shadow_rays.cu and (over a WideBVHT's transposed
// leaves, template parameter TK) transposed.cu: the slab and
// Moller-Trumbore tests, the closest walk
// (tpurt/kernels/traverse.py _w8_closest_walk_attr with
// the attribute rows, _w8_closest_walk_n without them, and the plain walk
// of _closest_w8_b_impl), the any-hit walk (_w8_anyhit_walk), the biased
// shadow origin (_biased_hit_origin), the scene-exit cap
// (_scene_exit_cap), the counter-based generator and the cone and disk
// samplers of the soft kernels (_uniform01, _sincos_2pi, _lane_axis_onb),
// and the launch arguments both files take (Params). binary.cu's walks
// over the packed binary tree reuse the leaf tests and Params.
//
// One thread walks one ray with its own stack in local memory (the
// point-light penumbra walks at the end: one thread per (ray, sample)). Every
// function evaluates in the order of the plain PyTorch version
// (tpurt_torch/kernels/traverse.py, sampling.py); with --fmad=false no
// product is contracted, so the two agree bit for bit. Every function here
// is __forceinline__, so the two translation units of one library never
// define the same symbol.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define STACK_CAPACITY 256
// A first-hit walk (mode FIRST_HIT) checks every FIRST_HIT_PERIOD
// iterations whether its ray has a hit (tpurt's 2**W8_EXIT_LOG).
#define FIRST_HIT_PERIOD 4
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

// Slab test of one box against [t_min, cap], in slab()'s order, from
// values already loaded (binary.cu's 16-byte records, the penumbra walks'
// child_hits4).
__device__ __forceinline__ bool slab_box(float bx0, float by0, float bz0,
                                         float bx1, float by1, float bz1,
                                         const Ray& r, float t_min,
                                         float cap) {
  float t0 = (bx0 - r.ox) * r.ix;
  float t1 = (bx1 - r.ox) * r.ix;
  float lx = fminf(t0, t1), hx = fmaxf(t0, t1);
  t0 = (by0 - r.oy) * r.iy;
  t1 = (by1 - r.oy) * r.iy;
  float ly = fminf(t0, t1), hy = fmaxf(t0, t1);
  t0 = (bz0 - r.oz) * r.iz;
  t1 = (bz1 - r.oz) * r.iz;
  float lz = fminf(t0, t1), hz = fmaxf(t0, t1);
  float enter = fmaxf(fmaxf(lx, ly), fmaxf(lz, t_min));
  float exit_ = fminf(fminf(hx, hy), fminf(hz, cap));
  return enter <= exit_;
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
  float t, u, v, kd, tid, o0, o1, o2, nx, ny, nz, uvu, uvv, lay;
  int idx;
};

// What a closest walk keeps of its winner besides t and the sorted index:
// TRACK_ATTRS the attribute rows' channels and the geometric normal (the
// attrs=1 kernels), TRACK_TEX those plus the interpolated uv and the
// texture layer (attrs=2, textured meshes), TRACK_NORMAL the unnormalised
// geometric normal e1 x e2 alone (the attrs=0 fused kernels, whose shadow
// phase offsets the hit point along it), TRACK_T nothing more (the plain
// closest hit). The fields a walk does not keep stay 0: write_attrs
// stores uv and the layer as 0 below TRACK_TEX, as the JAX kernel's
// zero-initialised carry does.
enum Track { TRACK_T = 0, TRACK_NORMAL = 1, TRACK_ATTRS = 2, TRACK_TEX = 3 };

// Closest-hit test of one leaf: division by det, eps 1e-9, inclusive
// barycentric bounds, strictly smaller t wins (the first hit found wins a
// tie). With TRACK_ATTRS and TRACK_TEX the winner's attributes are read
// from the leaf attribute rows, in the statement order of the attrs=1
// kernels' first version (so their registers stay as they were); the other
// modes never read them. TRACK_TEX also reads the layer (lane 4) and uv0,
// d1, d2 (lanes 5-10) and keeps uv = uv0 + u d1 + v d2 in tpurt's order
// (traverse.py :1364-1369), without FMA.
template <int TRACK>
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
      if constexpr (TRACK >= TRACK_ATTRS) {
        const float* a = (j < 8) ? at0 + (size_t)leaf * 128 + 16 * j
                                 : at1 + (size_t)leaf * 128 + 16 * (j - 8);
        float e1x = __ldg(tri + 3), e1y = __ldg(tri + 4),
              e1z = __ldg(tri + 5);
        float e2x = __ldg(tri + 6), e2y = __ldg(tri + 7),
              e2z = __ldg(tri + 8);
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
        if constexpr (TRACK == TRACK_TEX) {
          h.uvu = __ldg(a + 5) + u * __ldg(a + 7) + v * __ldg(a + 9);
          h.uvv = __ldg(a + 6) + u * __ldg(a + 8) + v * __ldg(a + 10);
          h.lay = __ldg(a + 4);
        }
      } else {
        h.t = t;
        h.idx = leaf * k + j;
        if constexpr (TRACK == TRACK_NORMAL) {
          float e1x = __ldg(tri + 3), e1y = __ldg(tri + 4),
                e1z = __ldg(tri + 5);
          float e2x = __ldg(tri + 6), e2y = __ldg(tri + 7),
                e2z = __ldg(tri + 8);
          h.nx = e1y * e2z - e1z * e2y;
          h.ny = e1z * e2x - e1x * e2z;
          h.nz = e1x * e2y - e1y * e2x;
        }
      }
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

// ---------------------------------------------------------------------------
// The transposed leaves of a WideBVHT (transposed.cu's w8t walks), TK = the
// leaf size, 8 or 16: blocks f32[nblk, 8, 128] of 14 (TK 8) or 7 (TK 16)
// leaves; field f of triangle s = 8h + t of leaf j of block blk lies at
// blk * 1024 + t * 128 + unit * j + 9h + f, unit = 9 * TK / 8. A
// triangle's nine fields are consecutive words, so the TPU kernels' lane
// rolls and one-hot sublane sums become one address; the transposed
// attribute rows put a triangle's attributes at the same address.
// ---------------------------------------------------------------------------

template <int TK>
__device__ __forceinline__ size_t t_offset(int leaf, int s) {
  constexpr int LPB = TK == 8 ? 14 : 7;
  constexpr int UNIT = 9 * (TK / 8);
  int blk = leaf / LPB;
  int j = leaf - blk * LPB;
  return (size_t)blk * LANES + (s & 7) * 128 + UNIT * j + 9 * (s >> 3);
}

// leaf_closest over a transposed leaf (_leaf_closest_t, :1860, and the
// attribute walk's leaf test, :2046): the same test in the same
// sequential strict-'<' order over s = 0..TK-1, which is the TPU kernel's
// rule (the lowest slot of a group of 8 takes a tie, a later group wins
// only with a strictly smaller t). The winner's attributes come from the
// transposed rows at its address: kd, the original id and oct n0..n2 from
// at0 fields 3, 4, 0-2; TRACK_TEX also the layer (field 5) and uv = uv0 +
// u d1 + v d2 with uv0 from at0 fields 6-7 and d1, d2 from at1 fields 0-3,
// in tpurt's order, without FMA.
template <int TRACK, int TK>
__device__ __forceinline__ void leaf_closest_t(
    const float* __restrict__ tris, const float* __restrict__ at0,
    const float* __restrict__ at1, int leaf, const Ray& r, float t_min,
    bool active0, Hit& h) {
  for (int s = 0; s < TK; ++s) {
    size_t off = t_offset<TK>(leaf, s);
    const float* tri = tris + off;
    MT m = mt_terms(tri, r);
    bool ok = fabsf(m.det) >= 1e-9f;
    float inv_det = 1.0f / (ok ? m.det : 1.0f);
    float u = m.nu * inv_det;
    float v = m.nv * inv_det;
    float t = m.nt * inv_det;
    ok = ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f;
    t = ok ? t : BIG;
    if (t > t_min && t < h.t && active0) {
      h.t = t;
      h.idx = leaf * TK + s;
      if constexpr (TRACK >= TRACK_ATTRS) {
        const float* a = at0 + off;
        float e1x = __ldg(tri + 3), e1y = __ldg(tri + 4),
              e1z = __ldg(tri + 5);
        float e2x = __ldg(tri + 6), e2y = __ldg(tri + 7),
              e2z = __ldg(tri + 8);
        h.u = u;
        h.v = v;
        h.kd = __ldg(a + 3);
        h.tid = __ldg(a + 4);
        h.o0 = __ldg(a + 0);
        h.o1 = __ldg(a + 1);
        h.o2 = __ldg(a + 2);
        h.nx = e1y * e2z - e1z * e2y;
        h.ny = e1z * e2x - e1x * e2z;
        h.nz = e1x * e2y - e1y * e2x;
        if constexpr (TRACK == TRACK_TEX) {
          const float* b = at1 + off;
          h.lay = __ldg(a + 5);
          h.uvu = __ldg(a + 6) + u * __ldg(b + 0) + v * __ldg(b + 2);
          h.uvv = __ldg(a + 7) + u * __ldg(b + 1) + v * __ldg(b + 3);
        }
      }
    }
  }
}

// leaf_occluded over a transposed leaf (_leaf_occluded_t, :1815).
template <int TK>
__device__ __forceinline__ bool leaf_occluded_t(
    const float* __restrict__ tris, int leaf, const Ray& r, float t_min,
    float tmax) {
  for (int s = 0; s < TK; ++s) {
    MT m = mt_terms(tris + t_offset<TK>(leaf, s), r);
    float sgn = m.det < 0.0f ? -1.0f : 1.0f;
    float adet = m.det * sgn;
    float nu = m.nu * sgn, nv = m.nv * sgn, nt = m.nt * sgn;
    if (adet >= 1e-9f && nu >= 0.0f && nv >= 0.0f && nu + nv <= adet &&
        nt > t_min * adet && nt < tmax * adet)
      return true;
  }
  return false;
}

// Phase 1: closest hit in (t_min, tmax), keeping what TRACK asks for of
// the winner (at0 and at1 are read only with TRACK_ATTRS and TRACK_TEX).
// FIRST: the seed walk of the seeded G-buffer (_closest_w8_b_impl with
// first_hit=True): the same walk, which stops after every
// FIRST_HIT_PERIOD-th iteration once the ray has some hit; its (t, idx) is
// then an upper bound on the closest hit, and a walk stopped so is not a
// capped one. TK > 0: the leaves (and attribute rows) are a WideBVHT's
// transposed blocks of leaf size TK (leaf_closest_t); its attrs=1 walk
// starts every ray's layer at -1 (the w8t kernel's lay0), not 0.
template <int TRACK, bool FIRST = false, int TK = 0>
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
  h.nx = h.ny = h.nz = h.uvu = h.uvv = h.lay = 0.0f;
  if constexpr (TK > 0 && TRACK == TRACK_ATTRS) h.lay = -1.0f;
  int sp = 1, it = 0;
  stack[0] = 0;
  while (sp > 0 && it < max_iters) {
    const float* row = nodes + (size_t)stack[--sp] * 128;
    unsigned mask = child_hits(row, r, t_min, active0 ? h.t : -BIG);
    for (int c = 0; c < 8; ++c) {
      if (!(mask >> c & 1u)) continue;
      int ref = (int)__ldg(row + 16 * c + 6);
      if (ref < 0) {
        if constexpr (TK > 0)
          leaf_closest_t<TRACK, TK>(tris, at0, at1, max(-ref - 1, 0), r,
                                    t_min, active0, h);
        else
          leaf_closest<TRACK>(tris, at0, at1, max(-ref - 1, 0), k, r,
                              t_min, active0, h);
      } else if (sp < stack_size) {
        stack[sp++] = ref;
      } else {
        ++wc.overflow;
      }
    }
    ++it;
    if (FIRST && it % FIRST_HIT_PERIOD == 0 && h.idx >= 0) return h;
  }
  wc.capped += sp > 0;
  return h;
}

// Store phase 1's 15 attribute channels of ray (p, lane): t, sidx, u, v,
// uv(2), kd, layer, tri_id, packed oct n0..n2, geometric normal.
__device__ __forceinline__ void write_attrs(float* __restrict__ out, int p,
                                            int lane, const Hit& h) {
  float* ob = out + (size_t)p * ATTR_CH * LANES + lane;
  ob[0] = h.idx >= 0 ? h.t : BIG;
  ob[1 * LANES] = (float)h.idx;
  ob[2 * LANES] = h.u;
  ob[3 * LANES] = h.v;
  ob[4 * LANES] = h.uvu;
  ob[5 * LANES] = h.uvv;
  ob[6 * LANES] = h.kd;
  ob[7 * LANES] = h.lay;
  ob[8 * LANES] = h.tid;
  ob[9 * LANES] = h.o0;
  ob[10 * LANES] = h.o1;
  ob[11 * LANES] = h.o2;
  ob[12 * LANES] = h.nx;
  ob[13 * LANES] = h.ny;
  ob[14 * LANES] = h.nz;
}

// Store an attrs=0 phase 1 of ray gid: t (BIG on a miss) and the sorted
// index (-1 on a miss) into two f32 / i32 [PB, 8, 128] planes.
__device__ __forceinline__ void write_hit(float* __restrict__ t_out,
                                          int* __restrict__ sidx_out,
                                          int gid, const Hit& h) {
  t_out[gid] = h.idx >= 0 ? h.t : BIG;
  sidx_out[gid] = h.idx;
}

// Any hit in (t_min, tmax); a ray with tmax <= t_min tests no box. TK > 0:
// transposed leaves of leaf size TK (leaf_occluded_t).
template <int TK = 0>
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
        bool hit;
        if constexpr (TK > 0)
          hit = leaf_occluded_t<TK>(tris, max(-ref - 1, 0), s, t_min, tmax);
        else
          hit = leaf_occluded(tris, max(-ref - 1, 0), k, s, t_min, tmax);
        if (hit) {
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

// Word 0 and 1 of the generator as u1, u2 in [0, 1); zero_stream gives 0.
__device__ __forceinline__ void sample_u1u2(uint32_t seed, uint32_t light,
                                            int zero_stream, uint32_t ray,
                                            uint32_t sample, float& u1,
                                            float& u2) {
  u1 = u2 = 0.0f;
  if (zero_stream) return;
  uint2 bits = philox_u1u2(seed, light, ray, sample);
  u1 = bits_to_uniform(bits.x);
  u2 = bits_to_uniform(bits.y);
}

// One cone sample around the axis c[0..2] (basis t0 = c[3..5], t1 =
// c[6..8]): direction, inverse, and t capped at the root-box exit rb; the
// direction is renormalised (traverse.py :941-945).
__device__ __forceinline__ float cone_sample(const float* c, float cone_cos,
                                             float u1, float u2, bool hitm,
                                             const float* rb, Ray& s) {
  float cos_t = 1.0f - u1 * (1.0f - cone_cos);
  float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  float sphi, cphi;
  sincos_2pi(u2, sphi, cphi);
  float sc = sin_t * cphi;
  float ss = sin_t * sphi;
  float dx = c[0] * cos_t + c[3] * sc + c[6] * ss;
  float dy = c[1] * cos_t + c[4] * sc + c[7] * ss;
  float dz = c[2] * cos_t + c[5] * sc + c[8] * ss;
  float srn = 1.0f / sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-20f));
  s.dx = dx * srn;
  s.dy = dy * srn;
  s.dz = dz * srn;
  set_inverse(s);
  return scene_exit_cap(hitm, s, rb);
}

// Per-ray axis toward a disk light's centre and its Duff basis.
struct Disk {
  float ex, ey, ez, t0x, t0y, t0z, t1x, t1y, t1z, radius;
};

__device__ __forceinline__ Disk disk_basis(const float* lp, float radius,
                                           const Ray& s) {
  Disk b;
  b.ex = lp[0] - s.ox;
  b.ey = lp[1] - s.oy;
  b.ez = lp[2] - s.oz;
  b.radius = radius;
  float arn = 1.0f / sqrtf(fmaxf(b.ex * b.ex + b.ey * b.ey + b.ez * b.ez,
                                 1e-24f));
  float ax = b.ex * arn, ay = b.ey * arn, az = b.ez * arn;
  float sgn = az >= 0.0f ? 1.0f : -1.0f;
  float aa = -1.0f / (sgn + az);
  float bb = ax * ay * aa;
  b.t0x = 1.0f + sgn * ax * ax * aa;
  b.t0y = sgn * bb;
  b.t0z = -sgn * ax;
  b.t1x = bb;
  b.t1y = sgn + ay * ay * aa;
  b.t1z = -ay;
  return b;
}

// One jittered point of the disk: r = sqrt(u1) x radius, phi from u2; t
// capped at the distance x (1 - 1e-4) (traverse.py :1011-1017).
__device__ __forceinline__ float disk_sample(const Disk& b, float u1,
                                             float u2, bool hitm, Ray& s) {
  float r = sqrtf(u1) * b.radius;
  float sphi, cphi;
  sincos_2pi(u2, sphi, cphi);
  float rc = r * cphi;
  float rs = r * sphi;
  return toward(hitm, b.ex + b.t0x * rc + b.t1x * rs,
                b.ey + b.t0y * rc + b.t1y * rs,
                b.ez + b.t0z * rc + b.t1z * rs, s);
}

// ---------------------------------------------------------------------------
// One launch's arguments, for every mode of the three walk kernel files;
// tpurt_torch/kernels/traverse.py Params mirrors it field for field (the
// loader checks the sizes agree).
// ---------------------------------------------------------------------------

struct Params {
  const float* nodes;
  const float* tris;
  const float* at0;
  const float* at1;
  const float* rays;  // f32[PB,10,8,128]; ANY_SOFT, ANY_PSOFT: f32[PB,4,8,128]
  const float* scal;
  float* out;         // attrs=1: f32[PB,15,8,128]; attrs=0: t f32[PB,8,128]
  int* sidx_out;      // attrs=0: sorted hit index i32[PB,8,128]
  int* cnt_out;       // SOFT, PSOFT, SOFT_MULTI, ANY_SOFT, ANY_PSOFT
  int* mask_out;      // HARD, MULTI, SOFT_MULTI, ANY
  int* counts;
  // The sampling modes' generator key word (the frame seed): read through
  // a pointer, so a launch captured into a CUDA graph reads each replay's
  // seed from the frame's block of constants.
  const uint32_t* seed;
  int num_rays, k, max_iters, stack_size;
  int attrs;  // closest modes: 1 with the attribute rows, 2 with them and
              // the texture lanes (textured meshes), 0 without
  float t_min;
  int nlights, point_mask;  // HARD (bit 0: point light), MULTI
  int spp, zero_stream, disk, n_extra;  // sampling modes
  uint32_t light;  // the generator's second key word (the light index)
};

// ---------------------------------------------------------------------------
// The point-light penumbra walks, PSOFT's phase 2 (fused_shadows.cu) and
// ANY_PSOFT (shadow_rays.cu): one thread per (ray, sample).
//
// A block of PSOFT_PIXELS threads owns PSOFT_PIXELS consecutive rays of the
// packed block. Its threads loop over the flat index q = t, t +
// PSOFT_PIXELS, ... below (rays) x spp and take ray q / spp, sample q % spp,
// so the spp samples of one ray lie in neighbouring lanes: at spp 8 a warp
// walks 4 rays x 8 samples, and a lit ray's walks (each to the end) run
// side by side instead of one after another in one thread. Each occluded
// sample adds 1 to its ray's count in shared memory, written once. A
// sample is the one the thread-per-ray loop drew: Philox keyed by (seed,
// light), counted by (ray index in the packed block, sample), and the
// disk basis recomputed from the same origin in the same order, so every
// count, dropped push and capped walk equals the plain version's.
//
// The walk is anyhit_walk's (slot order, the highest slot pops first, stop
// at the first occluder), with each child record read as two 16-byte
// loads (the rows are f32[Nw,128] and a record is 16 floats at a 64-byte
// offset, so every record is 16-byte aligned once the row block is, which
// the wrappers check).
// ---------------------------------------------------------------------------

#define PSOFT_PIXELS 128
static_assert(PSOFT_PIXELS == 128, "the launches use blocks of 128 threads");

// child_hits over 16-byte loads, in slot order: child c's record is
// (bmin.xyz, bmax.x) and (bmax.yz, ref, pad); ref[c] gets its reference.
// The same empty-slot compare and slab arithmetic as child_hits.
__device__ __forceinline__ unsigned child_hits4(const float* __restrict__ row,
                                                const Ray& r, float t_min,
                                                float cap, int (&ref)[8]) {
  const float4* rec = reinterpret_cast<const float4*>(row);
  unsigned mask = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float4 lo = __ldg(rec + 4 * c);
    float4 hi = __ldg(rec + 4 * c + 1);
    ref[c] = (int)hi.z;
    if (lo.x <= lo.w &&
        slab_box(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, r, t_min, cap))
      mask |= 1u << c;
  }
  return mask;
}

// anyhit_walk over child_hits4: the same walk (pop, the hit children in
// slot order, a leaf tested as it comes, an internal child pushed so the
// highest slot pops first, a push onto a full stack dropped and counted,
// stop at the first occluder), the same occlusion and counters.
__device__ __forceinline__ bool anyhit_walk4(const float* __restrict__ nodes,
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
    int ref[8];
    unsigned mask = child_hits4(row, s, t_min, active ? tmax : -BIG, ref);
    while (mask) {
      int c = __ffs(mask) - 1;
      mask &= mask - 1;
      int rc = ref[0];
#pragma unroll
      for (int j = 1; j < 8; ++j) rc = c == j ? ref[j] : rc;
      if (rc < 0) {
        if (leaf_occluded(tris, max(-rc - 1, 0), k, s, t_min, tmax)) {
          occ = true;
          break;
        }
      } else if (sp < stack_size) {
        stack[sp++] = rc;
      } else {
        ++wc.overflow;
      }
    }
    ++it;
  }
  wc.capped += (!occ && sp > 0);
  return occ;
}

// The disk samples of the npx (<= PSOFT_PIXELS) rays base, base + 1, ...
// that this block owns. org: their biased origins and hit flags, component
// j of ray i at org[j * cs + i] (PSOFT: staged in shared memory; ANY_PSOFT:
// the packed origin block); lp: the light's position(3) and radius. cnt:
// the block's shared counts, zeroed before and read after a barrier.
__device__ __forceinline__ void disk_samples(const Params& P,
                                             const float* org, int cs,
                                             const float* lp, uint32_t light,
                                             float t_min, int base, int npx,
                                             int* cnt, int* stack,
                                             WalkCounts& wc) {
  const int total = npx * P.spp;
  const uint32_t seed = *P.seed;
  for (int q = threadIdx.x; q < total; q += PSOFT_PIXELS) {
    int i = q / P.spp;
    int sample = q - i * P.spp;
    Ray s;
    s.ox = org[i];
    s.oy = org[cs + i];
    s.oz = org[2 * cs + i];
    s.dx = s.dy = s.dz = s.ix = s.iy = s.iz = 0.0f;
    bool hitm = org[3 * cs + i] > 0.0f;
    Disk db = disk_basis(lp, lp[3], s);
    float u1, u2;
    sample_u1u2(seed, light, P.zero_stream, (uint32_t)(base + i),
                (uint32_t)sample, u1, u2);
    float stmax = disk_sample(db, u1, u2, hitm, s);
    if (anyhit_walk4(P.nodes, P.tris, P.k, s, stmax, t_min, P.max_iters,
                     P.stack_size, stack, wc))
      atomicAdd(cnt + i, 1);
  }
}
