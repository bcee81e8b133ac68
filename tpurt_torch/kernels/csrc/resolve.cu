// The frame resolve: every output of a fused frame written straight from
// the fused walk launch's packet outputs, for Hopper. It replaces no TPU
// kernel: tpurt decodes the attribute channels, turns the shadow outputs
// into visibility and composites the lights with XLA-fused array code
// (tpurt/passes/gbuffer.py, tpurt/app.py, tpurt/passes/composite.py),
// which the port ran as some two hundred tensor launches a frame
// (kernels/resolve.py: frame_resolve_reference, the plain version).
//
// Inputs, in the launch's packet layout (packet p is the 32x32 pixel tile
// (p / tiles_x, p % tiles_x); element e of a packet is the tile's pixel
// (e / 32, e % 32), as to_packets lays it out):
//
//   attrs   f32[PB,15,8,128]  t, sidx, u, v, uv(2), kd, layer, tri_id,
//                             packed oct n0..n2, geometric normal (the
//                             attrs=1 walk's channels)
//   rays    f32[PB,10,8,128]  o.xyz, d.xyz, clamped 1/d.xyz, t_max
//   shadow_a i32[PB,8,128]    OCCLUDED: HARD's flag; COUNTS: SOFT's or
//                             PSOFT's sample counts; MASK: MULTI's mask;
//                             COUNTS_MASK: SOFT_MULTI's counts
//   shadow_b i32[PB,8,128]    COUNTS_MASK: SOFT_MULTI's mask (bit i =
//                             extra light i); unused otherwise
//   block   f32[16+12L]       the frame's constants (frame_block.py)
//
// and outputs in image layout: position, normal, gnormal, albedo
// f32[H,W,3]; depth, t f32[H,W]; tri_id i32[H,W]; valid u8[H,W];
// shadow f32[L,H,W] (the lights' visibility); image f32[H,W,3].
//
// Design: one block of 256 threads per tile, each thread four pixels of
// it, e = k * 256 + thread: a warp reads 32 neighbouring words of each
// channel and writes one row of the tile into each image plane, so both
// sides coalesce without a transpose through shared memory. Nothing is
// kept between pixels and nothing goes through device memory but the
// inputs and outputs: about 80 bytes in and 84 + 4L out a pixel, so the
// bound is the card's bandwidth.
//
// Bit parity with the plain version: built with --fmad=false, every
// expression keeps the tensor code's order of operations. Two operations
// follow what PyTorch's elementwise kernels do on the device they run on
// (host_div, clamp_min): on the card a division by a host scalar is a
// multiplication by its float reciprocal and clamp(min=) returns NaN or
// fmaxf; on the CPU (the build of tests/test_torch_resolve.py) the
// division is a division and the clamp keeps x unless x < lo.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct ResolveParams {
  const float* attrs;
  const float* rays;
  const int* shadow_a;
  const int* shadow_b;
  const float* block;
  float* position;
  float* normal;
  float* gnormal;
  float* albedo;
  float* depth;
  float* t;
  int* tri_id;
  uint8_t* valid;
  float* shadow;
  float* image;
  int packets, tiles_x, height, width;
  int shadow_kind, n_lights, point_mask, spp;
  float ambient;
};

namespace {

constexpr int TILE = 32;
constexpr int LANES = TILE * TILE;
constexpr int THREADS = 256;
constexpr int ATTR_CH = 15;
constexpr int RAY_CH = 10;
// frame_block.py's layout.
constexpr int CAM_POS = 0, CAM_TARGET = 3, ZFAR = 10, BACKGROUND = 11;
constexpr int LIGHTS = 16, LIGHT_WORDS = 12;

enum ShadowKind { OCCLUDED = 0, COUNTS = 1, MASK = 2, COUNTS_MASK = 3 };

// x / d with d a host scalar, as PyTorch divides on this device.
__device__ __forceinline__ float host_div(float x, float d) {
#ifdef __CUDA_ARCH__
  return x * (1.0f / d);
#else
  return x / d;
#endif
}

// torch.clamp(x, min=lo), as PyTorch clamps on this device.
__device__ __forceinline__ float clamp_min(float x, float lo) {
#ifdef __CUDA_ARCH__
  return isnan(x) ? x : fmaxf(x, lo);
#else
  return x < lo ? lo : x;
#endif
}

// camera.normalize: v / sqrt(x*x + y*y + z*z + 1e-20).
__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float n = sqrtf(x * x + y * y + z * z + (float)1e-20);
  x = x / n;
  y = y / n;
  z = z / n;
}

__device__ __forceinline__ float sign1(float x) {
  return x >= 0.0f ? 1.0f : -1.0f;
}

// shading.unpack_oct12, then oct_decode: one packed channel -> a unit
// normal.
__device__ __forceinline__ void oct_normal(float p, float& x, float& y,
                                           float& z) {
  const float hi = floorf(p * (float)(1.0 / 4096.0));
  const float lo = p - hi * 4096.0f;
  const float ex = hi * (float)(2.0 / 4095.0) - 1.0f;
  const float ey = lo * (float)(2.0 / 4095.0) - 1.0f;
  z = 1.0f - fabsf(ex) - fabsf(ey);
  const bool neg = z < 0.0f;
  x = neg ? (1.0f - fabsf(ey)) * sign1(ex) : ex;
  y = neg ? (1.0f - fabsf(ex)) * sign1(ey) : ey;
  normalize3(x, y, z);
}

// Light l's visibility at a valid pixel from the walk's shadow output.
__device__ __forceinline__ float visibility(const ResolveParams& P, int l,
                                            int a, int b) {
  switch (P.shadow_kind) {
    case OCCLUDED:
      return a > 0 ? 0.0f : 1.0f;
    case COUNTS:
      return 1.0f - host_div((float)a, (float)P.spp);
    case MASK:
      return ((a >> l) & 1) > 0 ? 0.0f : 1.0f;
    default:  // COUNTS_MASK: light 0 counted, extra light i on bit i
      return l == 0 ? 1.0f - host_div((float)a, (float)P.spp)
                    : (((b >> (l - 1)) & 1) > 0 ? 0.0f : 1.0f);
  }
}

}  // namespace

__global__ void __launch_bounds__(THREADS)
    frame_resolve_kernel(const ResolveParams P) {
  const int pk = blockIdx.x;
  const int y0 = pk / P.tiles_x * TILE, x0 = pk % P.tiles_x * TILE;
  const float* __restrict__ blk = P.block;
  // camera.view_depth: the camera's forward axis and far plane.
  float fx = blk[CAM_TARGET] - blk[CAM_POS];
  float fy = blk[CAM_TARGET + 1] - blk[CAM_POS + 1];
  float fz = blk[CAM_TARGET + 2] - blk[CAM_POS + 2];
  normalize3(fx, fy, fz);
  const size_t plane = (size_t)P.height * P.width;
  for (int k = 0; k < LANES / THREADS; ++k) {
    const int e = k * THREADS + threadIdx.x;
    const int y = y0 + e / TILE, x = x0 + e % TILE;
    if (y >= P.height || x >= P.width) continue;
    const size_t pix = (size_t)y * P.width + x;
    const float* __restrict__ ch = P.attrs + (size_t)pk * ATTR_CH * LANES + e;
    const float* __restrict__ ray = P.rays + (size_t)pk * RAY_CH * LANES + e;

    // traverse._attr_channels and gbuffer.gbuf_from_attr_channels.
    const bool valid = (int)ch[1 * LANES] >= 0;
    const float t = valid ? ch[0] : INFINITY;
    const float tt = valid ? t : 0.0f;
    const float dx = ray[3 * LANES], dy = ray[4 * LANES],
                dz = ray[5 * LANES];
    const float px = ray[0] + dx * tt, py = ray[LANES] + dy * tt,
                pz = ray[2 * LANES] + dz * tt;
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;  // smooth normal
    float gx = 0.0f, gy = 0.0f, gz = 0.0f;  // geometric normal
    float ar = 0.0f, ag = 0.0f, ab = 0.0f;  // albedo
    if (valid) {
      float n0x, n0y, n0z, n1x, n1y, n1z, n2x, n2y, n2z;
      oct_normal(ch[9 * LANES], n0x, n0y, n0z);
      oct_normal(ch[10 * LANES], n1x, n1y, n1z);
      oct_normal(ch[11 * LANES], n2x, n2y, n2z);
      const float u = ch[2 * LANES], v = ch[3 * LANES];
      sx = n0x + u * (n1x - n0x) + v * (n2x - n0x);
      sy = n0y + u * (n1y - n0y) + v * (n2y - n0y);
      sz = n0z + u * (n1z - n0z) + v * (n2z - n0z);
      normalize3(sx, sy, sz);
      gx = ch[12 * LANES];
      gy = ch[13 * LANES];
      gz = ch[14 * LANES];
      normalize3(gx, gy, gz);
      // shading.unpack_rgb
      const float kd = ch[6 * LANES];
      const float r = floorf(host_div(kd, 65536.0f));
      const float g = floorf(host_div(kd - r * 65536.0f, 256.0f));
      const float b = kd - r * 65536.0f - g * 256.0f;
      ar = host_div(r, 255.0f);
      ag = host_div(g, 255.0f);
      ab = host_div(b, 255.0f);
    }
    // gbuffer._viewer_facing
    const float s = -(gx * dx + gy * dy + gz * dz);
    const float facing = (float)((0.0f < s) - (s < 0.0f));
    const float flip = facing == 0.0f ? 1.0f : facing;
    sx = sx * flip;
    sy = sy * flip;
    sz = sz * flip;
    gx = gx * flip;
    gy = gy * flip;
    gz = gz * flip;
    const float depth =
        valid ? (px - blk[CAM_POS]) * fx + (py - blk[CAM_POS + 1]) * fy +
                    (pz - blk[CAM_POS + 2]) * fz
              : blk[ZFAR];

    P.position[3 * pix] = px;
    P.position[3 * pix + 1] = py;
    P.position[3 * pix + 2] = pz;
    P.normal[3 * pix] = sx;
    P.normal[3 * pix + 1] = sy;
    P.normal[3 * pix + 2] = sz;
    P.gnormal[3 * pix] = gx;
    P.gnormal[3 * pix + 1] = gy;
    P.gnormal[3 * pix + 2] = gz;
    P.albedo[3 * pix] = ar;
    P.albedo[3 * pix + 1] = ag;
    P.albedo[3 * pix + 2] = ab;
    P.depth[pix] = depth;
    P.t[pix] = t;
    P.tri_id[pix] = valid ? (int)ch[8 * LANES] : -1;
    P.valid[pix] = valid;

    // The visibility, then app.composite_lights: light 0's term with the
    // ambient, each extra light's term added on valid pixels.
    const size_t q = (size_t)pk * LANES + e;
    const int sa = P.shadow_a[q];
    const int sb = P.shadow_kind == COUNTS_MASK ? P.shadow_b[q] : 0;
    float ir = blk[BACKGROUND], ig = blk[BACKGROUND + 1],
          ib = blk[BACKGROUND + 2];
    for (int l = 0; l < P.n_lights; ++l) {
      const float vis = valid ? visibility(P, l, sa, sb) : 1.0f;
      P.shadow[l * plane + pix] = vis;
      if (!valid) continue;
      const float* __restrict__ L = blk + LIGHTS + LIGHT_WORDS * l;
      float lx, ly, lz, falloff;
      if ((P.point_mask >> l) & 1) {
        lx = L[3] - px;
        ly = L[4] - py;
        lz = L[5] - pz;
        const float dist2 = clamp_min(lx * lx + ly * ly + lz * lz,
                                      (float)1e-8);
        const float len = sqrtf(dist2);
        lx = lx / len;
        ly = ly / len;
        lz = lz / len;
        falloff = 1.0f / dist2;
      } else {
        lx = L[0];
        ly = L[1];
        lz = L[2];
        falloff = 1.0f;
      }
      const float ndl = clamp_min(sx * lx + sy * ly + sz * lz, 0.0f);
      const float w = ndl * falloff * vis;
      const float amb = l == 0 ? P.ambient : 0.0f;
      const float cr = ar * (w * (L[6] * L[9]) + amb);
      const float cg = ag * (w * (L[7] * L[9]) + amb);
      const float cb = ab * (w * (L[8] * L[9]) + amb);
      if (l == 0) {
        ir = cr;
        ig = cg;
        ib = cb;
      } else {
        ir = ir + cr;
        ig = ig + cg;
        ib = ib + cb;
      }
    }
    P.image[3 * pix] = ir;
    P.image[3 * pix + 1] = ig;
    P.image[3 * pix + 2] = ib;
  }
}

extern "C" int tpurt_resolve_params_size() {
  return (int)sizeof(ResolveParams);
}

// Launches the resolve of P->packets tiles on ``stream``; allocates
// nothing and returns cudaGetLastError() (cudaErrorInvalidValue for an
// unknown shadow kind or a light count outside 1..32).
extern "C" int tpurt_frame_resolve_launch(const ResolveParams* P,
                                          void* stream) {
  if (P->shadow_kind < OCCLUDED || P->shadow_kind > COUNTS_MASK ||
      P->n_lights < 1 || P->n_lights > 32)
    return (int)cudaErrorInvalidValue;
  if (P->packets <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  frame_resolve_kernel<<<P->packets, THREADS, 0, st>>>(*P);
  return (int)cudaGetLastError();
}
