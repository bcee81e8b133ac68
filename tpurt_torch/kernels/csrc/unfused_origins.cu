// The unfused frame's shadow origins: the in-kernel sampler's input block
// written straight from the closest attribute walk's packets, for Hopper.
// It replaces no TPU kernel: tpurt unpacks the walk's channels, decodes
// the G-buffer, biases its positions along the viewer-facing geometric
// normal and packs them for the sampler with array code
// (tpurt/passes/gbuffer.py, tpurt/passes/shadow.py), which the port ran
// as some hundred tensor launches a frame (kernels/resolve.py:
// unfused_origins_reference, the plain version).
//
// Inputs, in the walk's packet layout (packet p is the 32x32 pixel tile
// (p / tiles_x, p % tiles_x); element e of a packet is the tile's pixel
// (e / 32, e % 32), as to_packets lays it out):
//
//   attrs   f32[P,15,8,128]   the attrs=1 walk's channels, of which this
//                             kernel reads t (0), the sorted index (1) and
//                             the geometric normal (12..14)
//   rays    f32[P,10,8,128]   o.xyz, d.xyz, clamped 1/d.xyz, t_max
//   bias    f32[]             the frame block's shadow bias word
//
// and the output, in the same layout:
//
//   out     f32[P,4,8,128]    position + viewer-facing gnormal * bias
//                             (xyz), valid as 1.0 / 0.0; zeros at the
//                             pixels of a ragged tile that lie outside
//                             the image, as to_packets pads them
//
// Design: one thread per element, 256 threads a block, four blocks a
// packet: a warp reads 32 neighbouring words of each channel and writes
// 32 of each output row, so every access coalesces. About 44 bytes in and
// 16 out a pixel, so the bound is the card's bandwidth.
//
// Bit parity with the plain version: built with --fmad=false, every
// expression keeps the tensor code's order of operations; the bias is a
// float32 word, as PyTorch rounds the host scalar it multiplies by.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct OriginsParams {
  const float* attrs;
  const float* rays;
  const float* bias;
  float* out;
  int packets, tiles_x, height, width;
};

namespace {

constexpr int TILE = 32;
constexpr int LANES = TILE * TILE;
constexpr int THREADS = 256;
constexpr int ATTR_CH = 15;
constexpr int RAY_CH = 10;
constexpr int OUT_CH = 4;

// camera.normalize: v / sqrt(x*x + y*y + z*z + 1e-20).
__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float n = sqrtf(x * x + y * y + z * z + (float)1e-20);
  x = x / n;
  y = y / n;
  z = z / n;
}

}  // namespace

__global__ void __launch_bounds__(THREADS)
    unfused_origins_kernel(const OriginsParams P) {
  const int pk = blockIdx.x / (LANES / THREADS);
  const int e = blockIdx.x % (LANES / THREADS) * THREADS + threadIdx.x;
  const int y = pk / P.tiles_x * TILE + e / TILE;
  const int x = pk % P.tiles_x * TILE + e % TILE;
  float* __restrict__ out = P.out + (size_t)pk * OUT_CH * LANES + e;
  if (y >= P.height || x >= P.width) {
    out[0] = 0.0f;
    out[LANES] = 0.0f;
    out[2 * LANES] = 0.0f;
    out[3 * LANES] = 0.0f;
    return;
  }
  const float* __restrict__ ch = P.attrs + (size_t)pk * ATTR_CH * LANES + e;
  const float* __restrict__ ray = P.rays + (size_t)pk * RAY_CH * LANES + e;

  // traverse._attr_channels and gbuffer.gbuf_from_attr_channels: the
  // position and the geometric normal turned toward the viewer.
  const bool valid = (int)ch[LANES] >= 0;
  const float tt = valid ? ch[0] : 0.0f;
  const float dx = ray[3 * LANES], dy = ray[4 * LANES], dz = ray[5 * LANES];
  const float px = ray[0] + dx * tt, py = ray[LANES] + dy * tt,
              pz = ray[2 * LANES] + dz * tt;
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  if (valid) {
    gx = ch[12 * LANES];
    gy = ch[13 * LANES];
    gz = ch[14 * LANES];
    normalize3(gx, gy, gz);
  }
  // gbuffer._viewer_facing
  const float s = -(gx * dx + gy * dy + gz * dz);
  const float facing = (float)((0.0f < s) - (s < 0.0f));
  const float flip = facing == 0.0f ? 1.0f : facing;
  gx = gx * flip;
  gy = gy * flip;
  gz = gz * flip;

  // shadow.shadow_pass: position + gnormal * bias, then
  // traverse._pack_soft_origins.
  const float b = *P.bias;
  out[0] = px + gx * b;
  out[LANES] = py + gy * b;
  out[2 * LANES] = pz + gz * b;
  out[3 * LANES] = valid ? 1.0f : 0.0f;
}

extern "C" int tpurt_origins_params_size() {
  return (int)sizeof(OriginsParams);
}

// Launches the origins of P->packets tiles on ``stream``; allocates
// nothing and returns cudaGetLastError().
extern "C" int tpurt_unfused_origins_launch(const OriginsParams* P,
                                            void* stream) {
  if (P->packets <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  unfused_origins_kernel<<<P->packets * (LANES / THREADS), THREADS, 0, st>>>(
      *P);
  return (int)cudaGetLastError();
}
