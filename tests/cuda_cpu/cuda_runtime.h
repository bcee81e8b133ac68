// A CPU stand-in for the CUDA runtime, so that the walk kernels of
// tpurt_torch/kernels/csrc compile with g++ and run on the CPU
// (tests/test_torch_walk_sources_cpu.py): each block's threads run as
// std::threads that meet at a std::barrier for __syncthreads, blocks one
// after another; __shared__ arrays are function statics (one block at a
// time); the launches k<<<grid, block, 0, st>>>(args) are rewritten into
// cpu_launch(grid, block, [&] { k(args); }) before compiling.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 {
  float x, y, z, w;
};
struct uint2 {
  uint32_t x, y;
};
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }

typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributePreferredSharedMemoryCarveout = 9 };
inline int cudaGetLastError() { return cudaSuccess; }
template <class F>
inline int cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* cpu_block_barrier = nullptr;

inline void __syncthreads() { cpu_block_barrier->arrive_and_wait(); }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}
inline int __ffs(int x) { return __builtin_ffs(x); }

inline void cpu_launch(dim3 grid, dim3 block, std::function<void()> kernel) {
  blockDim = block;
  gridDim = grid;
  for (unsigned b = 0; b < grid.x; ++b) {
    std::barrier<> bar(block.x);
    cpu_block_barrier = &bar;
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block.x; ++t)
      threads.emplace_back([&, t, b] {
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        kernel();
      });
    for (auto& th : threads) th.join();
  }
}
