// Host emulation of the CUDA subset that the port's kernels in
// rnb_tpu_torch/csrc/ use, so that tests/test_torch_host_cuda.py can
// compile them with a host C++ compiler and run them on the CPU.
// Every CUDA thread of a block is a std::thread; __syncthreads is a
// barrier of the block, __syncwarp and the warp vote a barrier of the
// warp; blocks run one after another, so `__shared__` variables become
// function statics. Float intrinsics round each operation once (the
// file is compiled with -ffp-contract=off), as the card does. It checks
// indexing, masking and arithmetic; it says nothing about speed, and a
// race that the hardware's scheduling would expose may pass here.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __constant__
#define __align__(n) __attribute__((aligned(n)))
#define __shared__ static
#define __restrict__ __restrict

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* host_block_barrier = nullptr;
inline thread_local std::barrier<>* host_warp_barrier = nullptr;
inline unsigned host_vote[1024];

inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  host_warp_barrier->arrive_and_wait();
}
inline unsigned __reduce_max_sync(unsigned, unsigned value) {
  const unsigned first = threadIdx.x & ~31u;
  host_vote[threadIdx.x] = value;
  host_warp_barrier->arrive_and_wait();
  unsigned most = 0;
  for (unsigned i = first; i < first + 32; ++i)
    most = host_vote[i] > most ? host_vote[i] : most;
  host_warp_barrier->arrive_and_wait();
  return most;
}

struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(16) float4 { float x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}

inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __int2float_rn(int v) { return static_cast<float>(v); }
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
#include <math.h>  // floorf, fminf, fmaxf, truncf

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host emulation"; }
template <typename Kernel>
cudaError_t cudaFuncSetAttribute(Kernel, int, int) { return cudaSuccess; }

// What `kernel<<<grid, block, smem, stream>>>(args)` becomes.
inline void host_launch(dim3 grid, dim3 block, size_t, cudaStream_t,
                        const std::function<void()>& body) {
  gridDim = grid;
  blockDim = block;
  const unsigned n = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> block_barrier(n);
        host_block_barrier = &block_barrier;
        std::vector<std::unique_ptr<std::barrier<>>> warps;
        for (unsigned w = 0; 32 * w < n; ++w)
          warps.emplace_back(new std::barrier<>(n - 32 * w < 32 ? n - 32 * w
                                                                 : 32));
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < n; ++t)
          threads.emplace_back([&, t] {
            blockIdx = dim3(bx, by, bz);
            threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                             t / (block.x * block.y));
            host_warp_barrier = warps[t / 32].get();
            body();
          });
        for (auto& thread : threads) thread.join();
      }
}
inline void host_launch(dim3 grid, dim3 block,
                        const std::function<void()>& body) {
  host_launch(grid, block, 0, nullptr, body);
}
inline void host_launch(dim3 grid, dim3 block, size_t smem,
                        const std::function<void()>& body) {
  host_launch(grid, block, smem, nullptr, body);
}
