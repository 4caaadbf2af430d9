// Host emulation of the CUDA subset that the port's kernels in
// rnb_tpu_torch/csrc/ use, so that tests/test_torch_host_cuda.py can
// compile them with a host C++ compiler and run them on the CPU.
// Every CUDA thread of a block is a std::thread; __syncthreads is a
// barrier of the block, __syncwarp and the warp collectives a barrier
// of the warp; blocks run one after another, so `__shared__` variables
// become function statics. Float intrinsics round each operation once (the
// file is compiled with -ffp-contract=off), as the card does. It checks
// indexing, masking and arithmetic; it says nothing about speed, and a
// race that the hardware's scheduling would expose may pass here.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define RNB_HOST_EMULATION 1
#define __launch_bounds__(...)
#define __grid_constant__
#define __constant__
#define __align__(n) __attribute__((aligned(n)))
#define __shared__ static
#define __restrict__ __restrict

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
// The launch's state is internal to each library built with this header,
// so that libraries loaded side by side (one a ring member, each
// launching while the others do) keep their own.
static thread_local dim3 threadIdx, blockIdx;
static dim3 blockDim, gridDim;
static std::barrier<>* host_block_barrier = nullptr;
static thread_local std::barrier<>* host_warp_barrier = nullptr;
static unsigned host_vote[1024];

inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }
// Every thread's predicate posted, the block met, each thread reading them
// all, the block meeting again before the array is reused.
inline int __syncthreads_or(int predicate) {
  host_vote[threadIdx.x] = predicate != 0;
  host_block_barrier->arrive_and_wait();
  unsigned any = 0;
  for (unsigned i = 0; i < blockDim.x * blockDim.y * blockDim.z; ++i)
    any |= host_vote[i];
  host_block_barrier->arrive_and_wait();
  return static_cast<int>(any);
}
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

// The other warp collectives, on the same vote array: every lane posts
// its value, the warp meets, each lane reads what it needs, the warp
// meets again before the array is reused.
inline int __reduce_add_sync(unsigned, int value) {
  const unsigned first = threadIdx.x & ~31u;
  host_vote[threadIdx.x] = static_cast<unsigned>(value);
  host_warp_barrier->arrive_and_wait();
  unsigned sum = 0;
  for (unsigned i = first; i < first + 32; ++i) sum += host_vote[i];
  host_warp_barrier->arrive_and_wait();
  return static_cast<int>(sum);
}
inline int __shfl_sync(unsigned, int value, int src) {
  host_vote[threadIdx.x] = static_cast<unsigned>(value);
  host_warp_barrier->arrive_and_wait();
  const int got = static_cast<int>(host_vote[(threadIdx.x & ~31u) + src]);
  host_warp_barrier->arrive_and_wait();
  return got;
}
inline int __shfl_up_sync(unsigned, int value, unsigned delta) {
  host_vote[threadIdx.x] = static_cast<unsigned>(value);
  host_warp_barrier->arrive_and_wait();
  const int got = (threadIdx.x & 31u) >= delta
                      ? static_cast<int>(host_vote[threadIdx.x - delta])
                      : value;
  host_warp_barrier->arrive_and_wait();
  return got;
}
inline int __shfl_down_sync(unsigned, int value, unsigned delta) {
  host_vote[threadIdx.x] = static_cast<unsigned>(value);
  host_warp_barrier->arrive_and_wait();
  const int got = (threadIdx.x & 31u) + delta < 32
                      ? static_cast<int>(host_vote[threadIdx.x + delta])
                      : value;
  host_warp_barrier->arrive_and_wait();
  return got;
}
inline bool __all_sync(unsigned, bool predicate) {
  const unsigned first = threadIdx.x & ~31u;
  host_vote[threadIdx.x] = predicate;
  host_warp_barrier->arrive_and_wait();
  bool all = true;
  for (unsigned i = first; i < first + 32; ++i) all = all && host_vote[i];
  host_warp_barrier->arrive_and_wait();
  return all;
}
inline unsigned __match_any_sync(unsigned, int value) {
  const unsigned first = threadIdx.x & ~31u;
  host_vote[threadIdx.x] = static_cast<unsigned>(value);
  host_warp_barrier->arrive_and_wait();
  unsigned same = 0;
  for (unsigned i = first; i < first + 32; ++i)
    if (host_vote[i] == static_cast<unsigned>(value)) same |= 1u << (i - first);
  host_warp_barrier->arrive_and_wait();
  return same;
}
template <typename T>
inline T __ldg(const T* p) { return *p; }
inline unsigned long long __umul64hi(unsigned long long a,
                                     unsigned long long b) {
  return static_cast<unsigned long long>(
      (static_cast<unsigned __int128>(a) * b) >> 64);
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
// Memory: host allocations; pinned memory is host memory the kernels
// address directly. IPC has no host counterpart and is refused.
enum {
  cudaErrorNotSupported = 801,
  cudaIpcMemLazyEnablePeerAccess = 1,
  cudaHostAllocPortable = 1,
  cudaHostAllocMapped = 2
};
struct cudaIpcMemHandle_t { char reserved[64]; };
inline cudaError_t cudaMalloc(void** p, size_t n) {
  *p = std::calloc(n ? n : 1, 1);
  return *p ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaFree(void* p) { std::free(p); return cudaSuccess; }
inline cudaError_t cudaMemset(void* p, int v, size_t n) {
  std::memset(p, v, n);
  return cudaSuccess;
}
inline cudaError_t cudaHostAlloc(void** p, size_t n, unsigned) {
  return cudaMalloc(p, n);
}
inline cudaError_t cudaHostGetDevicePointer(void** d, void* h, unsigned) {
  *d = h;
  return cudaSuccess;
}
inline cudaError_t cudaFreeHost(void* p) { return cudaFree(p); }
inline cudaError_t cudaIpcGetMemHandle(cudaIpcMemHandle_t*, void*) {
  return cudaErrorNotSupported;
}
inline cudaError_t cudaIpcOpenMemHandle(void**, cudaIpcMemHandle_t,
                                        unsigned) {
  return cudaErrorNotSupported;
}
inline cudaError_t cudaIpcCloseMemHandle(void*) {
  return cudaErrorNotSupported;
}
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
