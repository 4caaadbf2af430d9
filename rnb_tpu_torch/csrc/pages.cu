// Gather-from-pages kernel of the paged clip cache and feature pages,
// hand-written for Hopper (sm_90a). Built by rnb_tpu_torch/ops/_kernels.py
// with nvcc into a shared library with a plain C interface, bound with
// ctypes.
//
// rnb_gather_rows -- port of the Pallas kernel `_gather_rows_kernel` /
//   `_gather_rows_pallas` (rnb_tpu/ops/pages.py:92-148).
//   out[i] = slab[src[i]] where src[i] >= 0 (clamped to the slab, as the
//   reference's clipped take), else pool[i]. Moves bytes only, so it is
//   byte-exact for any dtype and any row size; the same kernel serves
//   the clip arena (150,528-byte u8 rows) and the feature arena
//   (1,600-byte float32 logit rows, which the TPU sent through its jnp
//   twin because 1,600 bytes is not a multiple of 128 lanes).
//   Bound: memory. Each output byte is read once (from the slab or the
//   pool) and written once: a 15-row clip pool moves 2 x 2.26 MB, about
//   1.35 us at 3.35 TB/s, so at this size the launch dominates.
//   Design: grid (row chunks, pool rows). Each block reads its own row's
//   source entry from the device table -- no host scalar, so the launch
//   can later sit in a captured CUDA graph -- and copies one chunk of up
//   to 16 KiB of that row with 16-byte vector loads and stores (a warp
//   moves 512 contiguous bytes per instruction). A byte loop in the same
//   kernel covers a row size or an address that is not a multiple of
//   16. A sentinel row never reads the slab. Offsets are 64-bit: the
//   clip slab is about 268 MB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunkBytes = 16384;

__global__ void gather_rows_kernel(const uint8_t* __restrict__ pool,
                                   const uint8_t* __restrict__ slab,
                                   const int32_t* __restrict__ src,
                                   uint8_t* __restrict__ out,
                                   long long slab_rows,
                                   long long row_bytes) {
  const long long row = blockIdx.y;
  const long long s = src[row];
  const uint8_t* from =
      s >= 0 ? slab + (s < slab_rows ? s : slab_rows - 1) * row_bytes
             : pool + row * row_bytes;
  uint8_t* to = out + row * row_bytes;
  const long long begin = static_cast<long long>(blockIdx.x) * kChunkBytes;
  const long long end =
      begin + kChunkBytes < row_bytes ? begin + kChunkBytes : row_bytes;
  long long tail = begin;
  if (((reinterpret_cast<uintptr_t>(from + begin)
        | reinterpret_cast<uintptr_t>(to + begin)) & 15u) == 0) {
    const long long vectors = (end - begin) / 16;
    const uint4* f = reinterpret_cast<const uint4*>(from + begin);
    uint4* t = reinterpret_cast<uint4*>(to + begin);
    for (long long v = threadIdx.x; v < vectors; v += blockDim.x) {
      t[v] = f[v];
    }
    tail = begin + vectors * 16;
  }
  for (long long b = tail + threadIdx.x; b < end; b += blockDim.x) {
    to[b] = from[b];
  }
}

}  // namespace

extern "C" {

const char* rnb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// pool, out: (pool_rows, row_bytes) bytes; slab: (slab_rows, row_bytes);
// src: (pool_rows,) int32 in device memory. pool_rows <= 65535 and
// slab_rows >= 1 (checked by the Python wrapper).
int rnb_gather_rows(const void* pool, const void* slab, const void* src,
                    void* out, long long pool_rows, long long slab_rows,
                    long long row_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pool_rows == 0 || row_bytes == 0) return 0;
  if (pool_rows > 65535 || slab_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(
      static_cast<unsigned>((row_bytes + kChunkBytes - 1) / kChunkBytes),
      static_cast<unsigned>(pool_rows));
  gather_rows_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pool), static_cast<const uint8_t*>(slab),
      static_cast<const int32_t*>(src), static_cast<uint8_t*>(out),
      slab_rows, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
