// Ragged normalize kernel of the rgb pixel path, hand-written for Hopper
// (sm_90a). Built by rnb_tpu_torch/ops/_kernels.py with nvcc into a
// shared library with a plain C interface, bound with ctypes.
//
// rnb_ragged_normalize_u8 -- port of the Pallas kernel
//   `_ragged_normalize_kernel` / `_ragged_normalize_pallas`
//   (rnb_tpu/ops/ragged.py:157-208).
//   A (rows, per_row) uint8 row pool -> a bf16 pool of the same shape.
//   Rows below `rows_valid` hold y = (2x - 255) * (1/255), rounded once
//   to bf16; rows at or past it are stored as zeros without reading the
//   input and without arithmetic (the reference's `pl.when(row >=
//   rows_valid)` branch), so whatever the pool tail holds never reaches
//   the result.
//   What sets it apart from rnb_normalize_u8 (ingest.cu): `rows_valid`
//   is a pointer to an int32 in device memory, read by every block
//   before it takes its branch -- the counterpart of the reference's
//   scalar prefetch (PrefetchScalarGridSpec, num_scalar_prefetch=1). The
//   launch arguments (pointers, rows, per_row) are then the same for
//   every emission of a stage, as the reference's one executable is, and
//   the launch can sit in a captured CUDA graph. The kernel clamps the
//   value to [0, rows].
//   Bound: memory. A valid row reads one byte and writes two per
//   element, a pad row only writes (15 clip rows of 301,056 bytes, all
//   valid: 4.5 MB in, 9.0 MB out, ~4 us at 3.35 TB/s).
//   Design: grid (chunks of a row, pool rows), as the reference's grid
//   is (rows, sublane chunks), but the block is shaped for this card: a
//   chunk is 16 KiB of input, each thread moves one 16-byte vector in
//   (uint4) and two 16-byte vectors out per step, so a warp touches 512
//   contiguous input bytes and 1 KiB of output per instruction. A byte
//   loop in the same kernel covers a row size or an address that is not
//   a multiple of 16, so any row size is served. The arithmetic is
//   spelled __fmul_rn/__fsub_rn and __float2bfloat16_rn so `--fmad`
//   cannot contract it: valid rows are bit-identical to rnb_normalize_u8,
//   to the plain PyTorch version and to the JAX reference.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunkBytes = 16384;

__device__ __forceinline__ uint32_t normalize_bits(uint32_t byte) {
  // (2x - 255) is exact in float32; one rounding multiply follows.
  const float t = __fsub_rn(__fmul_rn(static_cast<float>(byte), 2.0f),
                            255.0f);
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(
      __fmul_rn(t, static_cast<float>(1.0 / 255.0)))));
}

__global__ void ragged_normalize_u8_kernel(
    const uint8_t* __restrict__ x, uint16_t* __restrict__ out,
    const int32_t* __restrict__ rows_valid_ptr, long long rows,
    long long per_row) {
  const long long row = blockIdx.y;
  long long rows_valid = *rows_valid_ptr;
  rows_valid = rows_valid < 0 ? 0 : (rows_valid > rows ? rows : rows_valid);
  const long long begin = static_cast<long long>(blockIdx.x) * kChunkBytes;
  const long long end =
      begin + kChunkBytes < per_row ? begin + kChunkBytes : per_row;
  const uint8_t* from = x + row * per_row;
  uint16_t* to = out + row * per_row;
  const bool out_aligned =
      (reinterpret_cast<uintptr_t>(to + begin) & 15u) == 0;
  long long tail = begin;

  if (row >= rows_valid) {
    // a pad row: zeros out, nothing read, nothing computed
    if (out_aligned) {
      const long long vectors = (end - begin) / 8;  // 8 bf16 per uint4
      uint4* t = reinterpret_cast<uint4*>(to + begin);
      for (long long v = threadIdx.x; v < vectors; v += blockDim.x) {
        t[v] = make_uint4(0, 0, 0, 0);
      }
      tail = begin + vectors * 8;
    }
    for (long long e = tail + threadIdx.x; e < end; e += blockDim.x) {
      to[e] = 0;
    }
    return;
  }

  if (out_aligned
      && (reinterpret_cast<uintptr_t>(from + begin) & 15u) == 0) {
    const long long vectors = (end - begin) / 16;
    const uint4* f = reinterpret_cast<const uint4*>(from + begin);
    uint4* t = reinterpret_cast<uint4*>(to + begin);
    for (long long v = threadIdx.x; v < vectors; v += blockDim.x) {
      const uint4 in = f[v];
      const uint32_t words[4] = {in.x, in.y, in.z, in.w};
      uint32_t packed[8];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint32_t b0 = (words[w] >> (16 * p)) & 0xffu;
          const uint32_t b1 = (words[w] >> (16 * p + 8)) & 0xffu;
          packed[2 * w + p] = normalize_bits(b0)
                              | (normalize_bits(b1) << 16);
        }
      }
      t[2 * v] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      t[2 * v + 1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
    tail = begin + vectors * 16;
  }
  for (long long e = tail + threadIdx.x; e < end; e += blockDim.x) {
    to[e] = static_cast<uint16_t>(normalize_bits(from[e]));
  }
}

}  // namespace

extern "C" {

const char* rnb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (rows, per_row) u8; out: (rows, per_row) bf16; rows_valid: one int32
// in device memory. rows <= 65535 (checked by the Python wrapper too).
int rnb_ragged_normalize_u8(const void* x, void* out, const void* rows_valid,
                            long long rows, long long per_row, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0 || per_row == 0) return 0;
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(
      static_cast<unsigned>((per_row + kChunkBytes - 1) / kChunkBytes),
      static_cast<unsigned>(rows));
  ragged_normalize_u8_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint16_t*>(out),
      static_cast<const int32_t*>(rows_valid), rows, per_row);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
