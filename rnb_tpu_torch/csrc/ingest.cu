// Ingest kernels of the yuv420 serving path, hand-written for Hopper
// (sm_90a). Built by rnb_tpu_torch/ops/_kernels.py with nvcc into a
// shared library with a plain C interface, bound with ctypes.
//
// rnb_normalize_u8 -- port of the Pallas kernel `_normalize_kernel` /
//   `_normalize_u8_pallas` (rnb_tpu/ops/preprocess.py:48-70).
//   Computes y = (2x - 255) * (1/255) rounded once to bf16, row by row;
//   rows at or past `rows_valid` store zeros and do no arithmetic, so
//   the same kernel also stands in for the ragged Pallas kernel
//   `_ragged_normalize_kernel` (rnb_tpu/ops/ragged.py:157-208).
//   Bound: memory. One byte read and two written per element, no reuse
//   (48 clip rows: 14.5 MB in, 28.9 MB out, ~13 us at 3.35 TB/s).
//   Design: every thread moves one 16-byte vector in (uint4) and two
//   16-byte vectors out, so a warp touches 512 contiguous input bytes
//   and 1 KiB of output per instruction -- full-width coalesced
//   transactions; a grid-stride loop keeps the launch small. The
//   arithmetic is written with __fmul_rn/__fsub_rn and
//   __float2bfloat16_rn so `--fmad` cannot contract it: the result is
//   bit-identical to the plain PyTorch version and to the JAX reference.
//
// rnb_yuv420_to_rgb_u8 -- replaces the jnp colourspace converter
//   `yuv420_to_rgb_u8` (rnb_tpu/ops/yuv.py:48-69), which XLA fused into
//   the TPU program and which has no library counterpart here.
//   Packed 4:2:0 planes (Y, then U and V at half resolution, per frame)
//   -> RGB u8: nearest 2x chroma upsample, full-range BT.601 in the
//   numpy op order, clip to [0, 255], truncate to u8. Rows at or past
//   `rows_valid` are converted as if every byte were zero -- exactly
//   what ragged_mask_rows followed by the converter produces -- so the
//   pool tail never has to be zeroed on the host.
//   Bound: memory. 1.5 bytes read and 3 written per pixel (8-frame
//   112x112 row: 150,528 B in, 301,056 B out).
//   Design: one thread per 2x2 luma quad, which shares one U and one V
//   sample: the chroma upsample becomes register reuse, and each thread
//   writes two runs of 6 contiguous bytes. Simple first: the stores are
//   not vectorized (a later change fuses this kernel with the normalize
//   and keeps the RGB bytes out of device memory altogether).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ __nv_bfloat16 normalize_one(uint32_t byte) {
  // (2x - 255) is exact in float32; one rounding multiply follows.
  const float t = __fsub_rn(__fmul_rn(static_cast<float>(byte), 2.0f),
                            255.0f);
  return __float2bfloat16_rn(
      __fmul_rn(t, static_cast<float>(1.0 / 255.0)));
}

__global__ void normalize_u8_kernel(const uint4* __restrict__ x,
                                    uint4* __restrict__ out,
                                    long long vectors,
                                    long long vectors_per_row,
                                    long long rows_valid) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       v < vectors; v += stride) {
    uint4 lo = make_uint4(0, 0, 0, 0);
    uint4 hi = make_uint4(0, 0, 0, 0);
    if (v / vectors_per_row < rows_valid) {
      const uint4 in = x[v];
      const uint32_t words[4] = {in.x, in.y, in.z, in.w};
      uint32_t packed[8];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint32_t b0 = (words[w] >> (16 * p)) & 0xffu;
          const uint32_t b1 = (words[w] >> (16 * p + 8)) & 0xffu;
          const __nv_bfloat16 y0 = normalize_one(b0);
          const __nv_bfloat16 y1 = normalize_one(b1);
          packed[2 * w + p] =
              static_cast<uint32_t>(__bfloat16_as_ushort(y0))
              | (static_cast<uint32_t>(__bfloat16_as_ushort(y1)) << 16);
        }
      }
      lo = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      hi = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
    out[2 * v] = lo;
    out[2 * v + 1] = hi;
  }
}

__device__ __forceinline__ uint8_t clip_to_u8(float value) {
  // jnp.clip(rgb, 0, 255).astype(uint8): clamp, then truncate.
  return static_cast<uint8_t>(fminf(fmaxf(value, 0.0f), 255.0f));
}

__global__ void yuv420_to_rgb_u8_kernel(const uint8_t* __restrict__ packed,
                                        uint8_t* __restrict__ out,
                                        long long quads, int frames,
                                        int height, int width,
                                        int rows_valid) {
  const int half_h = height / 2;
  const int half_w = width / 2;
  const long long plane = static_cast<long long>(height) * width;
  const long long quads_per_frame = static_cast<long long>(half_h) * half_w;
  const long long frame_bytes = plane + 2 * quads_per_frame;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       q < quads; q += stride) {
    const long long frame = q / quads_per_frame;  // row * frames + f
    const long long in_frame = q - frame * quads_per_frame;
    const int qy = static_cast<int>(in_frame / half_w);
    const int qx = static_cast<int>(in_frame - static_cast<long long>(qy)
                                               * half_w);
    const bool valid = frame / frames < rows_valid;
    const uint8_t* src = packed + frame * frame_bytes;
    uint8_t* dst = out + frame * plane * 3;

    float u = 0.0f, v = 0.0f;
    if (valid) {
      u = static_cast<float>(src[plane + in_frame]);
      v = static_cast<float>(src[plane + quads_per_frame + in_frame]);
    }
    const float uf = __fsub_rn(u, 128.0f);
    const float vf = __fsub_rn(v, 128.0f);
    // numpy op order: y + 1.402v; (y - 0.344136u) - 0.714136v; y + 1.772u,
    // each coefficient the float32 rounding of the double, as numpy
    // rounds a Python float against a float32 array
    const float dr = __fmul_rn(static_cast<float>(1.402), vf);
    const float dg1 = __fmul_rn(static_cast<float>(0.344136), uf);
    const float dg2 = __fmul_rn(static_cast<float>(0.714136), vf);
    const float db = __fmul_rn(static_cast<float>(1.772), uf);
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const long long pix_row = static_cast<long long>(2 * qy + dy) * width;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const long long pix = pix_row + 2 * qx + dx;
        const float y = valid ? static_cast<float>(src[pix]) : 0.0f;
        uint8_t* rgb = dst + pix * 3;
        rgb[0] = clip_to_u8(__fadd_rn(y, dr));
        rgb[1] = clip_to_u8(__fsub_rn(__fsub_rn(y, dg1), dg2));
        rgb[2] = clip_to_u8(__fadd_rn(y, db));
      }
    }
  }
}

int blocks_for(long long work) {
  // Enough blocks to fill every SM several times over; the grid-stride
  // loops cover the rest.
  const long long wanted = (work + kThreads - 1) / kThreads;
  return static_cast<int>(wanted < 132 * 32 ? wanted : 132 * 32);
}

}  // namespace

extern "C" {

const char* rnb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (rows, per_row) u8; out: (rows, per_row) bf16. per_row % 16 == 0,
// both pointers 16-byte aligned (checked by the Python wrapper).
int rnb_normalize_u8(const void* x, void* out, long long rows,
                     long long per_row, long long rows_valid, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vectors_per_row = per_row / 16;
  const long long vectors = rows * vectors_per_row;
  if (vectors == 0) return 0;
  normalize_u8_kernel<<<blocks_for(vectors), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), vectors,
      vectors_per_row, rows_valid);
  return static_cast<int>(cudaGetLastError());
}

// packed: (rows, frames, H*W*3/2) u8; out: (rows, frames, H, W, 3) u8.
int rnb_yuv420_to_rgb_u8(const void* packed, void* out, int rows,
                         int frames, int height, int width, int rows_valid,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long quads = static_cast<long long>(rows) * frames
                          * (height / 2) * (width / 2);
  if (quads == 0) return 0;
  yuv420_to_rgb_u8_kernel<<<blocks_for(quads), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<uint8_t*>(out),
      quads, frames, height, width, rows_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
