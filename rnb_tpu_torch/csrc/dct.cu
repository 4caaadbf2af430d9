// Ingest kernels of the dct serving path, hand-written for Hopper
// (sm_90a). Built by rnb_tpu_torch/ops/_kernels.py with nvcc into a
// shared library with a plain C interface, bound with ctypes.
//
// rnb_dct_unpack -- replaces the jnp scatter `unpack_dct_rows`
//   (rnb_tpu/ops/dct.py:213-264), which XLA fused into the TPU program.
//   Packed int16 wire rows (per frame: NB block counts, C values, C
//   zigzag positions) -> block-tiled int32 coefficient planes (Y, then
//   U and V at half resolution), every slot written, zeros included.
//   Design: one CTA per (row, frame) and one thread per 8x8 block. The
//   CTA clamps the counts to [0, 64] and scans them in shared memory;
//   block b then owns exactly the entries [cum[b-1], cum[b]) cut to
//   [0, min(total, C)), which its thread walks in order into a 64-slot
//   slab in shared memory (positions clamped to [0, 63], zigzag ->
//   natural). Walking in order makes the last entry on a slot win with
//   no atomics, so the result is bitwise the plain version's on any
//   input. The slab then goes out as eight 32-byte tile rows. Rows at
//   or past `rows_valid` get no CTA: nothing reads or writes them.
//   Bound: memory. The counts and the kept entries in, 6 bytes per
//   pixel of int32 planes out (15 rows x 8 frames of 112x112: about
//   1 MB in, 9.03 MB out, ~3 us at 3.35 TB/s).
//
// rnb_dct_convert -- port of the Pallas kernel `_dct_kernel` /
//   `_dct_convert_pallas` (rnb_tpu/ops/dct.py:312-374). Per 8x8 block a
//   separable 8-point IDCT (rows, then columns) on the float32 basis
//   kIdct8, `floor(p + 128.5)` clipped to [0, 255], BT.601 with the
//   chroma read through the nearest 2x map, clip and truncate, then
//   the normalize (2q - 255) * (1/255) rounded once to bf16 or f32.
//   The reference multiplies whole planes by block-diagonal I (x) M8
//   bases, 14x the useful FLOPs at 112x112; per block only the 8-term
//   sums remain. Its chroma basis repeats rows; computing chroma at
//   half resolution and reading it through the 2x map gives the same
//   values. Rows at or past `rows_valid` store zeros without reading.
//   Design: one CTA per (row, frame, 16-row MCU stripe). The stripe's
//   coefficients (16 luma rows, 8 rows of each chroma plane) are
//   contiguous in the tiled planes, so the CTA reads them with
//   coalesced loads into shared memory, runs the row pass and the
//   column pass there, and writes the stripe's 16 x W x 3 outputs as
//   one contiguous run. Every multiply and add is spelled
//   __fmul_rn/__fadd_rn/__fsub_rn so `--fmad` cannot contract it (the
//   BT.601 and normalize roundings then match the plain version's).
//   Bound: memory. 6 bytes per pixel of int32 planes in, 6 (bf16) or
//   12 (f32) out; the IDCT is ~600 kFLOP per 112x112 frame, ~1 us for
//   a 15-row pool at 67 TFLOP/s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kConvertThreads = 256;
constexpr int kMaxUnpackThreads = 512;
// a thread's 64-slot slab is padded to 65 words: thread t's slot k sits
// in bank (t + k) % 32, so no two lanes of a warp share a bank
constexpr int kSlabStride = 65;

// zigzag scan position -> natural (row-major u*8+v) coefficient index
__constant__ int kZigzagNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// M[y][u] = c(u)/2 cos((2y+1) u pi / 16) in float32, row-major: the
// values of _idct_basis8() in rnb_tpu_torch/ops/dct.py, to the bit
__constant__ float kIdct8[64] = {
    0.353553385f, 0.490392625f, 0.461939752f, 0.415734798f, 0.353553385f, 0.277785122f, 0.191341713f, 0.0975451618f,
    0.353553385f, 0.415734798f, 0.191341713f, -0.0975451618f, -0.353553385f, -0.490392625f, -0.461939752f, -0.277785122f,
    0.353553385f, 0.277785122f, -0.191341713f, -0.490392625f, -0.353553385f, 0.0975451618f, 0.461939752f, 0.415734798f,
    0.353553385f, 0.0975451618f, -0.461939752f, -0.277785122f, 0.353553385f, 0.415734798f, -0.191341713f, -0.490392625f,
    0.353553385f, -0.0975451618f, -0.461939752f, 0.277785122f, 0.353553385f, -0.415734798f, -0.191341713f, 0.490392625f,
    0.353553385f, -0.277785122f, -0.191341713f, 0.490392625f, -0.353553385f, -0.0975451618f, 0.461939752f, -0.415734798f,
    0.353553385f, -0.415734798f, 0.191341713f, 0.0975451618f, -0.353553385f, 0.490392625f, -0.461939752f, 0.277785122f,
    0.353553385f, -0.490392625f, 0.461939752f, -0.415734798f, 0.353553385f, -0.277785122f, 0.191341713f, -0.0975451618f,
};

__device__ __forceinline__ int clamp_count(int16_t c) {
  const int v = c;
  return v < 0 ? 0 : (v > 64 ? 64 : v);
}

__global__ void dct_unpack_kernel(const int16_t* __restrict__ wire,
                                  int32_t* __restrict__ ycoef,
                                  int32_t* __restrict__ ucoef,
                                  int32_t* __restrict__ vcoef,
                                  int height, int width, int coeffs) {
  extern __shared__ int smem[];
  int* scan = smem;
  int* slab = smem + blockDim.x + threadIdx.x * kSlabStride;
  const int tid = threadIdx.x;
  const int luma_bw = width / 8;
  const int ny = (height / 8) * luma_bw;
  const int chroma_bw = width / 16;
  const int nc = (height / 16) * chroma_bw;
  const int nb = ny + 2 * nc;
  const long long frame = blockIdx.x;  // row * frames + f
  const int16_t* counts = wire + frame * (nb + 2LL * coeffs);
  const int16_t* vals = counts + nb;
  const int16_t* poss = vals + coeffs;

  // this thread's blocks: [b0, b1), one block when blockDim >= nb
  const int chunk = (nb + blockDim.x - 1) / blockDim.x;
  const int b0 = min(tid * chunk, nb);
  const int b1 = min(b0 + chunk, nb);
  int local = 0;
  for (int b = b0; b < b1; ++b) local += clamp_count(counts[b]);

  // inclusive scan of the per-thread sums (Hillis-Steele)
  scan[tid] = local;
  __syncthreads();
  for (int offset = 1; offset < blockDim.x; offset <<= 1) {
    const int add = tid >= offset ? scan[tid - offset] : 0;
    __syncthreads();
    scan[tid] += add;
    __syncthreads();
  }
  const int limit = min(scan[blockDim.x - 1], coeffs);
  int start = scan[tid] - local;

  for (int b = b0; b < b1; ++b) {
    const int end = start + clamp_count(counts[b]);
#pragma unroll 8
    for (int k = 0; k < 64; ++k) slab[k] = 0;
    const int stop = min(end, limit);
    for (int e = start; e < stop; ++e) {
      int p = poss[e];
      p = p < 0 ? 0 : (p > 63 ? 63 : p);
      slab[kZigzagNatural[p]] = vals[e];
    }
    start = end;

    int32_t* plane;
    int pitch, bi, bj;
    if (b < ny) {
      plane = ycoef + frame * height * width;
      pitch = width;
      bi = b / luma_bw;
      bj = b - bi * luma_bw;
    } else {
      int c = b - ny;
      plane = c < nc ? ucoef : vcoef;
      if (c >= nc) c -= nc;
      plane += frame * (height / 2) * (width / 2);
      pitch = width / 2;
      bi = c / chroma_bw;
      bj = c - bi * chroma_bw;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      int4* dst = reinterpret_cast<int4*>(
          plane + static_cast<long long>(bi * 8 + u) * pitch + bj * 8);
      const int* s = slab + u * 8;
      dst[0] = make_int4(s[0], s[1], s[2], s[3]);
      dst[1] = make_int4(s[4], s[5], s[6], s[7]);
    }
  }
}

template <typename Out>
__device__ __forceinline__ Out to_out(float v);

template <>
__device__ __forceinline__ float to_out<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float clip255(float v) {
  return fminf(fmaxf(v, 0.0f), 255.0f);
}

// Shared-memory stripe layout, in floats: luma rows 0..15 (pitch W) at
// [0, 16W), U rows 0..7 (pitch W/2) at [16W, 20W), V at [20W, 24W).
// Maps a stripe element to its plane's offset, pitch, row and column.
__device__ __forceinline__ void stripe_coords(int i, int width, int* base,
                                              int* pitch, int* r, int* c) {
  const int luma = 16 * width;
  const int chroma = 4 * width;
  if (i < luma) {
    *base = 0;
    *pitch = width;
  } else {
    *base = i < luma + chroma ? luma : luma + chroma;
    *pitch = width / 2;
  }
  const int j = i - *base;
  *r = j / *pitch;
  *c = j - *r * *pitch;
}

template <typename Out>
__global__ void dct_convert_kernel(const int32_t* __restrict__ ycoef,
                                   const int32_t* __restrict__ ucoef,
                                   const int32_t* __restrict__ vcoef,
                                   Out* __restrict__ out, int frames,
                                   int height, int width, int rows_valid) {
  extern __shared__ float stripe[];
  float* pix = stripe;               // coefficients, then pixels
  float* tmp = stripe + 24 * width;  // the row pass's output
  const int stripes = height / 16;
  const long long frame = blockIdx.x / stripes;  // row * frames + f
  const int s = blockIdx.x - static_cast<int>(frame) * stripes;
  const long long row = frame / frames;
  Out* dst = out + (frame * height + s * 16) * static_cast<long long>(width)
                       * 3;

  if (row >= rows_valid) {
    const int vectors = 16 * width * 3 * static_cast<int>(sizeof(Out)) / 16;
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < vectors; i += blockDim.x)
      d[i] = make_uint4(0, 0, 0, 0);
    return;
  }

  const int n = 24 * width;
  const int half = width / 2;
  const int32_t* ysrc = ycoef + (frame * height + s * 16)
                                    * static_cast<long long>(width);
  const long long chroma_off = (frame * (height / 2) + s * 8)
                               * static_cast<long long>(half);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int32_t v;
    if (i < 16 * width) v = ysrc[i];
    else if (i < 20 * width) v = ucoef[chroma_off + i - 16 * width];
    else v = vcoef[chroma_off + i - 20 * width];
    pix[i] = __int2float_rn(v);
  }
  __syncthreads();

  // row pass: tmp[u][x] = sum_v C[u][v] * M[x][v] within each block
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int base, pitch, r, c;
    stripe_coords(i, width, &base, &pitch, &r, &c);
    const float* src = pix + base + r * pitch + (c & ~7);
    const float* m = kIdct8 + (c & 7) * 8;
    float acc = __fmul_rn(src[0], m[0]);
#pragma unroll
    for (int v = 1; v < 8; ++v) acc = __fadd_rn(acc, __fmul_rn(src[v], m[v]));
    tmp[i] = acc;
  }
  __syncthreads();

  // column pass: p[y][x] = sum_u M[y][u] * tmp[u][x], level shift and
  // the host decoder's round-half-up u8 quantize
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int base, pitch, r, c;
    stripe_coords(i, width, &base, &pitch, &r, &c);
    const float* src = tmp + base + (r & ~7) * pitch + c;
    const float* m = kIdct8 + (r & 7) * 8;
    float acc = __fmul_rn(m[0], src[0]);
#pragma unroll
    for (int u = 1; u < 8; ++u)
      acc = __fadd_rn(acc, __fmul_rn(m[u], src[u * pitch]));
    pix[i] = clip255(floorf(__fadd_rn(acc, 128.5f)));
  }
  __syncthreads();

  // BT.601 in the numpy op order, each coefficient the float32 rounding
  // of the double, then clip, truncate and normalize
  const float kr = static_cast<float>(1.402);
  const float kgu = static_cast<float>(0.344136);
  const float kgv = static_cast<float>(0.714136);
  const float kb = static_cast<float>(1.772);
  const float inv255 = static_cast<float>(1.0 / 255.0);
  for (int i = threadIdx.x; i < 16 * width; i += blockDim.x) {
    const int py = i / width;
    const int px = i - py * width;
    const int ci = (py / 2) * half + px / 2;
    const float y = pix[i];
    const float uf = __fsub_rn(pix[16 * width + ci], 128.0f);
    const float vf = __fsub_rn(pix[20 * width + ci], 128.0f);
    const float rgb[3] = {
        __fadd_rn(y, __fmul_rn(kr, vf)),
        __fsub_rn(__fsub_rn(y, __fmul_rn(kgu, uf)), __fmul_rn(kgv, vf)),
        __fadd_rn(y, __fmul_rn(kb, uf))};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float q = floorf(clip255(rgb[k]));
      dst[i * 3 + k] = to_out<Out>(
          __fmul_rn(__fsub_rn(__fmul_rn(q, 2.0f), 255.0f), inv255));
    }
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  // above 48 KB a block's dynamic shared memory must be asked for
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename Out>
int launch_convert(const void* ycoef, const void* ucoef, const void* vcoef,
                   void* out, int rows, int frames, int height, int width,
                   int rows_valid, cudaStream_t stream) {
  const size_t smem = 2 * 24 * static_cast<size_t>(width) * sizeof(float);
  cudaError_t err = allow_shared(dct_convert_kernel<Out>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(rows) * frames
                           * (height / 16);
  dct_convert_kernel<Out><<<static_cast<unsigned>(blocks), kConvertThreads,
                            smem, stream>>>(
      static_cast<const int32_t*>(ycoef), static_cast<const int32_t*>(ucoef),
      static_cast<const int32_t*>(vcoef), static_cast<Out*>(out), frames,
      height, width, rows_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* rnb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// wire: (rows, frames, NB + 2C) int16; ycoef: (rows, frames, H, W),
// ucoef/vcoef: (rows, frames, H/2, W/2) int32, 16-byte aligned. Only
// rows < rows_valid are read and written. H % 16 == W % 16 == 0.
int rnb_dct_unpack(const void* wire, void* ycoef, void* ucoef, void* vcoef,
                   int rows_valid, int frames, int height, int width,
                   int coeffs, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(rows_valid) * frames;
  if (blocks == 0) return 0;
  const int nb = (height / 8) * (width / 8) + 2 * (height / 16) * (width / 16);
  int threads = (nb + 31) / 32 * 32;
  if (threads > kMaxUnpackThreads) threads = kMaxUnpackThreads;
  const size_t smem = static_cast<size_t>(threads) * (1 + kSlabStride)
                      * sizeof(int);
  err = allow_shared(dct_unpack_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dct_unpack_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(wire), static_cast<int32_t*>(ycoef),
      static_cast<int32_t*>(ucoef), static_cast<int32_t*>(vcoef), height,
      width, coeffs);
  return static_cast<int>(cudaGetLastError());
}

// planes as rnb_dct_unpack writes them; out: (rows, frames, H, W, 3),
// bf16 when out_bf16 is non-zero, else float32, 16-byte aligned.
int rnb_dct_convert(const void* ycoef, const void* ucoef, const void* vcoef,
                    void* out, int rows, int frames, int height, int width,
                    int rows_valid, int out_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(rows) * frames * height == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_convert<__nv_bfloat16>(ycoef, ucoef, vcoef, out, rows,
                                         frames, height, width, rows_valid,
                                         s);
  return launch_convert<float>(ycoef, ucoef, vcoef, out, rows, frames,
                               height, width, rows_valid, s);
}

}  // extern "C"
