// Ingest kernels of the yuv420 serving path, hand-written for Hopper
// (sm_90a). Built by rnb_tpu_torch/ops/_kernels.py with nvcc into a
// shared library with a plain C interface, bound with ctypes.
//
// rnb_normalize_u8 -- port of the Pallas kernel `_normalize_kernel` /
//   `_normalize_u8_pallas` (rnb_tpu/ops/preprocess.py:48-70).
//   Computes y = (2x - 255) * (1/255) rounded once to bf16, row by row;
//   rows at or past the host integer `rows_valid` store zeros and do no
//   arithmetic. (The ragged Pallas kernel `_ragged_normalize_kernel`,
//   whose `rows_valid` lives in device memory, is ported in ragged.cu.)
//   Since the yuv420 entries below fuse the normalize, only the rgb
//   paths launch it.
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
// rnb_yuv420_to_rgb_u8 / rnb_yuv420_normalize -- one kernel template,
//   two entry points. The u8 entry replaces the jnp colourspace
//   converter `yuv420_to_rgb_u8` (rnb_tpu/ops/yuv.py:48-69), which XLA
//   fused into the TPU program; the normalize entry replaces that
//   converter followed by the Pallas normalize (`_normalize_kernel`,
//   rnb_tpu/ops/preprocess.py:48), and for the ragged pool the masked
//   form `ragged_normalize_yuv420` over `_ragged_normalize_kernel`
//   (rnb_tpu/ops/ragged.py:157). No library call computes either.
//   Packed 4:2:0 planes (Y, then U and V at half resolution, per frame)
//   -> RGB: nearest 2x chroma upsample, full-range BT.601 in the numpy
//   op order, clip to [0, 255], truncate to u8; the normalize entry then
//   writes (2q - 255) * (1/255) as bf16 or f32 (normalize_one's exact
//   arithmetic), so the RGB u8 bytes never reach device memory. Rows at
//   or past `rows_valid` are converted as if every byte were zero --
//   exactly what ragged_mask_rows followed by the converter produces:
//   RGB (0, 135, 0), normalized (-1, 0.0588, -1) -- without a load.
//   `rows_valid` is a pointer to an int32 in device memory (null: every
//   row), so the launch arguments are the same for every emission of a
//   pool shape.
//   Bound: memory. 1.5 bytes read per pixel; 3 written (u8) or 6 (bf16):
//   at 48 rows x 8 frames of 112x112, 7.2 MB in and 14.5 MB (u8) or
//   28.9 MB (bf16) out, 6.5 or 10.8 us at 3.35 TB/s. The fused entry
//   moves 7.5 bytes per pixel where the two launches it replaces moved
//   13.5.
//   What held the first version back (0.02379 ms on an
//   NVIDIA H100 80GB HBM3 at 700 W, 27% of its bound): one thread per
//   2x2 quad, single-byte loads, and twelve 1-byte stores per thread at
//   a 6-byte lane stride -- a store-instruction-bound kernel.
//   Design: one thread per run of 16 luma pixels of one luma line. It
//   issues all of its loads first: one uint4 of Y, one uint2 of U and
//   one of V (the 8 chroma samples the run shares with the line above
//   or below it, which reads them from L1/L2). Each chroma sample's four
//   BT.601 terms are computed once for its two pixels, and the run's 48
//   outputs (48 B u8, 96 B bf16, 192 B f32) are packed into 16-byte
//   chunks. Thread t's outputs are elements [48t, 48t + 48) when
//   W % 16 == 0, so a warp's are one contiguous run: each lane puts its
//   chunks in the warp's slice of shared memory and the warp stores the
//   run with consecutive lanes on consecutive chunks -- full 512-byte
//   store instructions instead of 16 bytes at a 48- or 96-byte lane
//   stride, which left half-written sectors and held the bf16 entry to
//   about 40% of its bound. Every offset is 16-byte aligned
//   when W % 16 == 0 (at 112: frame 18,816 = 1,176 x 16 B, u8 line
//   336 = 21 x 16 B, bf16 line 672 = 42 x 16 B). Any other even width,
//   or a pool that is not 16-byte aligned, takes a scalar path in the
//   same kernel (byte loads, element stores, the run cut at the line's
//   end). A flat grid of 128-thread blocks; two 32-bit divisions per
//   thread find (frame, line, run), none per pixel. Every multiply and
//   add is spelled __fmul_rn/__fadd_rn/__fsub_rn in the numpy op order
//   (2q - 255 is exact, so it may be one __fmaf_rn), so the u8 values
//   match the plain version's and the normalize matches
//   rnb_normalize_u8 bit for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kYuvThreads = 128;
// luma pixels per thread and line
constexpr int kRun = 16;

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

// The four BT.601 terms of one chroma sample, each coefficient the
// float32 rounding of the double, as numpy rounds a Python float
// against a float32 array.
struct Chroma {
  float dr, dg1, dg2, db;
};

__device__ __forceinline__ Chroma chroma_terms(uint32_t u, uint32_t v) {
  const float uf = __fsub_rn(static_cast<float>(u), 128.0f);
  const float vf = __fsub_rn(static_cast<float>(v), 128.0f);
  return {__fmul_rn(static_cast<float>(1.402), vf),
          __fmul_rn(static_cast<float>(0.344136), uf),
          __fmul_rn(static_cast<float>(0.714136), vf),
          __fmul_rn(static_cast<float>(1.772), uf)};
}

__device__ __forceinline__ float clip_trunc(float value) {
  // jnp.clip(rgb, 0, 255).astype(uint8): clamp, then truncate (kept as
  // a float: the u8 value exactly)
  return truncf(fminf(fmaxf(value, 0.0f), 255.0f));
}

// numpy op order: y + 1.402v; (y - 0.344136u) - 0.714136v; y + 1.772u
__device__ __forceinline__ void rgb_of(uint32_t luma, const Chroma& c,
                                       float* q) {
  const float y = static_cast<float>(luma);
  q[0] = clip_trunc(__fadd_rn(y, c.dr));
  q[1] = clip_trunc(__fsub_rn(__fsub_rn(y, c.dg1), c.dg2));
  q[2] = clip_trunc(__fadd_rn(y, c.db));
}

// normalize_one's value for a u8 held as a float, before the rounding
// to bf16: 2q - 255 is exact, so the fused multiply-add rounds nothing
__device__ __forceinline__ float normalize_f32(float q) {
  return __fmul_rn(__fmaf_rn(q, 2.0f, -255.0f),
                   static_cast<float>(1.0 / 255.0));
}

// How a thread's 16 pixels (48 values) become 16-byte chunks of the
// output, and how one value is stored on the scalar path.
template <typename Out>
struct Emit;

template <>
struct Emit<uint8_t> {
  static constexpr int kChunks = 3;
  __device__ static void one(uint8_t* dst, float q) {
    *dst = static_cast<uint8_t>(q);
  }
  __device__ static void pack(const float (&q)[3 * kRun],
                              uint4 (&c)[kChunks]) {
    uint32_t w[12];
#pragma unroll
    for (int i = 0; i < 12; ++i)
      w[i] = static_cast<uint32_t>(q[4 * i])
             | (static_cast<uint32_t>(q[4 * i + 1]) << 8)
             | (static_cast<uint32_t>(q[4 * i + 2]) << 16)
             | (static_cast<uint32_t>(q[4 * i + 3]) << 24);
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
      c[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  }
};

template <>
struct Emit<__nv_bfloat16> {
  static constexpr int kChunks = 6;
  __device__ static void one(__nv_bfloat16* dst, float q) {
    *dst = __float2bfloat16_rn(normalize_f32(q));
  }
  __device__ static void pack(const float (&q)[3 * kRun],
                              uint4 (&c)[kChunks]) {
    uint32_t w[24];
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const __nv_bfloat162 two = __floats2bfloat162_rn(
          normalize_f32(q[2 * i]), normalize_f32(q[2 * i + 1]));
      w[i] = *reinterpret_cast<const uint32_t*>(&two);
    }
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
      c[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  }
};

template <>
struct Emit<float> {
  static constexpr int kChunks = 12;
  __device__ static void one(float* dst, float q) {
    *dst = normalize_f32(q);
  }
  __device__ static void pack(const float (&q)[3 * kRun],
                              uint4 (&c)[kChunks]) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
      c[i] = make_uint4(__float_as_uint(normalize_f32(q[4 * i])),
                        __float_as_uint(normalize_f32(q[4 * i + 1])),
                        __float_as_uint(normalize_f32(q[4 * i + 2])),
                        __float_as_uint(normalize_f32(q[4 * i + 3])));
  }
};

__device__ __forceinline__ uint32_t byte_of(uint32_t word, int k) {
  return (word >> (8 * k)) & 0xffu;
}

// Thread t of the flat grid owns run `run` (16 luma pixels from column
// 16 * run) of luma line `line` of its frame. Frames are (row, frame)
// pairs, row-major; a frame of a row at or past rows_valid is converted
// from zero bytes. On the vector path thread t's 48 outputs are
// elements [48t, 48t + 48) of the output, so a warp's are one
// contiguous run: each lane puts its chunks in the warp's slice of
// shared memory (lane pitch kChunks + 1 uint4, an odd number, so eight
// lanes hit eight bank groups), and the warp stores the run back with
// consecutive lanes on consecutive 16-byte chunks.
template <typename Out>
__global__ void __launch_bounds__(kYuvThreads)
yuv420_kernel(const uint8_t* __restrict__ packed, Out* __restrict__ out,
              const int32_t* __restrict__ rows_valid_ptr, int rows,
              int frames, int height, int width, unsigned runs_per_line,
              unsigned runs_per_frame, unsigned work, int vector) {
  constexpr int kChunks = Emit<Out>::kChunks;
  __shared__ uint4 stage[kYuvThreads * (kChunks + 1)];
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = t < work;
  if (!vector && !live) return;
  int rows_valid = rows;
  if (rows_valid_ptr != nullptr) {
    const int v = *rows_valid_ptr;
    rows_valid = v < 0 ? 0 : (v > rows ? rows : v);
  }
  const unsigned frame = t / runs_per_frame;  // row * frames + f
  const unsigned in_frame = t - frame * runs_per_frame;
  const unsigned line = in_frame / runs_per_line;
  const unsigned run = in_frame - line * runs_per_line;
  const bool valid =
      live && frame < static_cast<unsigned>(rows_valid) * frames;
  const int half_w = width / 2;
  const long long plane = static_cast<long long>(height) * width;
  const long long chroma_plane = static_cast<long long>(height / 2)
                                 * half_w;
  const uint8_t* src = packed + frame * (plane + 2 * chroma_plane);
  const long long y_off = static_cast<long long>(line) * width + kRun * run;
  const long long c_off = static_cast<long long>(line / 2) * half_w
                          + (kRun / 2) * run;

  if (vector) {
    uint4 yv = make_uint4(0, 0, 0, 0);
    uint2 u = make_uint2(0, 0), v = u;
    if (valid) {
      yv = *reinterpret_cast<const uint4*>(src + y_off);
      u = *reinterpret_cast<const uint2*>(src + plane + c_off);
      v = *reinterpret_cast<const uint2*>(src + plane + chroma_plane
                                          + c_off);
    }
    const uint32_t yw[4] = {yv.x, yv.y, yv.z, yv.w};
    const uint32_t uw[2] = {u.x, u.y};
    const uint32_t vw[2] = {v.x, v.y};
    float q[3 * kRun];
#pragma unroll
    for (int k = 0; k < kRun / 2; ++k) {
      const Chroma c = chroma_terms(byte_of(uw[k / 4], k % 4),
                                    byte_of(vw[k / 4], k % 4));
      rgb_of(byte_of(yw[(2 * k) / 4], (2 * k) % 4), c, q + 6 * k);
      rgb_of(byte_of(yw[(2 * k + 1) / 4], (2 * k + 1) % 4), c,
             q + 6 * k + 3);
    }
    uint4 chunks[kChunks];
    Emit<Out>::pack(q, chunks);
    const unsigned lane = threadIdx.x & 31;
    uint4* slice = stage + (threadIdx.x - lane) * (kChunks + 1);
    if (live) {
#pragma unroll
      for (int j = 0; j < kChunks; ++j)
        slice[lane * (kChunks + 1) + j] = chunks[j];
    }
    __syncwarp();
    const unsigned first = t - lane;  // the warp's first thread
    const unsigned lanes =
        first >= work ? 0 : (work - first < 32 ? work - first : 32);
    uint4* dst = reinterpret_cast<uint4*>(out)
                 + static_cast<long long>(first) * kChunks;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const unsigned c = j * 32 + lane;
      if (c < lanes * kChunks)
        dst[c] = slice[(c / kChunks) * (kChunks + 1) + c % kChunks];
    }
    return;
  }

  // scalar path: any even width; the last run of a line may be short
  Out* dst = out + (frame * plane + y_off) * 3;
  const int x0 = kRun * static_cast<int>(run);
  const int n = width - x0 < kRun ? width - x0 : kRun;
  for (int p = 0; p < n; ++p) {
    const Chroma c = valid
        ? chroma_terms(src[plane + c_off + p / 2],
                       src[plane + chroma_plane + c_off + p / 2])
        : chroma_terms(0, 0);
    float q[3];
    rgb_of(valid ? src[y_off + p] : 0, c, q);
    Emit<Out>::one(dst + 3 * p, q[0]);
    Emit<Out>::one(dst + 3 * p + 1, q[1]);
    Emit<Out>::one(dst + 3 * p + 2, q[2]);
  }
}

template <typename Out>
int launch_yuv420(const void* packed, void* out, const void* rows_valid,
                  int rows, int frames, int height, int width, int vector,
                  cudaStream_t stream) {
  const long long runs_per_line = (width + kRun - 1) / kRun;
  const long long runs_per_frame = runs_per_line * height;
  const long long work = static_cast<long long>(rows) * frames
                         * runs_per_frame;
  if (work == 0) return 0;
  if (work > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(
      (work + kYuvThreads - 1) / kYuvThreads);
  yuv420_kernel<Out><<<blocks, kYuvThreads, 0, stream>>>(
      static_cast<const uint8_t*>(packed), static_cast<Out*>(out),
      static_cast<const int32_t*>(rows_valid), rows, frames, height, width,
      static_cast<unsigned>(runs_per_line),
      static_cast<unsigned>(runs_per_frame), static_cast<unsigned>(work),
      vector);
  return static_cast<int>(cudaGetLastError());
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

// packed: (rows, frames, H*W*3/2) u8; out: (rows, frames, H, W, 3) u8;
// rows_valid: one int32 in device memory, or null for every row. vector
// non-zero only when W % 16 == 0 and both pointers are 16-byte aligned
// (the Python wrapper decides).
int rnb_yuv420_to_rgb_u8(const void* packed, void* out,
                         const void* rows_valid, int rows, int frames,
                         int height, int width, int vector, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_yuv420<uint8_t>(packed, out, rows_valid, rows, frames,
                                height, width, vector,
                                static_cast<cudaStream_t>(stream));
}

// As rnb_yuv420_to_rgb_u8, but out holds the normalized values:
// bf16 when out_bf16 is non-zero, else float32.
int rnb_yuv420_normalize(const void* packed, void* out,
                         const void* rows_valid, int rows, int frames,
                         int height, int width, int vector, int out_bf16,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_yuv420<__nv_bfloat16>(packed, out, rows_valid, rows,
                                        frames, height, width, vector, s);
  return launch_yuv420<float>(packed, out, rows_valid, rows, frames, height,
                              width, vector, s);
}

}  // extern "C"
