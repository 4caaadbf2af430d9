// Ingest kernels of the dct serving path, hand-written for Hopper
// (sm_90a). Built by rnb_tpu_torch/ops/_kernels.py with nvcc into a
// shared library with a plain C interface, bound with ctypes.
//
// rnb_dct_ingest -- the one launch of a dct emission. Replaces the jnp
//   scatter `unpack_dct_rows` (rnb_tpu/ops/dct.py:213-264), which XLA
//   fused into the TPU program, followed by the Pallas kernel
//   `_dct_kernel` / `_dct_convert_pallas` (:312-374), as
//   `ragged_normalize_dct` (:421-444) runs the two in one jit. Packed
//   int16 wire rows (per frame: NB block counts, C values, C zigzag
//   positions) -> normalized (rows, frames, H, W, 3) bf16 or float32.
//   Bound: memory. The counts and the kept (value, position) pairs in,
//   the frames out: at the dct cell's 15-row pool of synthetic spectra
//   about 0.55 MB in and 9.03 MB of bf16 out, ~2.9 us at 3.35 TB/s; the
//   IDCT's ~119 MFLOP is ~1.8 us at 67 TFLOP/s.
//   What held the two launches it replaces (rnb_dct_unpack, then
//   rnb_dct_convert) back:
//   - the bytes moved twice: the unpack wrote 6 bytes per pixel of
//     int32 planes (9.03 MB at 15 rows, 8x the wire) that the convert
//     read back;
//   - the unpack ran one CTA per (row, frame): 120 CTAs for 132 SMs;
//   - inside its CTA the work was serial: a Hillis-Steele scan of the
//     counts over 320 threads (9 steps, two CTA barriers each), one
//     thread per block zeroing a 64-slot slab and walking its entries
//     one at a time, and 16-byte stores to eight tile rows 448 B apart;
//   - it took `rows_valid` by value and sized its grid by it, so the
//     launch arguments changed with every ragged emission.
//   Design: the convert's warp per 16x16 MCU (below) with only its load
//   phase changed. The warp unpacks its MCU's six blocks from the wire
//   into a 6 x 64 int32 slab of its own in shared memory, and the row
//   pass reads its block lines there: no plane reaches device memory.
//   The grid is the convert's, sized by the pool's rows: 5,880 warps
//   (1,470 CTAs) at 15 rows. Each warp finds its own offsets: its lanes
//   stride over the frame's counts (about 10 each at 112x112), clamp
//   them to [0, 64] and keep five predicated sums -- the counts before
//   the MCU's top-left luma block, before its bottom-left one, before
//   its U and its V block, and in all -- which five warp reductions
//   finish (the top-right and bottom-right blocks follow their left
//   neighbours by one count). A frame's counts are read by its MCUs
//   from L1 or L2, and no barrier is wider than the warp. The six
//   blocks' kept entries are then walked as one list, 32 at a time in
//   order: entries of one block are consecutive, so within a round the
//   highest lane on a slot holds the later entry and alone stores it
//   (`__match_any_sync`), and `__syncwarp` orders the rounds -- the
//   last entry wins, as in the plain version, whatever the scheduling.
//   Counts clamp to [0, 64], positions to [0, 63], entries at or past
//   min(sum of counts, C) are dropped: the reference's garbage
//   tolerance, bitwise. `rows_valid` is a pointer to an int32 in device
//   memory (null: every row); rows at or past it store zeros without
//   reading the wire, so an uninitialized pool tail never reaches a
//   valid row, and the launch arguments are those of the pool's shape.
//   The arithmetic after the load is the convert's, so the output is
//   bitwise that of rnb_dct_unpack followed by rnb_dct_convert.
//   Measured on an NVIDIA H100 80GB HBM3 at 700 W: 0.0126 ms at 15 rows,
//   against 0.0187 ms for the two launches and 23% of the byte bound.
//   Eight count loads in flight a lane, one wave of CTAs, or the counts
//   read as int32 pairs did not make it faster: what holds it is most
//   likely instruction throughput (every IDCT operation a separate `_rn`
//   multiply or add, and the counts' prefix), not memory.
//
// rnb_dct_unpack -- the unpack alone, kept as the yardstick of
//   rnb_dct_ingest's load phase (no serving path launches it). Packed
//   wire rows -> block-tiled int32 coefficient planes (Y, then U and V
//   at half resolution), every slot written, zeros included.
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
//   0.55 MB in, 9.03 MB out, ~2.9 us at 3.35 TB/s).
//
// rnb_dct_convert -- port of the Pallas kernel `_dct_kernel` /
//   `_dct_convert_pallas` (rnb_tpu/ops/dct.py:312-374) on int32 planes,
//   kept as the yardstick of rnb_dct_ingest's arithmetic. Per 8x8 block a
//   separable 8-point IDCT (rows, then columns) on the float32 basis
//   kIdct8, `floor(p + 128.5)` clipped to [0, 255], BT.601 with the
//   chroma read through the nearest 2x map, clip and truncate, then
//   the normalize (2q - 255) * (1/255) rounded once to bf16 or f32.
//   The reference multiplies whole planes by block-diagonal I (x) M8
//   bases, 14x the useful FLOPs at 112x112; per block only the 8-term
//   sums remain. Its chroma basis repeats rows; computing chroma at
//   half resolution and reading it through the 2x map gives the same
//   values. Rows at or past `rows_valid` store zeros without reading;
//   `rows_valid` is a pointer to an int32 in device memory (null: every
//   row), so the launch arguments are the same for every emission of a
//   pool shape.
//   Bound: memory. 6 bytes per pixel of int32 planes in, 6 (bf16) or
//   12 (f32) out: at the dct cell's 15-row pool, 9.03 MB in and 9.03 MB
//   of bf16 out, 5.4 us at 3.35 TB/s; the IDCT is ~600 kFLOP per
//   112x112 frame, ~1.8 us for the pool at 67 TFLOP/s.
//   What held the first version back (0.03165 ms on an
//   NVIDIA H100 80GB HBM3 at 700 W, 17% of its bound): its row pass
//   indexed the `__constant__` basis by a value that differed across
//   the warp (the constant cache serves one address per cycle, so each
//   basis load replayed up to 8 times); it loaded one int32 at a time
//   through a branch on the plane; it found every element's plane, row
//   and column by integer division; and it stored bf16 one value at a
//   time at a 6-byte lane stride.
//   Design: one warp per 16x16 MCU (four luma blocks, one U, one V),
//   four warps to a 128-thread CTA, and no barrier wider than the warp,
//   so the warps of an SM drift apart and one's loads overlap another's
//   arithmetic. load_lines issues all of a lane's int4 loads (its block
//   lines: two of the MCU's 48) before any is used. Each IDCT pass runs
//   one lane per (block, line), the line's 8 values in registers and the
//   basis read in fully unrolled loops at compile-time indices (an
//   operand of the multiply, never a divergent load); a pass sums only
//   the terms up to the warp's last non-zero input (see idct_terms),
//   which changes nothing but the sign of zeros that the +128.5 removes.
//   Shared-memory pitches are odd numbers of float4s. The epilogue runs
//   one lane per 8-pixel run of an MCU line, packs its 24 outputs into
//   16-byte chunks, and the warp stores the MCU's 16 output lines with
//   consecutive lanes on consecutive chunks. Work indices come from
//   shifts and compares; a warp divides only to find its MCU. Every
//   multiply and add is spelled __fmul_rn/__fadd_rn/__fsub_rn in the
//   first version's summation order (row pass from v = 0 up, column
//   pass from u = 0 up; 2q - 255 is exact, so it may be one __fmaf_rn),
//   so `--fmad` cannot contract it: the same arithmetic as the first
//   version, so the same bound against the plain version (two RGB
//   steps). With one CTA per 16-row stripe and CTA-wide barriers
//   between the phases, every CTA of the one wave loaded, computed and
//   stored in step, so memory and arithmetic never overlapped (about
//   half of the bound).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kConvertThreads = 128;
constexpr int kMaxUnpackThreads = 512;
// a thread's 64-slot slab is padded to 65 words: thread t's slot k sits
// in bank (t + k) % 32, so no two lanes of a warp share a bank
constexpr int kSlabStride = 65;

// zigzag scan position -> natural (row-major u*8+v) coefficient index;
// in global memory, read through the read-only data cache: the lanes of
// a warp look it up at different positions, which a `__constant__`
// table serves one address at a time
__device__ const int kZigzagNatural[64] = {
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
      slab[__ldg(&kZigzagNatural[p])] = vals[e];
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

__device__ __forceinline__ float clip255(float v) {
  return fminf(fmaxf(v, 0.0f), 255.0f);
}

// (2q - 255) * (1/255) of a quantized channel: 2q - 255 is exact, so
// the fused multiply-add rounds nothing
__device__ __forceinline__ float normalize_q(float q) {
  return __fmul_rn(__fmaf_rn(q, 2.0f, -255.0f),
                   static_cast<float>(1.0 / 255.0));
}

// How one 8-pixel run (24 normalized values) becomes 16-byte chunks of
// the output: three uint4 of bf16 or six of float32.
template <typename Out>
struct PackRun;

template <>
struct PackRun<__nv_bfloat16> {
  static constexpr int kChunks = 3;
  __device__ static void pack(const float (&v)[24], uint4 (&c)[kChunks]) {
    uint32_t w[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      const __nv_bfloat162 two = __floats2bfloat162_rn(v[2 * i],
                                                        v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&two);
    }
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
      c[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  }
};

template <>
struct PackRun<float> {
  static constexpr int kChunks = 6;
  __device__ static void pack(const float (&v)[24], uint4 (&c)[kChunks]) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
      c[i] = make_uint4(__float_as_uint(v[4 * i]),
                        __float_as_uint(v[4 * i + 1]),
                        __float_as_uint(v[4 * i + 2]),
                        __float_as_uint(v[4 * i + 3]));
  }
};

// One warp per 16x16 MCU: its four luma blocks (band 0 and 1, block
// columns 2c and 2c + 1), then its U and its V block -- six 8x8 blocks,
// 48 block lines. The warp's shared memory, in floats: luma rows 0..7
// at r * 20 and rows 8..15 at 176 + (r - 8) * 20, U rows at 336 + u * 12
// and V rows at 440 + u * 12. Pitches of 20 and 12 floats are odd
// numbers of float4s, so the eight lines of a block fall in eight bank
// groups; the band and V offsets put the two luma bands, and U and V,
// on different banks where a pass reads them side by side.
constexpr int kLumaPitch = 20;
constexpr int kChromaPitch = 12;
constexpr int kBand1 = 176;
constexpr int kU = 336;
constexpr int kV = 440;
constexpr int kMcuFloats = 544;
constexpr int kWarps = kConvertThreads / 32;

__device__ __forceinline__ int luma_row(int r) {
  return r < 8 ? r * kLumaPitch : kBand1 + (r - 8) * kLumaPitch;
}

// where row `line` of block `blk` (0..3 luma, 4 U, 5 V) starts
__device__ __forceinline__ int block_row(int blk, int line) {
  if (blk < 4) return luma_row((blk >> 1) * 8 + line) + (blk & 1) * 8;
  return (blk == 4 ? kU : kV) + line * kChromaPitch;
}

__device__ __forceinline__ int block_pitch(int blk) {
  return blk < 4 ? kLumaPitch : kChromaPitch;
}

// The load phase gives each lane its block lines -- line ids lane and
// lane + 32 of the MCU's 48 -- as two int4 each (zeros past 48). A
// source's `load` does it for the MCU at stripe s, column c of `frame`.

// From int32 planes: every load in flight before any is used.
__device__ __forceinline__ void load_lines(const int32_t* __restrict__ y,
                                           const int32_t* __restrict__ u,
                                           const int32_t* __restrict__ v,
                                           int width, int lane,
                                           int4 (&q)[2][2]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int l = lane + 32 * k;
    q[k][0] = make_int4(0, 0, 0, 0);
    q[k][1] = q[k][0];
    if (l < 48) {
      const int blk = l >> 3, line = l & 7;
      const int32_t* src =
          blk < 4
              ? y + ((blk >> 1) * 8 + line) * static_cast<long long>(width)
                    + (blk & 1) * 8
              : (blk == 4 ? u : v)
                    + line * static_cast<long long>(width / 2);
      q[k][0] = reinterpret_cast<const int4*>(src)[0];
      q[k][1] = reinterpret_cast<const int4*>(src)[1];
    }
  }
}

struct PlaneSource {
  const int32_t* y;
  const int32_t* u;
  const int32_t* v;

  __device__ __forceinline__ void load(unsigned frame, unsigned s,
                                       unsigned c, int height, int width,
                                       int lane, int4 (&q)[2][2]) const {
    load_lines(y + (static_cast<long long>(frame) * height + s * 16) * width
                   + c * 16,
               u + (static_cast<long long>(frame) * (height / 2) + s * 8)
                       * (width / 2) + c * 8,
               v + (static_cast<long long>(frame) * (height / 2) + s * 8)
                       * (width / 2) + c * 8,
               width, lane, q);
  }
};

constexpr int kMcuBlocks = 6;
constexpr int kMcuCoeffs = kMcuBlocks * 64;
constexpr unsigned kFullWarp = 0xffffffffu;

// From the wire: the MCU's six blocks are unpacked into the warp's slab
// in shared memory (slot blk * 64 + natural index, the blocks numbered
// as the convert numbers them: luma (0, 0), (0, 1), (1, 0), (1, 1), U,
// V), and the lanes read their block lines there.
struct WireSource {
  const int16_t* wire;
  int coeffs;

  __device__ __forceinline__ void load(unsigned frame, unsigned s,
                                       unsigned c, int height, int width,
                                       int lane, int4 (&q)[2][2]) const {
    __shared__ __align__(16) int32_t slabs[kWarps][kMcuCoeffs];
    int32_t* slab = slabs[threadIdx.x >> 5];
    const int luma_bw = width / 8;
    const int across = width / 16;
    const int ny = (height / 8) * luma_bw;
    const int nc = (height / 16) * across;
    const int nb = ny + 2 * nc;
    const int16_t* counts =
        wire + static_cast<long long>(frame) * (nb + 2 * coeffs);
    const int16_t* vals = counts + nb;
    const int16_t* poss = vals + coeffs;
    const int top = 2 * s * luma_bw + 2 * c;  // top-left luma block
    const int bottom = top + luma_bw;         // bottom-left
    const int ublk = ny + s * across + c;
    const int vblk = ublk + nc;

#pragma unroll
    for (int k = 0; k < kMcuCoeffs / 128; ++k)
      reinterpret_cast<int4*>(slab)[lane + 32 * k] = make_int4(0, 0, 0, 0);

    // the clamped counts before the top-left, the bottom-left, the U
    // and the V block, and in all
    int before_top = 0, before_bottom = 0, before_u = 0, before_v = 0;
    int total = 0;
    for (int i = lane; i < nb; i += 32) {
      const int n = clamp_count(counts[i]);
      before_top += i < top ? n : 0;
      before_bottom += i < bottom ? n : 0;
      before_u += i < ublk ? n : 0;
      before_v += i < vblk ? n : 0;
      total += n;
    }
    before_top = __reduce_add_sync(kFullWarp, before_top);
    before_bottom = __reduce_add_sync(kFullWarp, before_bottom);
    before_u = __reduce_add_sync(kFullWarp, before_u);
    before_v = __reduce_add_sync(kFullWarp, before_v);
    const int limit = min(__reduce_add_sync(kFullWarp, total), coeffs);

    // lane b < 6: block b keeps the entries [first, first + kept) of the
    // wire, its share of [0, limit)
    int first = 0, kept = 0;
    if (lane < kMcuBlocks) {
      int blk, start;
      if (lane < 4) {
        const int left = lane < 2 ? top : bottom;
        blk = left + (lane & 1);
        start = (lane < 2 ? before_top : before_bottom)
                + ((lane & 1) ? clamp_count(counts[left]) : 0);
      } else {
        blk = lane == 4 ? ublk : vblk;
        start = lane == 4 ? before_u : before_v;
      }
      first = min(start, limit);
      kept = min(start + clamp_count(counts[blk]), limit) - first;
    }
    // the six blocks' kept entries as one list: block b holds items
    // [begin[b], begin[b] + its kept), item i at wire entry i + shift[b]
    int begin[kMcuBlocks], shift[kMcuBlocks];
    int items = 0;
#pragma unroll
    for (int b = 0; b < kMcuBlocks; ++b) {
      begin[b] = items;
      shift[b] = __shfl_sync(kFullWarp, first, b) - items;
      items += __shfl_sync(kFullWarp, kept, b);
    }
    __syncwarp();  // the zeros are in place before any entry lands

    // 32 items a round, in order. A block's items are consecutive, so of
    // the lanes on one slot the highest holds the latest entry: it alone
    // stores, and the rounds are ordered -- the last entry wins
    for (int round = 0; round < items; round += 32) {
      const int item = round + lane;
      int blk = 0, entry = 0;
#pragma unroll
      for (int b = 0; b < kMcuBlocks; ++b) {
        if (item >= begin[b]) {
          blk = b;
          entry = item + shift[b];
        }
      }
      int slot = -1 - lane;  // no item: a key no other lane holds
      int value = 0;
      if (item < items) {
        int p = poss[entry];
        p = p < 0 ? 0 : (p > 63 ? 63 : p);
        slot = blk * 64 + __ldg(&kZigzagNatural[p]);
        value = vals[entry];
      }
      const unsigned same = __match_any_sync(kFullWarp, slot);
      if (item < items && (same >> lane) == 1u) slab[slot] = value;
      __syncwarp();
    }

#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int l = lane + 32 * k;
      q[k][0] = make_int4(0, 0, 0, 0);
      q[k][1] = q[k][0];
      if (l < 48) {
        q[k][0] = reinterpret_cast<const int4*>(slab + l * 8)[0];
        q[k][1] = reinterpret_cast<const int4*>(slab + l * 8)[1];
      }
    }
  }
};

// Both passes sum from index 0 up (the first version's order). Terms
// past a line's last non-zero input add fl(m * 0) = +-0, which leaves
// the sum unchanged but for the sign of a zero, and every result later
// goes through floor(p + 128.5), where that sign is gone: so each pass
// sums only the first K terms, K the warp's largest count of leading
// inputs up to the last non-zero one. The warp agrees on K, so the
// branch is uniform and the basis index stays a compile-time constant.

// 1 + the index of the last non-zero of 8 values, 0 when all are zero
__device__ __forceinline__ unsigned live_terms(const float (&c)[8]) {
  unsigned k = 0;
#pragma unroll
  for (int v = 0; v < 8; ++v)
    if (c[v] != 0.0f) k = v + 1;
  return k;
}

// Row pass of one block line: out[x] = sum_v c[v] * M[x][v]
template <int K>
__device__ __forceinline__ void idct_row_terms(const float (&c)[8],
                                               float (&o)[8]) {
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    float acc = __fmul_rn(c[0], kIdct8[x * 8]);
#pragma unroll
    for (int v = 1; v < K; ++v)
      acc = __fadd_rn(acc, __fmul_rn(c[v], kIdct8[x * 8 + v]));
    o[x] = acc;
  }
}

// Column pass of one block column: p[y] = sum_u M[y][u] * t[u]
template <int K>
__device__ __forceinline__ void idct_column_terms(const float (&t)[8],
                                                  float (&p)[8]) {
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    float acc = __fmul_rn(kIdct8[y * 8], t[0]);
#pragma unroll
    for (int u = 1; u < K; ++u)
      acc = __fadd_rn(acc, __fmul_rn(kIdct8[y * 8 + u], t[u]));
    p[y] = acc;
  }
}

template <bool kRow>
__device__ __forceinline__ void idct_terms(unsigned k, const float (&in)[8],
                                           float (&out)[8]) {
  if (k <= 1) {
    kRow ? idct_row_terms<1>(in, out) : idct_column_terms<1>(in, out);
  } else if (k <= 2) {
    kRow ? idct_row_terms<2>(in, out) : idct_column_terms<2>(in, out);
  } else if (k <= 4) {
    kRow ? idct_row_terms<4>(in, out) : idct_column_terms<4>(in, out);
  } else {
    kRow ? idct_row_terms<8>(in, out) : idct_column_terms<8>(in, out);
  }
}

// One warp's MCU, from its source's load phase to the stores.
template <typename Out, typename Source>
__device__ __forceinline__ void convert_mcu(
    const Source& source, Out* __restrict__ out,
    const int32_t* __restrict__ rows_valid_ptr, int rows, int frames,
    int height, int width, unsigned mcus) {
  constexpr int kChunks = PackRun<Out>::kChunks;  // per lane
  constexpr int kLineChunks = 2 * kChunks;        // per MCU output line
  __shared__ __align__(16) float smem[kWarps][kMcuFloats];
  __shared__ uint4 stage[kWarps][32 * (kChunks + 1)];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned m = blockIdx.x * kWarps + warp;
  if (m >= mcus) return;  // the whole warp
  const unsigned across = width / 16;
  const unsigned per_frame = across * (height / 16);
  const unsigned frame = m / per_frame;  // row * frames + f
  const unsigned in_frame = m - frame * per_frame;
  const unsigned s = in_frame / across;  // MCU stripe
  const unsigned c = in_frame - s * across;
  uint4* dst = reinterpret_cast<uint4*>(
      out + ((static_cast<long long>(frame) * height + s * 16) * width
             + c * 16) * 3);
  const int line_vectors = width * 3 * static_cast<int>(sizeof(Out)) / 16;
  int rows_valid = rows;
  if (rows_valid_ptr != nullptr) {
    const int v = *rows_valid_ptr;
    rows_valid = v < 0 ? 0 : (v > rows ? rows : v);
  }
  if (frame >= static_cast<unsigned>(rows_valid) * frames) {
    for (int i = lane; i < 16 * kLineChunks; i += 32)  // a pad row:
      dst[(i / kLineChunks) * line_vectors + i % kLineChunks] =  // nothing
          make_uint4(0, 0, 0, 0);                                 // read
    return;
  }

  float* mcu = smem[warp];
  int4 q[2][2];
  source.load(frame, s, c, height, width, lane, q);

  // row pass: one lane per block line, the line's 8 values in registers
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int l = lane + 32 * k;
    const float cv[8] = {
        __int2float_rn(q[k][0].x), __int2float_rn(q[k][0].y),
        __int2float_rn(q[k][0].z), __int2float_rn(q[k][0].w),
        __int2float_rn(q[k][1].x), __int2float_rn(q[k][1].y),
        __int2float_rn(q[k][1].z), __int2float_rn(q[k][1].w)};
    const unsigned terms = __reduce_max_sync(0xffffffffu, live_terms(cv));
    if (l < 48) {
      float o[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (terms > 0) idct_terms<true>(terms, cv, o);
      float* line = mcu + block_row(l >> 3, l & 7);
      *reinterpret_cast<float4*>(line) = make_float4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<float4*>(line + 4) =
          make_float4(o[4], o[5], o[6], o[7]);
    }
  }
  __syncwarp();

  // column pass: one lane per block column, then the level shift and
  // the host decoder's round-half-up u8 quantize, in place
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int l = lane + 32 * k;
    const int blk = l >> 3;
    float* col = mcu + (l < 48 ? block_row(blk, 0) + (l & 7) : 0);
    const int pitch = block_pitch(blk);
    float t[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (l < 48) {
#pragma unroll
      for (int u = 0; u < 8; ++u) t[u] = col[u * pitch];
    }
    const unsigned terms = __reduce_max_sync(0xffffffffu, live_terms(t));
    if (l < 48) {
      float p[8];
      idct_terms<false>(terms, t, p);
#pragma unroll
      for (int yy = 0; yy < 8; ++yy)
        col[yy * pitch] = clip255(floorf(__fadd_rn(p[yy], 128.5f)));
    }
  }
  __syncwarp();

  // BT.601 in the numpy op order, each coefficient the float32 rounding
  // of the double, then clip, truncate and normalize: one lane per
  // 8-pixel run of an MCU line (lines 0..15, runs 0..1)
  const int py = lane >> 1, run = lane & 1;
  const float* yl = mcu + luma_row(py) + run * 8;
  const float* ul = mcu + kU + (py >> 1) * kChromaPitch + run * 4;
  const float* vl = mcu + kV + (py >> 1) * kChromaPitch + run * 4;
  const float4 y0 = *reinterpret_cast<const float4*>(yl);
  const float4 y1 = *reinterpret_cast<const float4*>(yl + 4);
  const float4 u4 = *reinterpret_cast<const float4*>(ul);
  const float4 v4 = *reinterpret_cast<const float4*>(vl);
  const float ys[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
  const float us[4] = {u4.x, u4.y, u4.z, u4.w};
  const float vs[4] = {v4.x, v4.y, v4.z, v4.w};
  const float kr = static_cast<float>(1.402);
  const float kgu = static_cast<float>(0.344136);
  const float kgv = static_cast<float>(0.714136);
  const float kb = static_cast<float>(1.772);
  float vals[24];
#pragma unroll
  for (int cs = 0; cs < 4; ++cs) {  // a chroma sample, two pixels
    const float uf = __fsub_rn(us[cs], 128.0f);
    const float vf = __fsub_rn(vs[cs], 128.0f);
    const float dr = __fmul_rn(kr, vf);
    const float dg1 = __fmul_rn(kgu, uf);
    const float dg2 = __fmul_rn(kgv, vf);
    const float db = __fmul_rn(kb, uf);
#pragma unroll
    for (int p = 2 * cs; p < 2 * cs + 2; ++p) {
      const float yv = ys[p];
      const float rgb[3] = {__fadd_rn(yv, dr),
                            __fsub_rn(__fsub_rn(yv, dg1), dg2),
                            __fadd_rn(yv, db)};
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        vals[3 * p + ch] = normalize_q(floorf(clip255(rgb[ch])));
    }
  }
  uint4 chunks[kChunks];
  PackRun<Out>::pack(vals, chunks);
  uint4* mine = stage[warp];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) mine[lane * (kChunks + 1) + j] = chunks[j];
  __syncwarp();

  // the MCU's 16 output lines are 16 runs of 16 x 3 values: consecutive
  // lanes store consecutive 16-byte chunks of each
#pragma unroll
  for (int i = lane; i < 16 * kLineChunks; i += 32) {
    const int line = i / kLineChunks, w = i % kLineChunks;
    dst[line * line_vectors + w] =
        mine[(2 * line + w / kChunks) * (kChunks + 1) + w % kChunks];
  }
}

template <typename Out>
__global__ void __launch_bounds__(kConvertThreads)
dct_convert_kernel(const int32_t* __restrict__ ycoef,
                   const int32_t* __restrict__ ucoef,
                   const int32_t* __restrict__ vcoef, Out* __restrict__ out,
                   const int32_t* __restrict__ rows_valid_ptr, int rows,
                   int frames, int height, int width, unsigned mcus) {
  convert_mcu<Out>(PlaneSource{ycoef, ucoef, vcoef}, out, rows_valid_ptr,
                   rows, frames, height, width, mcus);
}

template <typename Out>
__global__ void __launch_bounds__(kConvertThreads)
dct_ingest_kernel(const int16_t* __restrict__ wire, int coeffs,
                  Out* __restrict__ out,
                  const int32_t* __restrict__ rows_valid_ptr, int rows,
                  int frames, int height, int width, unsigned mcus) {
  convert_mcu<Out>(WireSource{wire, coeffs}, out, rows_valid_ptr, rows,
                   frames, height, width, mcus);
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  // above 48 KB a block's dynamic shared memory must be asked for
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The MCU kernels' grid: one warp per MCU of the pool; false when the
// MCUs cannot be counted in 32 bits
bool mcu_grid(int rows, int frames, int height, int width,
              unsigned* mcus, unsigned* blocks) {
  const long long n = static_cast<long long>(rows) * frames
                      * (height / 16) * (width / 16);
  if (n > 0xffffffffLL) return false;
  *mcus = static_cast<unsigned>(n);
  *blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  return true;
}

template <typename Out>
int launch_convert(const void* ycoef, const void* ucoef, const void* vcoef,
                   void* out, const void* rows_valid, int rows, int frames,
                   int height, int width, cudaStream_t stream) {
  unsigned mcus, blocks;
  if (!mcu_grid(rows, frames, height, width, &mcus, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  dct_convert_kernel<Out><<<blocks, kConvertThreads, 0, stream>>>(
      static_cast<const int32_t*>(ycoef), static_cast<const int32_t*>(ucoef),
      static_cast<const int32_t*>(vcoef), static_cast<Out*>(out),
      static_cast<const int32_t*>(rows_valid), rows, frames, height, width,
      mcus);
  return static_cast<int>(cudaGetLastError());
}

template <typename Out>
int launch_ingest(const void* wire, void* out, const void* rows_valid,
                  int rows, int frames, int height, int width, int coeffs,
                  cudaStream_t stream) {
  unsigned mcus, blocks;
  if (!mcu_grid(rows, frames, height, width, &mcus, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  dct_ingest_kernel<Out><<<blocks, kConvertThreads, 0, stream>>>(
      static_cast<const int16_t*>(wire), coeffs, static_cast<Out*>(out),
      static_cast<const int32_t*>(rows_valid), rows, frames, height, width,
      mcus);
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
// bf16 when out_bf16 is non-zero, else float32, 16-byte aligned;
// rows_valid: one int32 in device memory, or null for every row.
int rnb_dct_convert(const void* ycoef, const void* ucoef, const void* vcoef,
                    void* out, const void* rows_valid, int rows, int frames,
                    int height, int width, int out_bf16, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(rows) * frames * height == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_convert<__nv_bfloat16>(ycoef, ucoef, vcoef, out,
                                         rows_valid, rows, frames, height,
                                         width, s);
  return launch_convert<float>(ycoef, ucoef, vcoef, out, rows_valid, rows,
                               frames, height, width, s);
}

// wire: (rows, frames, NB + 2C) int16, NB = num_dct_blocks(H, W); out:
// (rows, frames, H, W, 3), bf16 when out_bf16 is non-zero, else
// float32, 16-byte aligned; rows_valid: one int32 in device memory, or
// null for every row. Rows at or past it are stored as zeros, their
// wire unread. H % 16 == W % 16 == 0.
int rnb_dct_ingest(const void* wire, void* out, const void* rows_valid,
                   int rows, int frames, int height, int width, int coeffs,
                   int out_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(rows) * frames * height == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_ingest<__nv_bfloat16>(wire, out, rows_valid, rows, frames,
                                        height, width, coeffs, s);
  return launch_ingest<float>(wire, out, rows_valid, rows, frames, height,
                              width, coeffs, s);
}

}  // extern "C"
