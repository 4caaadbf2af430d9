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
//   What held the first fused design back (NVIDIA H100 80GB HBM3, 700 W:
//   0.0128 ms at 15 rows with L2 warm, 0.0139 flushed, 20% of the byte
//   bound): instruction issue. 200 FFMAs added to each MCU's warp cost
//   what their issue slots cost (4.8 us against 4.95 predicted at 48
//   rows), five CTAs an SM instead of seven cost nothing, and
//   removing sections saves time in proportion to what they issue (see
//   rnb_tpu_torch/tools/kernel_probe.py). Each warp re-summed its
//   frame's 294 counts, found its MCU by two integer divisions, read the
//   IDCT basis through constant-bank loads, settled every round of
//   entries with __match_any_sync, and normalized each of its 768
//   outputs with two operations.
//   Design: one CTA per (frame, MCU stripe), a warp per MCU of the stripe
//   (seven at 112x112: 840 CTAs of 224 threads at 15 rows, one wave at
//   up to seven CTAs an SM). The CTA reads the frame's counts once, all
//   loads in flight before any is used: each thread sums its share into
//   the clamped counts before the stripe's luma, U and V rows and in
//   all, and keeps one of the stripe's 6 * across counts in shared
//   memory; four warp reductions and one CTA barrier finish them, the
//   only barrier wider than a warp. Each warp then sums the stripe's
//   counts before its own blocks (two loads a lane, four reductions),
//   with no division. Its six blocks' kept entries are walked as one
//   list, 32 at a time in order, into a float slab (line pitch 9, so
//   the rows read together fall on distinct banks). Entries of one block
//   are consecutive, so where the slots of a round rise with the lanes
//   no two share one and the stores go straight in; otherwise the
//   highest lane on a slot holds the later entry and alone stores it
//   (`__match_any_sync`) -- the last entry wins, as in the plain
//   version, whatever the scheduling. The IDCT runs its 48 block lines
//   and 48 block columns in three steps of 32 lanes, not four (a
//   block's column pass needs only its own row pass, so the chroma rows
//   share a step with half of the luma columns), with the basis as
//   immediate operands. Counts clamp to [0, 64], positions to [0, 63],
//   entries at or past min(sum of counts, C) are dropped: the
//   reference's garbage tolerance, bitwise. `rows_valid` is a pointer to
//   an int32 in device memory (null: every row); rows at or past it
//   store zeros without reading the wire, so an uninitialized pool tail
//   never reaches a valid row, and the launch arguments are those of the
//   pool's shape. The arithmetic after the load is the convert's (the
//   same MCU pipeline), so the output is bitwise that of rnb_dct_unpack
//   followed by rnb_dct_convert, and of the first design.
//   Measured on an NVIDIA H100 80GB HBM3 at 700 W: 0.0110-0.0112 ms at 15
//   rows with L2 warm, 0.0123 flushed (23% of the byte bound); at 48
//   rows 0.0287 and 0.0294 (31%). Still bound by issue: the epilogue
//   (BT.601, the quantize and the pack of 768 outputs), the IDCT and the
//   unpack rounds each take 1.7-2.9 us of the 11 at 15 rows. FMAs in the
//   IDCT would save about 4% of what a warp issues, and change its
//   rounding; they are not used.
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
//   (idct_basis), `floor(p + 128.5)` clipped to [0, 255], BT.601 with the
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
//   arithmetic. Each lane issues all of its int4 loads (its block lines:
//   two of the MCU's 48) before any is used, into the MCU pipeline that
//   rnb_dct_ingest shares: the IDCT in three steps of 32 lanes, the
//   line's 8 values in registers and the basis as immediates; a step
//   sums only the terms up to the warp's last non-zero input (see
//   idct_terms), which changes nothing but the sign of zeros that the
//   +128.5 removes. Shared-memory pitches are odd numbers of float4s.
//   The epilogue runs one lane per 8-pixel run of an MCU line, packs its
//   24 outputs into 16-byte chunks, and the warp stores the MCU's 16
//   output lines with consecutive lanes on consecutive chunks. Every
//   multiply and add is spelled __fmul_rn/__fadd_rn/__fsub_rn in the
//   first version's summation order (row pass from v = 0 up, column
//   pass from u = 0 up), so `--fmad` cannot contract it: the same
//   arithmetic as the first version, so the same bound against the
//   plain version (two RGB steps). The normalize (2q - 255) / 255 is one
//   rounding: fl(fl(2q - 255) * fl(1/255)) in float32, one FMA in bf16
//   (the same bf16 for every q). With one CTA per 16-row stripe and
//   CTA-wide barriers between the phases, every CTA of the one wave
//   loaded, computed and stored in step, so memory and arithmetic never
//   overlapped (about half of the bound).

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
// values of _idct_basis8() in rnb_tpu_torch/ops/dct.py, to the bit.
// Every use indexes it at a compile-time constant, so the values become
// immediate operands of the multiplies: no constant-bank loads.
__device__ __forceinline__ constexpr float idct_basis(int k) {
  constexpr float kIdct8[64] = {
      0.353553385f, 0.490392625f, 0.461939752f, 0.415734798f, 0.353553385f, 0.277785122f, 0.191341713f, 0.0975451618f,
      0.353553385f, 0.415734798f, 0.191341713f, -0.0975451618f, -0.353553385f, -0.490392625f, -0.461939752f, -0.277785122f,
      0.353553385f, 0.277785122f, -0.191341713f, -0.490392625f, -0.353553385f, 0.0975451618f, 0.461939752f, 0.415734798f,
      0.353553385f, 0.0975451618f, -0.461939752f, -0.277785122f, 0.353553385f, 0.415734798f, -0.191341713f, -0.490392625f,
      0.353553385f, -0.0975451618f, -0.461939752f, 0.277785122f, 0.353553385f, -0.415734798f, -0.191341713f, 0.490392625f,
      0.353553385f, -0.277785122f, -0.191341713f, 0.490392625f, -0.353553385f, -0.0975451618f, 0.461939752f, -0.415734798f,
      0.353553385f, -0.415734798f, 0.191341713f, 0.0975451618f, -0.353553385f, 0.490392625f, -0.461939752f, 0.277785122f,
      0.353553385f, -0.490392625f, 0.461939752f, -0.415734798f, 0.353553385f, -0.277785122f, 0.191341713f, -0.0975451618f};
  return kIdct8[k];
}

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

// The MCU pipeline shared by the convert and the ingest: one warp per
// 16x16 MCU -- its four luma blocks (band 0 and 1, block columns 2c and
// 2c + 1), then its U and its V block, six 8x8 blocks. Each warp owns a
// region of kRegionFloats floats in shared memory:
// - the slab at 0: the MCU's coefficients as floats, block b line u at
//   b * 72 + u * 9. A line pitch of 9 puts the eight lines of a block,
//   and the lines of the blocks read together, on distinct banks;
// - the planes at kPlanes: luma rows 0..7 at r * 20 and rows 8..15 at
//   176 + (r - 8) * 20, U rows at 336 + u * 12 and V rows at 440 + u * 12.
//   Pitches of 20 and 12 floats are odd numbers of float4s, so the eight
//   lines of a block fall in eight bank groups; the band and V offsets
//   put the two luma bands, and U and V, on different banks where a pass
//   reads them side by side;
// - the staged output chunks at 0, once the epilogue has read the planes.
constexpr int kSlabLine = 9;
constexpr int kSlabBlock = 72;
constexpr int kLumaPitch = 20;
constexpr int kChromaPitch = 12;
constexpr int kBand1 = 176;
constexpr int kU = 336;
constexpr int kV = 440;
constexpr int kPlanes = 6 * kSlabBlock;
constexpr int kRegionFloats = kPlanes + 544;
constexpr int kWarps = kConvertThreads / 32;
constexpr unsigned kFullWarp = 0xffffffffu;

// zigzag scan position -> the slab slot of its natural index n:
// (n / 8) * kSlabLine + n % 8
__device__ const int kZigzagSlot[64] = {
    0,  1,  9,  18, 10, 2,  3,  11, 19, 27, 36, 28, 20, 12, 4,  5,
    13, 21, 29, 37, 45, 54, 46, 38, 30, 22, 14, 6,  7,  15, 23, 31,
    39, 47, 55, 63, 64, 56, 48, 40, 32, 24, 16, 25, 33, 41, 49, 57,
    65, 66, 58, 50, 42, 34, 43, 51, 59, 67, 68, 60, 52, 61, 69, 70};

// sass: -
__device__ __forceinline__ int luma_row(int r) {
  return r < 8 ? r * kLumaPitch : kBand1 + (r - 8) * kLumaPitch;
}

// where row `line` of block `blk` (0..3 luma, 4 U, 5 V) starts
__device__ __forceinline__ int block_row(int blk, int line) {
  if (blk < 4) return luma_row((blk >> 1) * 8 + line) + (blk & 1) * 8;
  return (blk == 4 ? kU : kV) + line * kChromaPitch;
}

// 1 + the index of the last non-zero of 8 values, 0 when all are zero
__device__ __forceinline__ unsigned live_terms(const float (&c)[8]) {
  unsigned k = 0;
#pragma unroll
  for (int v = 0; v < 8; ++v)
    if (c[v] != 0.0f) k = v + 1;
  return k;
}

// sass: idct
// Both passes compute out[i] = sum_j M[i][j] * in[j], j from 0 up, each
// multiply and add rounded once (the first version's order: the row
// pass's c[v] * M[x][v] is the same product). Terms past the last
// non-zero input add fl(m * 0) = +-0, which leaves the sum unchanged
// but for the sign of a zero, and every result later goes through
// floor(p + 128.5), where that sign is gone: so a pass sums only the
// first K terms, K the warp's largest count of leading inputs up to the
// last non-zero one. The warp agrees on K, so the branch is uniform and
// the basis index stays a compile-time constant.
template <int K>
__device__ __forceinline__ void idct_terms_k(const float (&in)[8],
                                             float (&out)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float acc = __fmul_rn(idct_basis(i * 8), in[0]);
#pragma unroll
    for (int j = 1; j < K; ++j)
      acc = __fadd_rn(acc, __fmul_rn(idct_basis(i * 8 + j), in[j]));
    out[i] = acc;
  }
}

__device__ __forceinline__ void idct_terms(unsigned k, const float (&in)[8],
                                           float (&out)[8]) {
  if (k <= 1) {
    idct_terms_k<1>(in, out);
  } else if (k <= 2) {
    idct_terms_k<2>(in, out);
  } else if (k <= 4) {
    idct_terms_k<4>(in, out);
  } else {
    idct_terms_k<8>(in, out);
  }
}

// One lane's share of a pass step: the 8 values at in[j * pitch] ->
// p[i] = sum_j M[i][j] * in[j].
__device__ __forceinline__ void idct_step(const float* in, int pitch,
                                          float (&p)[8]) {
  float t[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = in[j * pitch];
  idct_terms(__reduce_max_sync(kFullWarp, live_terms(t)), t, p);
}

// a row pass's line, as two float4
__device__ __forceinline__ void store_line(float* out, const float (&p)[8]) {
  reinterpret_cast<float4*>(out)[0] = make_float4(p[0], p[1], p[2], p[3]);
  reinterpret_cast<float4*>(out)[1] = make_float4(p[4], p[5], p[6], p[7]);
}

// a column pass's column, with the level shift and the host decoder's
// round-half-up u8 quantize
__device__ __forceinline__ void store_column(float* out, int pitch,
                                             const float (&p)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    out[i * pitch] = clip255(floorf(__fadd_rn(p[i], 128.5f)));
}

// The two passes over the MCU's 48 block lines and 48 block columns in
// three steps of 32 lanes, not four: a block's column pass needs only
// its own row pass, so the chroma rows share a step with half of the
// luma columns.
__device__ __forceinline__ void idct_passes(float* region, int lane) {
  float* slab = region;
  float* planes = region + kPlanes;
  const int e = lane & 7;  // the lane's line (row pass) or column
  float p[8];
  // step 1: the luma rows, one lane per (block, line)
  const int luma = lane >> 3;
  idct_step(slab + luma * kSlabBlock + e * kSlabLine, 1, p);
  store_line(planes + block_row(luma, e), p);
  __syncwarp();
  // step 2: lanes 0-15 the U and V rows, lanes 16-31 the columns of luma
  // blocks 0 and 1
  const bool row = lane < 16;
  const int blk2 = row ? 4 + (lane >> 3) : (lane >> 3) - 2;
  float* col2 = planes + block_row(blk2, 0) + e;
  idct_step(row ? slab + blk2 * kSlabBlock + e * kSlabLine : col2,
            row ? 1 : kLumaPitch, p);
  if (row) {
    store_line(planes + block_row(blk2, e), p);
  } else {
    store_column(col2, kLumaPitch, p);
  }
  __syncwarp();
  // step 3: lanes 0-15 the columns of luma blocks 2 and 3, lanes 16-31
  // those of U and V
  const int blk3 = 2 + (lane >> 3);
  const int pitch3 = row ? kLumaPitch : kChromaPitch;
  float* col3 = planes + block_row(blk3, 0) + e;
  idct_step(col3, pitch3, p);
  store_column(col3, pitch3, p);
  __syncwarp();
}

// sass: epilogue
// How one 8-pixel run (24 normalized values) becomes 16-byte chunks of
// the output: three uint4 of bf16 or six of float32.
template <typename Out>
struct PackRun;

template <>
struct PackRun<__nv_bfloat16> {
  static constexpr int kChunks = 3;
  // (2q - 255) / 255 of a quantized channel in one rounding,
  // fl(q * fl(2/255) - 1): a float32 a few ulps from normalize_q's, but
  // the same bf16 for every q in 0..255 (checked exhaustively in
  // tests/test_torch_dct.py), so one FFMA instead of two operations
  __device__ static float normalize(float q) {
    return __fmaf_rn(q, static_cast<float>(2.0 / 255.0), -1.0f);
  }
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
  __device__ static float normalize(float q) { return normalize_q(q); }
  __device__ static void pack(const float (&v)[24], uint4 (&c)[kChunks]) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
      c[i] = make_uint4(__float_as_uint(v[4 * i]),
                        __float_as_uint(v[4 * i + 1]),
                        __float_as_uint(v[4 * i + 2]),
                        __float_as_uint(v[4 * i + 3]));
  }
};

// BT.601 in the numpy op order, each coefficient the float32 rounding of
// the double, then clip, truncate and normalize: one lane per 8-pixel
// run of an MCU line (lines 0..15, runs 0..1). The 24 values are staged
// in the region (its planes read first) and the warp stores the MCU's
// 16 output lines with consecutive lanes on consecutive chunks.
template <typename Out>
__device__ __forceinline__ void epilogue(float* region, uint4* dst,
                                         int line_vectors, int lane) {
  constexpr int kChunks = PackRun<Out>::kChunks;  // per lane
  constexpr int kLineChunks = 2 * kChunks;        // per MCU output line
  static_assert(32 * (kChunks + 1) * 16 <= kRegionFloats * 4,
                "the staged chunks fit in the region");
  const float* planes = region + kPlanes;
  const int py = lane >> 1, run = lane & 1;
  const float* yl = planes + luma_row(py) + run * 8;
  const float* ul = planes + kU + (py >> 1) * kChromaPitch + run * 4;
  const float* vl = planes + kV + (py >> 1) * kChromaPitch + run * 4;
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
        vals[3 * p + ch] =
            PackRun<Out>::normalize(floorf(clip255(rgb[ch])));
    }
  }
  uint4 chunks[kChunks];
  PackRun<Out>::pack(vals, chunks);
  __syncwarp();  // every lane has read the planes the chunks overwrite
  uint4* stage = reinterpret_cast<uint4*>(region);
#pragma unroll
  for (int j = 0; j < kChunks; ++j)
    stage[lane * (kChunks + 1) + j] = chunks[j];
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * kLineChunks; i += 32) {
    const int line = i / kLineChunks, w = i % kLineChunks;
    dst[line * line_vectors + w] =
        stage[(2 * line + w / kChunks) * (kChunks + 1) + w % kChunks];
  }
}

// sass: -
// the 16 output lines of one MCU (line_vectors 16-byte chunks apart)
template <typename Out>
__device__ __forceinline__ uint4* mcu_out(Out* out, unsigned frame,
                                          unsigned s, unsigned c,
                                          int height, int width) {
  return reinterpret_cast<uint4*>(
      out + ((static_cast<long long>(frame) * height + s * 16) * width
             + c * 16) * 3);
}

// A pad row's MCU: zeros, nothing read.
template <typename Out>
__device__ __forceinline__ void store_zeros(uint4* dst, int line_vectors,
                                            int lane) {
  constexpr int kLineChunks = 2 * PackRun<Out>::kChunks;
  for (int i = lane; i < 16 * kLineChunks; i += 32)
    dst[(i / kLineChunks) * line_vectors + i % kLineChunks] =
        make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ int rows_valid_of(const int32_t* ptr, int rows) {
  if (ptr == nullptr) return rows;
  const int v = *ptr;
  return v < 0 ? 0 : (v > rows ? rows : v);
}

// sass: setup
template <typename Out>
__global__ void __launch_bounds__(kConvertThreads)
dct_convert_kernel(const int32_t* __restrict__ ycoef,
                   const int32_t* __restrict__ ucoef,
                   const int32_t* __restrict__ vcoef, Out* __restrict__ out,
                   const int32_t* __restrict__ rows_valid_ptr, int rows,
                   int frames, int height, int width, unsigned mcus) {
  __shared__ __align__(16) float regions[kWarps][kRegionFloats];
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
  uint4* dst = mcu_out(out, frame, s, c, height, width);
  const int line_vectors = width * 3 * static_cast<int>(sizeof(Out)) / 16;
  if (frame >= static_cast<unsigned>(rows_valid_of(rows_valid_ptr, rows))
                   * frames) {
    store_zeros<Out>(dst, line_vectors, lane);
    return;
  }
  // sass: load
  // each lane's block lines (line ids lane and lane + 32 of the 48): two
  // int4 loads each, all in flight before any is used, into the slab
  float* region = regions[warp];
  const long long chroma = (static_cast<long long>(frame) * (height / 2)
                            + s * 8) * (width / 2) + c * 8;
  int4 q[2][2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int l = lane + 32 * k;
    if (l < 48) {
      const int blk = l >> 3, line = l & 7;
      const int32_t* src =
          blk < 4
              ? ycoef + (static_cast<long long>(frame) * height + s * 16
                         + (blk >> 1) * 8 + line) * width + c * 16
                    + (blk & 1) * 8
              : (blk == 4 ? ucoef : vcoef) + chroma
                    + line * static_cast<long long>(width / 2);
      q[k][0] = reinterpret_cast<const int4*>(src)[0];
      q[k][1] = reinterpret_cast<const int4*>(src)[1];
    }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int l = lane + 32 * k;
    if (l < 48) {
      float* line = region + (l >> 3) * kSlabBlock + (l & 7) * kSlabLine;
      const int v[8] = {q[k][0].x, q[k][0].y, q[k][0].z, q[k][0].w,
                        q[k][1].x, q[k][1].y, q[k][1].z, q[k][1].w};
#pragma unroll
      for (int j = 0; j < 8; ++j) line[j] = __int2float_rn(v[j]);
    }
  }
  __syncwarp();
  // sass: idct
  idct_passes(region, lane);
  // sass: epilogue
  epilogue<Out>(region, dst, line_vectors, lane);
}

// sass: setup
// The ingest: one CTA per (frame, MCU stripe), a warp per MCU of the
// stripe (at most kStripeWarps, looping past them), at most
// kStripeBlocks CTAs on an SM at once. `smem` holds the stripe's
// 6 * across clamped counts: its two luma block rows, its U row and its
// V row.
constexpr int kStripeWarps = 7;
constexpr int kStripeBlocks = 7;

template <typename Out>
__global__ void __launch_bounds__(kStripeWarps * 32, kStripeBlocks)
dct_ingest_kernel(const int16_t* __restrict__ wire, int coeffs,
                  Out* __restrict__ out,
                  const int32_t* __restrict__ rows_valid_ptr, int rows,
                  int frames, int height, int width) {
  extern __shared__ int smem[];
  __shared__ __align__(16) float regions[kStripeWarps][kRegionFloats];
  __shared__ int partial[kStripeWarps][4];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const unsigned frame = blockIdx.x;  // row * frames + f
  const unsigned s = blockIdx.y;      // MCU stripe
  const int across = width / 16;
  const int line_vectors = width * 3 * static_cast<int>(sizeof(Out)) / 16;
  if (frame >= static_cast<unsigned>(rows_valid_of(rows_valid_ptr, rows))
                   * frames) {  // a pad row: the whole CTA
    for (int c = warp; c < across; c += warps)
      store_zeros<Out>(mcu_out(out, frame, s, c, height, width),
                       line_vectors, lane);
    return;
  }
  // sass: prefix
  const int luma_bw = 2 * across;
  const int ny = (height / 8) * luma_bw;
  const int nc = (height / 16) * across;
  const int nb = ny + 2 * nc;
  const int16_t* counts =
      wire + static_cast<long long>(frame) * (nb + 2 * coeffs);
  const int16_t* vals = counts + nb;
  const int16_t* poss = vals + coeffs;
  const int luma0 = 2 * s * luma_bw;  // the stripe's first luma block
  const int u0 = ny + s * across;     // its first U block
  const int v0 = u0 + nc;             // its first V block
  const int stripe = 6 * across;
  // stripe position j -> its block
  auto stripe_block = [&](int j) {
    return j < 4 * across ? luma0 + j
           : j < 5 * across ? u0 + j - 4 * across : v0 + j - 5 * across;
  };
  // The CTA reads the frame's counts once, every load in flight before
  // any is used: the stripe's own, and all of them for the clamped sums
  // before the stripe's luma, U and V rows and in all
  const int mine = threadIdx.x < stripe
                       ? clamp_count(counts[stripe_block(threadIdx.x)])
                       : 0;
  int sums[4] = {0, 0, 0, 0};
  for (int i0 = threadIdx.x; i0 < nb; i0 += 4 * blockDim.x) {
    int n[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * blockDim.x;
      n[k] = i < nb ? clamp_count(counts[i]) : 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * blockDim.x;
      sums[0] += i < luma0 ? n[k] : 0;
      sums[1] += i < u0 ? n[k] : 0;
      sums[2] += i < v0 ? n[k] : 0;
      sums[3] += n[k];
    }
  }
  if (threadIdx.x < stripe) smem[threadIdx.x] = mine;
  for (int j = threadIdx.x + blockDim.x; j < stripe; j += blockDim.x)
    smem[j] = clamp_count(counts[stripe_block(j)]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    sums[k] = __reduce_add_sync(kFullWarp, sums[k]);
    if (lane == 0) partial[warp][k] = sums[k];
  }
  __syncthreads();  // the only barrier wider than a warp
#pragma unroll
  for (int k = 0; k < 4; ++k)
    sums[k] = __reduce_add_sync(kFullWarp,
                                lane < warps ? partial[lane][k] : 0);
  const int limit = min(sums[3], coeffs);

  for (int c = warp; c < across; c += warps) {
    // sass: unpack
    float* region = regions[warp];
    __syncwarp();  // the previous MCU's staged chunks are stored
#pragma unroll
    for (int k = 0; k < kPlanes / 128 + 1; ++k) {
      const int i = lane + 32 * k;
      if (i < kPlanes / 4)
        reinterpret_cast<float4*>(region)[i] = make_float4(0, 0, 0, 0);
    }
    // the MCU's blocks in stripe positions: top luma 2c and 2c + 1,
    // bottom luma luma_bw on, U 4 * across + c, V 5 * across + c; the
    // counts before each within the stripe's rows, summed by the warp
    const int pos[6] = {2 * c, 2 * c + 1, luma_bw + 2 * c,
                        luma_bw + 2 * c + 1, 4 * across + c,
                        5 * across + c};
    int before[4] = {0, 0, 0, 0};  // top, bottom, U, V
    for (int j = lane; j < stripe; j += 32) {
      const int n = smem[j];
      before[0] += j < pos[0] ? n : 0;
      before[1] += j < pos[2] ? n : 0;
      before[2] += j >= 4 * across && j < pos[4] ? n : 0;
      before[3] += j >= 5 * across && j < pos[5] ? n : 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      before[k] = __reduce_add_sync(kFullWarp, before[k]);
    // block b keeps the entries [first, first + kept) of the wire, its
    // share of [0, limit); the six blocks' kept entries as one list:
    // block b holds items [begin[b], begin[b] + kept), item i at wire
    // entry i + shift[b]
    int count[6], start[6];
#pragma unroll
    for (int b = 0; b < 6; ++b) count[b] = smem[pos[b]];
    start[0] = sums[0] + before[0];
    start[1] = start[0] + count[0];
    start[2] = sums[0] + before[1];
    start[3] = start[2] + count[2];
    start[4] = sums[1] + before[2];
    start[5] = sums[2] + before[3];
    int begin[6], shift[6];
    int items = 0;
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      const int first = min(start[b], limit);
      begin[b] = items;
      shift[b] = first - items;
      items += min(start[b] + count[b], limit) - first;
    }
    __syncwarp();  // the zeros are in place before any entry lands

    // sass: rounds
    // 32 items a round, in order. A block's items are consecutive, so of
    // the lanes on one slot the highest holds the latest entry: it alone
    // stores, and the rounds are ordered -- the last entry wins
    for (int round = 0; round < items; round += 32) {
      const int item = round + lane;
      int blk = 0, entry = 0;
#pragma unroll
      for (int b = 0; b < 6; ++b) {
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
        slot = blk * kSlabBlock + __ldg(&kZigzagSlot[p]);
        value = vals[entry];
      }
      // Slots rise with the items wherever positions rise within a
      // block (blocks own disjoint, rising slot ranges): then no two
      // lanes share one, and the match is not needed
      const int next = __shfl_down_sync(kFullWarp, slot, 1);
      bool stores = item < items;
      if (!__all_sync(kFullWarp, lane == 31 || item + 1 >= items
                                     || slot < next)) {
        const unsigned same = __match_any_sync(kFullWarp, slot);
        stores = stores && (same >> lane) == 1u;
      }
      if (stores) region[slot] = __int2float_rn(value);
      __syncwarp();
    }
    // sass: idct
    idct_passes(region, lane);
    // sass: epilogue
    epilogue<Out>(region, mcu_out(out, frame, s, c, height, width),
                  line_vectors, lane);
  }
}

// sass: -
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  // above 48 KB a block's dynamic shared memory must be asked for
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The convert's grid: one warp per MCU of the pool; false when the MCUs
// cannot be counted in 32 bits
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
  const long long frames_all = static_cast<long long>(rows) * frames;
  const int across = width / 16;
  if (frames_all > 0x7fffffffLL || height / 16 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = across < kStripeWarps ? across : kStripeWarps;
  const size_t smem = 6 * static_cast<size_t>(across) * sizeof(int);
  cudaError_t err = allow_shared(dct_ingest_kernel<Out>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(frames_all),
                  static_cast<unsigned>(height / 16));
  dct_ingest_kernel<Out><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const int16_t*>(wire), coeffs, static_cast<Out*>(out),
      static_cast<const int32_t*>(rows_valid), rows, frames, height, width);
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
