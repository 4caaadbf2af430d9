// Ring-shift kernel of the shard ring collectives, hand-written for Hopper
// (sm_90a). Built by rnb_tpu_torch/ops/_kernels.py with nvcc into a shared
// library with a plain C interface, bound with ctypes.
//
// rnb_ring_shift -- port of the Pallas kernel `_pallas_shift_body`
//   (rnb_tpu/ops/handoff_dma.py:104-140, pallas_call at :134), redesigned
//   as a grouped hop. The TPU kernel DMAs each core's whole shard to the
//   neighbour `shift` places along the ring, one buffer a launch, and the
//   reference composes its all-gather from n - 1 such hops and a
//   dynamic_update_slice a hop. Here one launch moves a table of entries.
//   An entry is one buffer of every member of a ring of n <= 8: member i's
//   source goes to member (i + shift) % n's destination, byte for byte, so
//   it is exact for any dtype. Each entry has its own shift in 0..n-1:
//   shift 0 places a member's own shard, so a gather's own-slot placement
//   rides in the same launch as its first hop. An entry's buffers are
//   `rows` rows of `row_bytes` at a row pitch of their own (source and
//   destination apart): one row is a dim-0 slot, several rows a column
//   block of a row-major matrix (the logits' merge along the class axis).
//   Destinations are the slots of the gathered tensors themselves, so a
//   gather needs no placement copies (rnb_tpu_torch/ops/handoff_dma.py).
//   The ring's members share one card (a ring over several cards raises in
//   rnb_tpu_torch/parallel/mesh.py); the cross-card form, with peer
//   pointers written over NVLink, is the multi-card slice's work.
//
//   Bound: memory. Every byte is read once and written once: a degree-2
//   forward's 19 weight gathers read 2 x 9.15 MB of shards and write 2 x
//   18.3 MB of full-width weights, about 16.4 us at 3.35 TB/s; the conv5
//   temporal hop alone moves 2 x 1,769,472 B (2.1 us). Small leaves and
//   the merge blocks are bound by the launch.
//
//   Design: one flat grid over all (entry, member) tiles. The C entry
//   resolves each tile's source, destination and pitches and passes the
//   table by value in the kernel's parameters (kMaxTiles tiles, 3,848 B,
//   under the 4 KB that every CUDA version takes), so a launch needs no
//   table in device memory and captures into a CUDA graph as it stands.
//   The parameters carry a prefix sum of the tiles' block counts; a block
//   finds its tile by a binary search over it. The table is
//   __grid_constant__, so that search and the tile's fields read the
//   parameter space in place: a run-time index into a by-value struct
//   made every thread copy it to a stack frame first (128 B a thread in
//   the first version). `-Xptxas -v` reports the frame on every build
//   (chip_smoke.py prints it). A block moves one 16 KB chunk of its tile:
//   each thread holds kVectors 16-byte vectors in registers before it
//   stores any, so a block keeps 16 KB of loads in flight; a 2 KB leaf and
//   the 3.5 MB conv5 leaf share one launch with no idle grid rows. A byte
//   loop covers the tail, and a tile whose pointers, or row length and
//   pitches, are not multiples of 16 goes through the byte loop whole.
//   A larger table is split by the wrapper into as few launches as fit.
//   No TMA or cp.async.bulk: a copy with no reuse gains nothing from
//   staging through shared memory, and plain loads keep the kernel inside
//   the host emulation (tests/host_cuda/) that checks its indexing.
//
//   Measured (chip_smoke.py's ring phase and tools/kernel_probe.py on an
//   NVIDIA H100 80GB HBM3 at 700 W; ptxas: 40 registers, 0 bytes of
//   stack frame): a degree-2 forward's 19 gathers in one launch 0.0208 ms
//   with L2 warm, 0.0212 flushed (79% / 77% of 0.0164), where 19 gathers
//   one leaf a launch took 0.0518; the conv5 hop alone 0.00253 / 0.00485
//   (84% / 44% of 0.00211: flushed, the first DRAM round trip of a 3.5 MB
//   copy is not hidden); the merge, four tiles of rows at a pitch, 0.00177
//   (launch-bound). 8 or 16 vectors a thread measured slower at all three;
//   a 32-bit division a vector on pitched tiles cost the merge 0.00035 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxMembers = 8;
// (entry, member) tiles a launch moves at most: the parameters stay under
// 4 KB
constexpr int kMaxTiles = 80;
constexpr int kThreads = 256;
// 16-byte vectors a thread holds in registers at once: 8 and 16 (fewer,
// larger blocks) measured slower at every shape of PERF.md, row 5
constexpr int kVectors = 4;
// bytes a block moves: one chunk of its tile
constexpr long long kChunk = 16LL * kThreads * kVectors;
constexpr long long kMaxInt = 0x7fffffffLL;
// bytes a tile with rows holds at most (its rows are found by 32-bit
// division)
constexpr long long kMaxRowsTile = 0xffffffffLL;

struct RingTiles {
  const uint8_t* src[kMaxTiles];
  uint8_t* dst[kMaxTiles];
  long long row_bytes[kMaxTiles];
  long long src_pitch[kMaxTiles];
  long long dst_pitch[kMaxTiles];
  int rows[kMaxTiles];
  // tile t owns blocks first_block[t] .. first_block[t + 1] - 1
  int first_block[kMaxTiles + 1];
  int count;
};

// Where a thread's bytes b, b + step, b + 2 step, ... of a tile lie in its
// source and its destination. One row (Dense): at b itself. Rows at a
// pitch (Pitched; under 4 GiB, the C entry refuses more): the row and the
// byte within it found by one 32-bit division at the start and carried by
// adds, so a step costs no division.
struct Dense {
  long long b;
  long long step;
  __device__ __forceinline__ Dense(long long first, long long stride,
                                   const RingTiles&, int)
      : b(first), step(stride) {}
  __device__ __forceinline__ long long src() const { return b; }
  __device__ __forceinline__ long long dst() const { return b; }
  __device__ __forceinline__ void next() { b += step; }
};

struct Pitched {
  long long src_pitch;
  long long dst_pitch;
  unsigned row_bytes, row, col, step_rows, step_col;
  __device__ __forceinline__ Pitched(long long first, long long stride,
                                     const RingTiles& tiles, int t)
      : src_pitch(tiles.src_pitch[t]), dst_pitch(tiles.dst_pitch[t]),
        row_bytes(static_cast<unsigned>(tiles.row_bytes[t])) {
    row = static_cast<unsigned>(first) / row_bytes;
    col = static_cast<unsigned>(first) - row * row_bytes;
    step_rows = static_cast<unsigned>(stride) / row_bytes;
    step_col = static_cast<unsigned>(stride) - step_rows * row_bytes;
  }
  __device__ __forceinline__ long long src() const {
    return row * src_pitch + col;
  }
  __device__ __forceinline__ long long dst() const {
    return row * dst_pitch + col;
  }
  __device__ __forceinline__ void next() {
    row += step_rows;
    col += step_col;
    if (col >= row_bytes) {
      col -= row_bytes;
      ++row;
    }
  }
};

// Bytes begin..end of tile t (packed rows), 16-byte vectors where
// `vectors`: every load of the chunk in flight before its first store,
// then a byte loop over what is left.
template <typename Offsets>
__device__ __forceinline__ void move_chunk(const RingTiles& tiles, int t,
                                           long long begin, long long end,
                                           bool vectors) {
  const uint8_t* __restrict__ from = tiles.src[t];
  uint8_t* __restrict__ to = tiles.dst[t];
  long long tail = begin;
  if (vectors) {
    const long long first = begin / 16 + threadIdx.x;
    const long long last = end / 16;
    const Offsets start(16 * first, 16LL * kThreads, tiles, t);
    uint4 held[kVectors];
    Offsets at = start;
#pragma unroll
    for (int k = 0; k < kVectors; ++k) {
      if (first + k * kThreads < last) {
        held[k] = *reinterpret_cast<const uint4*>(from + at.src());
      }
      at.next();
    }
    at = start;
#pragma unroll
    for (int k = 0; k < kVectors; ++k) {
      if (first + k * kThreads < last) {
        *reinterpret_cast<uint4*>(to + at.dst()) = held[k];
      }
      at.next();
    }
    tail = 16 * last;
  }
  Offsets at(tail + threadIdx.x, kThreads, tiles, t);
  for (long long b = tail + threadIdx.x; b < end; b += kThreads) {
    to[at.dst()] = from[at.src()];
    at.next();
  }
}

__global__ void __launch_bounds__(kThreads)
ring_shift_kernel(const __grid_constant__ RingTiles tiles) {
  const int block = static_cast<int>(blockIdx.x);
  int lo = 0;
  int hi = tiles.count;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tiles.first_block[mid] <= block) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const long long row_bytes = tiles.row_bytes[lo];
  const long long total = tiles.rows[lo] * row_bytes;
  const long long begin =
      static_cast<long long>(block - tiles.first_block[lo]) * kChunk;
  const long long end = begin + kChunk < total ? begin + kChunk : total;
  const bool rows = tiles.rows[lo] > 1;
  // a row's length and pitches matter only where the tile has rows
  const long long sizes =
      rows ? row_bytes | tiles.src_pitch[lo] | tiles.dst_pitch[lo] : 0;
  const bool vectors =
      ((reinterpret_cast<uintptr_t>(tiles.src[lo]) |
        reinterpret_cast<uintptr_t>(tiles.dst[lo]) |
        static_cast<uintptr_t>(sizes)) & 15u) == 0;
  if (rows) {
    move_chunk<Pitched>(tiles, lo, begin, end, vectors);
  } else {
    move_chunk<Dense>(tiles, lo, begin, end, vectors);
  }
}

}  // namespace

extern "C" {

const char* rnb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One launch over a table of `entries` entries of a ring of n members.
// Entry e, member i: its source srcs[e * n + i] (rows of row_bytes[e] at a
// pitch of src_pitch[e * n + i] bytes) goes to member (i + shifts[e]) % n,
// into dsts[e * n + that member] at a pitch of dst_pitch[e * n + that
// member]. A pitch is read only where rows[e] > 1. All pointers on one
// card (checked by the Python wrapper). Refused: n outside 1..8, a shift
// outside 0..n-1, negative sizes, a pitch under its row, 4 GiB or more in
// rows at a pitch, and more than kMaxTiles (entry, member) pairs. Empty
// entries launch nothing; a table of them none at all. Reads the arrays
// before it returns.
int rnb_ring_shift(const void* const* srcs, void* const* dsts,
                   const long long* src_pitch, const long long* dst_pitch,
                   const int* shifts, const long long* rows,
                   const long long* row_bytes, int n, int entries,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || n > kMaxMembers || entries < 0 ||
      static_cast<long long>(entries) * n > kMaxTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingTiles tiles = {};
  long long blocks = 0;
  for (int e = 0; e < entries; ++e) {
    const long long r = rows[e];
    const long long bytes = row_bytes[e];
    if (shifts[e] < 0 || shifts[e] >= n || r < 0 || r > kMaxInt ||
        bytes < 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int i = 0; i < n; ++i) {
      const int from = e * n + i;
      const int to = e * n + (i + shifts[e]) % n;
      if (r > 1 && (src_pitch[from] < bytes || dst_pitch[to] < bytes)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      if (r == 0 || bytes == 0) continue;
      const int t = tiles.count++;
      tiles.src[t] = static_cast<const uint8_t*>(srcs[from]);
      tiles.dst[t] = static_cast<uint8_t*>(dsts[to]);
      if (r == 1 || (src_pitch[from] == bytes && dst_pitch[to] == bytes)) {
        // one dense block on both sides: one row
        tiles.rows[t] = 1;
        tiles.row_bytes[t] = r * bytes;
        tiles.src_pitch[t] = tiles.dst_pitch[t] = r * bytes;
      } else {
        if (r * bytes > kMaxRowsTile) {
          return static_cast<int>(cudaErrorInvalidValue);
        }
        tiles.rows[t] = static_cast<int>(r);
        tiles.row_bytes[t] = bytes;
        tiles.src_pitch[t] = src_pitch[from];
        tiles.dst_pitch[t] = dst_pitch[to];
      }
      tiles.first_block[t] = static_cast<int>(blocks);
      blocks += (r * bytes + kChunk - 1) / kChunk;
      if (blocks > kMaxInt) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (tiles.count == 0) return 0;
  tiles.first_block[tiles.count] = static_cast<int>(blocks);
  ring_shift_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
