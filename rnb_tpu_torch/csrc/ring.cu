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
//   Within one process the ring's members share one card (a ring over
//   several cards of one process raises in rnb_tpu_torch/parallel/mesh.py).
//
// rnb_ring_hop -- the same kernel across processes: the TPU kernel's remote
//   copy with its send/recv semaphore pair (make_async_remote_copy, then
//   copy.wait()), for a ring whose members lie in different processes,
//   one member a process, each with its own CUDA context. As the TPU's
//   DMA lands in `output_ref` on the neighbour, a hop writes each byte
//   once, straight into the successor's destination, in one launch on the
//   sender. Each member owns a result arena (segments allocated with
//   cudaMalloc, each the base of its own allocation) and a counter
//   allocation laid out as kRecv .. kPost below, both opened once by its
//   peers through CUDA IPC with the lazy peer-access flag
//   (rnb_tpu_torch/parallel/peers.py): on one card the peers' stores land
//   in the same HBM, across cards they travel over NVLink with no change
//   here. The collectives the port runs allocate their results in the
//   arena, so the successor's destination is memory the sender can reach.
//   Hop e of member m is one launch on m's stream, of one block more
//   than its tiles need, the control block:
//     post:    the control block claims the post and writes where hop e
//              lands in m (the arena place, rows, row length and pitch of
//              every tile m receives: the table's own tiles
//              0 .. remote - 1 carry them) into m's counter allocation,
//              then stores e into its `posted` word with release at
//              system scope. A data block whose wait below spins claims
//              it too, so none waits on a block not yet scheduled. The
//              post of hop e - 1 is no longer read: m's previous launch
//              ended only once that hop had landed in m;
//     wait:    every data block waits until the successor's `posted`
//              reaches e (the error word read beside it), then its threads
//              check the successor's post against this member's tiles: as
//              many tiles, each of the same rows and row length, each
//              inside one of the successor's arena segments, while they
//              load their chunk of the source. A post that disagrees
//              writes the error word (kTablesDiffer) in every block, so no
//              byte moves: processes whose tables disagree fail before
//              anything is written;
//     move:    tiles 0 .. remote - 1 into the successor's arena at its
//              posted places and pitches, the rest (shift 0, within the
//              member) where the table says;
//     publish: every block counts itself into m's `done` word with an
//              acq_rel add at GPU scope; the data block that finds itself
//              last has seen every block's stores and adds one to the
//              successor's `recv` with release at system scope (causality
//              is transitive across the two scopes); meanwhile the control
//              block waits for its own `recv` to reach e (the
//              predecessor's hop e has landed in m) and for every block's
//              count, resets `done` and `claim` for the next launch, and
//              copies a set error word into pinned host memory.
//   So each collective the port runs takes one launch a hop, and nothing
//   reads a result before it has landed (the launch that made it ends
//   only then). A caller's own destination
//   outside the arena lands in an arena slot and one local launch of this
//   kernel (no post, no wait, moving nothing once the error word is set)
//   places it (rnb_tpu_torch/ops/handoff_dma.py). The host emulation
//   (tests/host_cuda/) runs a grid's blocks one after another, so there
//   the control block is the grid's last (kControlFirst): its waits come
//   after every data block.
//   Every wait is bounded: past `cap_ns` of the global timer, or when
//   another wait of the same member already gave up, the thread writes
//   the member's error word (kTimedOut), its block moves nothing, and the
//   last block signals nothing, so the peer's wait gives up in turn; the
//   wrapper reads the pinned word after the collective with no copy and
//   raises: a dead peer fails the run, it never hangs it. (Every block
//   reading the pinned word would cross PCIe each time: a hop took
//   0.26 ms so, against 0.0095.) The route is
//   device counters rather than IPC events: an event wait
//   (cudaStreamWaitEvent on an interprocess event) cannot be bounded.
//
//   Two contexts on one card time-slice (no MPS): a waiting kernel holds
//   its context's slice until the scheduler switches, so a hop between two
//   processes on one card costs about a slice on top of its copy (PERF.md
//   section 7).
//
//   Bound: the shard read once and written once, 2 x 1,769,472 B for the
//   conv5 temporal hop, 0.00106 ms at 3.35 TB/s. What each choice does
//   (tools/hop_probe.py cuts each part out or swaps it):
//   each byte moved once, by one launch, so one publication a hop; the
//   publication without a fence of its own in every block (an acq_rel
//   count at GPU scope, one release at system scope: a GPU-scope fence in
//   every block and a system-scope one in the last cost the launch
//   0.0017 ms more); the post and the waits for the own `recv` and the
//   blocks' counts in the control block, off the copy's path (the post
//   cut out saves 0.0004); the post checked while the chunk loads (0.0071
//   ms with L2 flushed without it, 0.0067 with). Kept: the 16 KB chunk of
//   registers a block. 8 KB, 32 KB, and the 1-D bulk copy through shared
//   memory (cp.async.bulk behind an mbarrier, one thread a block) came
//   within 2% of it warm and 3-11% slower flushed; the bulk copy alone
//   was 25% slower. The plain path also keeps the kernel inside the host
//   emulation.
//
//   Measured (tools/hop_probe.py, two processes on an NVIDIA H100 80GB
//   HBM3 at 700 W; ptxas: 0 bytes of stack frame): the conv5 hop's launch
//   alone, its waits satisfied, 0.00597-0.00600 ms with L2 warm and
//   0.0067 flushed (18% / 16% of the bound), where the parent commit's
//   hop (a send launch into a receive window and a place launch out of
//   it) took 0.00958 and 0.0122 in the same call, and Tensor.copy_ of the
//   shard into the peer's arena 0.00148 / 0.0029. What holds it: the copy
//   alone (a local launch) 0.0021; the signal's release at system scope
//   0.0018 (the launch without it 0.0042; every system-scope operation at
//   GPU scope instead 0.0041, right on one card only); the rest is the
//   wait's load, the post's check and the count. With its semaphores, a
//   hop between two processes on one card costs about two time slices
//   (PERF.md, section 6, row 5b).
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
#include <string.h>
#ifdef RNB_HOST_EMULATION
#include <atomic>
#include <chrono>
#include <thread>
#endif

namespace {

constexpr int kMaxMembers = 8;
// (entry, member) tiles a launch moves at most: the parameters stay under
// 4 KB
constexpr int kMaxTiles = 80;
// tiles a hop's launch moves at most: with the successor's arena segments
// its parameters stay under 4 KB
constexpr int kMaxHopTiles = 64;
// segments of a member's arena, and the bits of a segment's offset in a
// posted place (segment << kSegmentShift | offset)
constexpr int kMaxSegments = 16;
constexpr int kSegmentShift = 40;
constexpr long long kOffsetMask = (1LL << kSegmentShift) - 1;
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

// A member's counter allocation (rnb_tpu_torch/parallel/peers.py mirrors
// the offsets): hops landed in its arena (added to by the predecessor),
// hops it has posted, its launch's finished blocks (a 64-bit word: their
// count, and in its high half those that moved nothing), its launch's
// started blocks, its error word, and its post: the tiles' count, then
// one PostTile a tile.
constexpr int kRecv = 0;
constexpr int kPosted = 64;
constexpr int kDone = 128;
constexpr int kClaim = 192;
constexpr int kError = 256;
constexpr int kPostCount = 320;
constexpr int kPost = 384;

// Where one tile of a hop lands in the member that posts it.
struct PostTile {
  unsigned long long place;  // segment << kSegmentShift | offset
  long long rows;
  long long row_bytes;
  long long pitch;
};

// the error word's value after a wait timed out
constexpr int kTimedOut = 1;
// the error word's value where the successor posted other tiles than this
// member's table sends (the processes' tables disagree)
constexpr int kTablesDiffer = 2;

// The system-scope primitives of a hop (the host emulation runs them on
// std::atomic_ref).
#ifdef RNB_HOST_EMULATION
__device__ __forceinline__ unsigned long long load_acquire_sys(
    const unsigned long long* p) {
  return std::atomic_ref<const unsigned long long>(*p).load(
      std::memory_order_acquire);
}
__device__ __forceinline__ unsigned long long load_acquire_gpu(
    const unsigned long long* p) {
  return std::atomic_ref<const unsigned long long>(*p).load(
      std::memory_order_acquire);
}
__device__ __forceinline__ void add_release_sys(unsigned long long* p) {
  std::atomic_ref<unsigned long long>(*p).fetch_add(
      1, std::memory_order_release);
}
__device__ __forceinline__ void store_release_sys(unsigned long long* p,
                                                  unsigned long long v) {
  std::atomic_ref<unsigned long long>(*p).store(v,
                                                std::memory_order_release);
}
__device__ __forceinline__ unsigned long long add_acq_rel_gpu(
    unsigned long long* p, unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(
      v, std::memory_order_acq_rel);
}
__device__ __forceinline__ unsigned add_relaxed(unsigned* p) {
  return std::atomic_ref<unsigned>(*p).fetch_add(1,
                                                 std::memory_order_relaxed);
}
__device__ __forceinline__ int load_error(const int* p) {
  return std::atomic_ref<const int>(*p).load(std::memory_order_relaxed);
}
__device__ __forceinline__ void store_error(int* p, int v) {
  std::atomic_ref<int>(*p).store(v, std::memory_order_relaxed);
}
__device__ __forceinline__ long long load_word(const long long* p) {
  return std::atomic_ref<const long long>(*p).load(
      std::memory_order_relaxed);
}
__device__ __forceinline__ void store_word(long long* p, long long v) {
  std::atomic_ref<long long>(*p).store(v, std::memory_order_relaxed);
}
__device__ __forceinline__ unsigned long long clock_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}
__device__ __forceinline__ void pause() { std::this_thread::yield(); }
#else
__device__ __forceinline__ unsigned long long load_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ unsigned long long load_acquire_gpu(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void add_release_sys(unsigned long long* p) {
  asm volatile("red.release.sys.global.add.u64 [%0], 1;"
               :
               : "l"(p)
               : "memory");
}
__device__ __forceinline__ void store_release_sys(unsigned long long* p,
                                                  unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :
               : "l"(p), "l"(v)
               : "memory");
}
__device__ __forceinline__ unsigned long long add_acq_rel_gpu(
    unsigned long long* p, unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;"
               : "=l"(old)
               : "l"(p), "l"(v)
               : "memory");
  return old;
}
__device__ __forceinline__ unsigned add_relaxed(unsigned* p) {
  return atomicAdd(p, 1u);
}
__device__ __forceinline__ int load_error(const int* p) {
  return *static_cast<const volatile int*>(p);
}
__device__ __forceinline__ void store_error(int* p, int v) {
  *static_cast<volatile int*>(p) = v;
}
__device__ __forceinline__ long long load_word(const long long* p) {
  return *static_cast<const volatile long long*>(p);
}
__device__ __forceinline__ void store_word(long long* p, long long v) {
  *static_cast<volatile long long*>(p) = v;
}
__device__ __forceinline__ unsigned long long clock_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void pause() { __nanosleep(64); }
#endif

// The first thread of a block: wait for *word to reach `target`. False
// where the wait gave up (past cap_ns, or the member's error word set
// meanwhile), with the error word written. A counter already reached
// costs its one load: the clock is read only once the wait spins. Where
// `stalled` is set, it is called once, after kPostAfter spins. Inlined,
// as every helper of the hop kernel: a call spills registers to a stack
// frame.
constexpr unsigned kPostAfter = 64;
template <typename Stalled>
__device__ __forceinline__ bool wait_counter(const unsigned long long* word,
                                             unsigned long long target,
                                             int* error,
                                             unsigned long long cap_ns,
                                             Stalled* stalled) {
  unsigned long long start = 0;
  unsigned spins = 0;
  while (load_acquire_sys(word) < target) {
    if (start == 0) start = clock_ns();
    if ((++spins & 31u) == 0) {
      if (load_error(error) != 0) return false;
      if (clock_ns() - start > cap_ns) {
        store_error(error, kTimedOut);
        return false;
      }
      if (stalled != nullptr && spins == kPostAfter) stalled->run();
    }
    pause();
  }
  return true;
}

template <int N>
struct Tiles {
  const uint8_t* src[N];
  uint8_t* dst[N];
  long long row_bytes[N];
  long long src_pitch[N];
  long long dst_pitch[N];
  int rows[N];
  // tile t owns blocks first_block[t] .. first_block[t + 1] - 1
  int first_block[N + 1];
  int count;
};
using RingTiles = Tiles<kMaxTiles>;
using HopTiles = Tiles<kMaxHopTiles>;

// One tile of a hop as a block moves it: its two ends (where it lands in
// the successor, the place and pitch the post gives), its rows' length and
// pitches. rnb_ring_shift reads its table in place instead (move_block).
struct TileView {
  const uint8_t* from;
  uint8_t* to;
  long long row_bytes;
  long long src_pitch;
  long long dst_pitch;
  int rows;
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
  __device__ __forceinline__ Dense(long long first, long long stride,
                                   const TileView&)
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
  __device__ __forceinline__ Pitched(long long first, long long stride,
                                     const TileView& tile)
      : src_pitch(tile.src_pitch), dst_pitch(tile.dst_pitch),
        row_bytes(static_cast<unsigned>(tile.row_bytes)) {
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

// Bytes of block `block`'s chunk: find its tile, then move the chunk.
__device__ __forceinline__ void move_block(const RingTiles& tiles,
                                           int block) {
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

__global__ void __launch_bounds__(kThreads)
ring_shift_kernel(const __grid_constant__ RingTiles tiles) {
  move_block(tiles, static_cast<int>(blockIdx.x));
}

// move_chunk of a hop's tile, its ends and pitches in a TileView. One body
// shared with rnb_ring_shift's (a TileView built from its table) cost its
// conv5 hop 7% (0.00257-0.00262 ms against 0.00240-0.00244 in one call,
// tools/kernel_probe.py --only ring on this tree and its parent), so
// rnb_ring_shift keeps its own.
template <typename Offsets>
__device__ __forceinline__ void move_chunk(const TileView& tile,
                                           long long begin, long long end,
                                           bool vectors) {
  const uint8_t* __restrict__ from = tile.from;
  uint8_t* __restrict__ to = tile.to;
  long long tail = begin;
  if (vectors) {
    const long long first = begin / 16 + threadIdx.x;
    const long long last = end / 16;
    const Offsets start(16 * first, 16LL * kThreads, tile);
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
  Offsets at(tail + threadIdx.x, kThreads, tile);
  for (long long b = tail + threadIdx.x; b < end; b += kThreads) {
    to[at.dst()] = from[at.src()];
    at.next();
  }
}

// The chunk'th chunk of a tile.
__device__ __forceinline__ void move_view(const TileView& tile, int chunk) {
  const long long total = tile.rows * tile.row_bytes;
  const long long begin = static_cast<long long>(chunk) * kChunk;
  const long long end = begin + kChunk < total ? begin + kChunk : total;
  const bool rows = tile.rows > 1;
  // a row's length and pitches matter only where the tile has rows
  const long long sizes =
      rows ? tile.row_bytes | tile.src_pitch | tile.dst_pitch : 0;
  const bool vectors =
      ((reinterpret_cast<uintptr_t>(tile.from) |
        reinterpret_cast<uintptr_t>(tile.to) |
        static_cast<uintptr_t>(sizes)) & 15u) == 0;
  if (rows) {
    move_chunk<Pitched>(tile, begin, end, vectors);
  } else {
    move_chunk<Dense>(tile, begin, end, vectors);
  }
}

// The tile that block `block` moves a chunk of: a binary search over the
// prefix sum of the tiles' block counts.
template <int N>
__device__ __forceinline__ int find_tile(const Tiles<N>& tiles, int block) {
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
  return lo;
}

template <int N>
__device__ __forceinline__ TileView view_of(const Tiles<N>& tiles, int t) {
  return TileView{tiles.src[t], tiles.dst[t], tiles.row_bytes[t],
                  tiles.src_pitch[t], tiles.dst_pitch[t], tiles.rows[t]};
}

// The synchronisation of a hop's launch.
struct HopSync {
  // the successor's counter allocation as mapped here, or null: a local
  // launch (no post, no wait, no signal; it moves nothing once the error
  // word is set)
  const uint8_t* succ;
  // this member's counter allocation
  uint8_t* own;
  // pinned host memory the last block copies a set error word into, or
  // null
  int* report;
  // the hop's number: the successor's `posted` and this member's `recv`
  // reach it
  unsigned long long epoch;
  unsigned long long cap_ns;
  // tiles 0 .. remote - 1 land in the successor's arena
  int remote;
  // the successor's arena segments as mapped here
  int segments;
  uint8_t* segment[kMaxSegments];
  long long segment_bytes[kMaxSegments];
};

template <typename T>
__device__ __forceinline__ T* word(const uint8_t* base, int offset) {
  return reinterpret_cast<T*>(const_cast<uint8_t*>(base) + offset);
}

// The block of a hop's grid that moves nothing: block 0 on the card, which
// the scheduler starts first, so it usually wins the post. The host
// emulation runs a grid's blocks one after another, so there it is the
// last block, run once every data block has counted itself.
#ifdef RNB_HOST_EMULATION
constexpr int kControlFirst = 0;
#else
constexpr int kControlFirst = 1;
#endif
__device__ __forceinline__ bool is_control(int block) {
  return kControlFirst ? block == 0
                       : block == static_cast<int>(gridDim.x) - 1;
}

// The post of a hop, by one thread, once a claim of it wins: where each
// tile this member receives lands in it, then the hop's number with
// release at system scope.
struct Poster {
  const HopTiles& tiles;
  const HopSync& sync;
  __device__ __forceinline__ void run() const {
    if (add_relaxed(word<unsigned>(sync.own, kClaim)) != 0) return;
    PostTile* post = word<PostTile>(sync.own, kPost);
    for (int t = 0; t < sync.remote; ++t) {
      store_word(reinterpret_cast<long long*>(&post[t].place),
                 reinterpret_cast<long long>(tiles.dst[t]));
      store_word(&post[t].rows, tiles.rows[t]);
      store_word(&post[t].row_bytes, tiles.row_bytes[t]);
      store_word(&post[t].pitch, tiles.dst_pitch[t]);
    }
    store_word(word<long long>(sync.own, kPostCount), sync.remote);
    store_release_sys(word<unsigned long long>(sync.own, kPosted),
                      sync.epoch);
  }
};

// The hop (see the note at the top). A hop's grid has one block more than
// its tiles need, the control block (is_control), which moves nothing: it
// claims the post and posts (any block that runs can: a data block whose
// wait for the successor's post spins claims it too, so none waits on a
// block not yet scheduled). The data blocks wait for the successor's post,
// load their chunk while they check the post, store it, and count
// themselves into `done` (the low 32 bits; a block that moved nothing
// because a wait gave up, the post disagreed or an earlier hop failed,
// into the high half too); the last to count signals where none failed.
// The control block counts itself, waits for its own `recv`, then for
// every block's count, resets `done` and `claim` for the next launch and
// reports an error, so its waits stay off the copy's path. A grid of the
// control block alone (a hop with no tiles) waits for and checks the post
// itself, and signals.
__global__ void __launch_bounds__(kThreads)
ring_hop_kernel(const __grid_constant__ HopTiles tiles,
                const __grid_constant__ HopSync sync) {
  __shared__ int go;
  // the successor's place and pitch of this block's tile, where it lands
  // there
  __shared__ uint8_t* to;
  __shared__ long long pitch;
  const bool hop = sync.succ != nullptr;
  const int grid_block = static_cast<int>(blockIdx.x);
  const bool control = hop && is_control(grid_block);
  const int block = grid_block - (hop ? kControlFirst : 0);
  const bool moves = !control && block >= 0 &&
                     block < tiles.first_block[tiles.count];
  const int mine = moves ? find_tile(tiles, block) : -1;
  int* error = word<int>(sync.own, kError);
  unsigned long long* done = word<unsigned long long>(sync.own, kDone);
  // the control block checks the post only where no data block does
  const bool checks = hop && (!control || gridDim.x == 1);
  if (threadIdx.x == 0) {
    const Poster poster{tiles, sync};
    if (control) poster.run();
    // the error word and the successor's post read at once
    const int earlier = load_error(error);
    go = !checks ||
         wait_counter(word<unsigned long long>(sync.succ, kPosted),
                      sync.epoch, error, sync.cap_ns, &poster);
    go = go && earlier == 0;
  }
  __syncthreads();
  bool moving = go;
  TileView tile = {};
  long long begin = 0;
  long long end = 0;
  // a dense, 16-byte aligned chunk is loaded while the post is checked
  bool early = false;
  uint4 held[kVectors];
  if (moving && moves) {
    tile = view_of(tiles, mine);
    const long long total = tile.rows * tile.row_bytes;
    begin = static_cast<long long>(block - tiles.first_block[mine]) * kChunk;
    end = begin + kChunk < total ? begin + kChunk : total;
    early = tile.rows == 1 &&
            ((reinterpret_cast<uintptr_t>(tile.from) |
              static_cast<uintptr_t>(end)) & 15u) == 0;
    if (early) {
      const uint4* from = reinterpret_cast<const uint4*>(tile.from);
#pragma unroll
      for (int k = 0; k < kVectors; ++k) {
        const long long v = begin / 16 + threadIdx.x + k * kThreads;
        if (v < end / 16) held[k] = from[v];
      }
    }
  }
  if (checks && moving) {
    bool bad = threadIdx.x == 0 &&
               load_word(word<long long>(sync.succ, kPostCount)) !=
                   sync.remote;
    for (int t = threadIdx.x; t < sync.remote; t += kThreads) {
      const PostTile* post = word<PostTile>(sync.succ, kPost) + t;
      const unsigned long long place = static_cast<unsigned long long>(
          load_word(reinterpret_cast<const long long*>(&post->place)));
      const long long rows = load_word(&post->rows);
      const long long row_bytes = load_word(&post->row_bytes);
      const long long at = load_word(&post->pitch);
      const unsigned long long segment = place >> kSegmentShift;
      const long long room =
          segment < static_cast<unsigned long long>(sync.segments)
              ? sync.segment_bytes[segment] -
                    static_cast<long long>(place & kOffsetMask)
              : -1;
      // rows - 1 rows of `at` and one of row_bytes fit the room: the
      // product's high half is 0 (a 64-bit division would be a call)
      const unsigned long long over =
          static_cast<unsigned long long>(rows - 1) *
          static_cast<unsigned long long>(at);
      bad = bad || rows != tiles.rows[t] ||
            row_bytes != tiles.row_bytes[t] || room < row_bytes ||
            (rows > 1 &&
             (at < row_bytes ||
              __umul64hi(static_cast<unsigned long long>(rows - 1),
                         static_cast<unsigned long long>(at)) != 0 ||
              over > static_cast<unsigned long long>(room - row_bytes)));
      if (t == mine) {
        to = room < 0 ? nullptr
                      : sync.segment[segment] +
                            static_cast<long long>(place & kOffsetMask);
        pitch = at;
      }
    }
    if (__syncthreads_or(bad)) {
      if (threadIdx.x == 0) store_error(error, kTablesDiffer);
      moving = false;
    }
  }
  if (moving && moves) {
    if (mine < sync.remote) {
      tile.to = to;
      tile.dst_pitch = pitch;
    }
    if (early && (reinterpret_cast<uintptr_t>(tile.to) & 15u) == 0) {
      uint4* into = reinterpret_cast<uint4*>(tile.to);
#pragma unroll
      for (int k = 0; k < kVectors; ++k) {
        const long long v = begin / 16 + threadIdx.x + k * kThreads;
        if (v < end / 16) into[v] = held[k];
      }
    } else {
      move_view(tile, block - tiles.first_block[mine]);
    }
  }
  __syncthreads();
  if (!hop || threadIdx.x != 0) return;
  const unsigned long long mark = moving ? 1ull : 1ull + (1ull << 32);
  const unsigned long long seen = add_acq_rel_gpu(done, mark) + mark;
  if ((seen & 0xffffffffull) == gridDim.x && (seen >> 32) == 0) {
    // every block's stores are counted: publish the hop
    add_release_sys(word<unsigned long long>(
        const_cast<uint8_t*>(sync.succ), kRecv));
  }
  if (!control) return;
  // the predecessor's hop has landed here, and every block has counted
  const bool landed =
      wait_counter(word<unsigned long long>(sync.own, kRecv), sync.epoch,
                   error, sync.cap_ns, static_cast<const Poster*>(nullptr));
  unsigned long long all = seen;
  while ((all & 0xffffffffull) != gridDim.x) {
    pause();
    all = load_acquire_gpu(done);
  }
  *done = 0;
  *word<unsigned>(sync.own, kClaim) = 0;
  if ((!landed || (all >> 32) != 0) && sync.report != nullptr) {
    store_error(sync.report, load_error(error));
  }
}

// Resolve a table of `entries` entries of a ring of n members into tiles
// and a grid (see rnb_ring_shift); 0, or the CUDA error code of what it
// refuses.
template <int N>
int fill_tiles(const void* const* srcs, void* const* dsts,
               const long long* src_pitch, const long long* dst_pitch,
               const int* shifts, const long long* rows,
               const long long* row_bytes, int n, int entries,
               Tiles<N>* tiles, long long* grid) {
  if (n < 1 || n > kMaxMembers || entries < 0 ||
      static_cast<long long>(entries) * n > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
      const int t = tiles->count++;
      tiles->src[t] = static_cast<const uint8_t*>(srcs[from]);
      tiles->dst[t] = static_cast<uint8_t*>(dsts[to]);
      if (r == 1 || (src_pitch[from] == bytes && dst_pitch[to] == bytes)) {
        // one dense block on both sides: one row
        tiles->rows[t] = 1;
        tiles->row_bytes[t] = r * bytes;
        tiles->src_pitch[t] = tiles->dst_pitch[t] = r * bytes;
      } else {
        if (r * bytes > kMaxRowsTile) {
          return static_cast<int>(cudaErrorInvalidValue);
        }
        tiles->rows[t] = static_cast<int>(r);
        tiles->row_bytes[t] = bytes;
        tiles->src_pitch[t] = src_pitch[from];
        tiles->dst_pitch[t] = dst_pitch[to];
      }
      tiles->first_block[t] = static_cast<int>(blocks);
      blocks += (r * bytes + kChunk - 1) / kChunk;
      if (blocks > kMaxInt) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  tiles->first_block[tiles->count] = static_cast<int>(blocks);
  *grid = blocks;
  return 0;
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
  RingTiles tiles = {};
  long long blocks = 0;
  const int refused = fill_tiles(srcs, dsts, src_pitch, dst_pitch, shifts,
                                 rows, row_bytes, n, entries, &tiles,
                                 &blocks);
  if (refused != 0) return refused;
  if (tiles.count == 0) return 0;
  ring_shift_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(tiles);
  return static_cast<int>(cudaGetLastError());
}

// One launch of hop `epoch` across processes (see the note at the top):
// the table as rnb_ring_shift's with n = 1 and shifts 0 (this member's
// tiles, at most kMaxHopTiles), its first `remote` entries landing in the
// successor's arena (each non-empty; their dsts and dst pitches are this
// member's own posts: where it receives the same entry, as a place
// segment << 40 | offset, and that destination's pitch), the rest within
// the member. `succ` is the successor's counter allocation as mapped here,
// `segments` / `segment_bytes` its `count` arena segments as mapped here,
// `own` this member's counter allocation, `report` pinned host memory a
// set error word is copied into (none where null). With `succ` null the
// launch is local: no post, no wait, no signal, and it moves nothing once
// the error word is set. A table with no tiles still launches one block,
// which posts, waits and signals. Refused as rnb_ring_shift, and with n
// other than 1, no counter allocation, a negative cap, `remote` outside
// 0..entries (or above 0 in a local launch), an empty remote entry, a
// segment count outside 0..kMaxSegments, a segment of 2^40 bytes or more,
// or a hop of epoch 0.
int rnb_ring_hop(const void* const* srcs, void* const* dsts,
                 const long long* src_pitch, const long long* dst_pitch,
                 const int* shifts, const long long* rows,
                 const long long* row_bytes, int n, int entries, int remote,
                 const void* succ, void* const* segments,
                 const long long* segment_bytes, int count, void* own,
                 unsigned long long epoch, void* report, long long cap_ns,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n != 1 || own == nullptr || cap_ns < 0 || remote < 0 ||
      remote > entries || (succ == nullptr && remote > 0) || count < 0 ||
      count > kMaxSegments || (succ != nullptr && epoch == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HopSync sync = {};
  for (int s = 0; s < count; ++s) {
    if (segment_bytes[s] < 0 || segment_bytes[s] > kOffsetMask) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    sync.segment[s] = static_cast<uint8_t*>(segments[s]);
    sync.segment_bytes[s] = segment_bytes[s];
  }
  for (int e = 0; e < remote; ++e) {
    if (rows[e] <= 0 || row_bytes[e] <= 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  HopTiles tiles = {};
  long long blocks = 0;
  const int refused = fill_tiles(srcs, dsts, src_pitch, dst_pitch, shifts,
                                 rows, row_bytes, n, entries, &tiles,
                                 &blocks);
  if (refused != 0) return refused;
  sync.succ = static_cast<const uint8_t*>(succ);
  sync.own = static_cast<uint8_t*>(own);
  sync.report = static_cast<int*>(report);
  sync.epoch = epoch;
  sync.cap_ns = static_cast<unsigned long long>(cap_ns);
  sync.remote = remote;
  sync.segments = count;
  if (succ == nullptr && tiles.count == 0) return 0;
  ring_hop_kernel<<<static_cast<unsigned>(succ != nullptr ? blocks + 1
                                                          : blocks),
                    kThreads, 0, static_cast<cudaStream_t>(stream)>>>(tiles,
                                                                      sync);
  return static_cast<int>(cudaGetLastError());
}

// -- the peers' memory (rnb_tpu_torch/parallel/peers.py) -------------------

// `bytes` of device memory on `device`, zeroed, the base of its own
// allocation (so its IPC handle opens at offset 0).
int rnb_peer_alloc(long long bytes, int device, void** out) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(out, static_cast<size_t>(bytes));
  if (err == cudaSuccess) {
    err = cudaMemset(*out, 0, static_cast<size_t>(bytes));
  }
  return static_cast<int>(err);
}

int rnb_peer_free(void* ptr, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFree(ptr);
  return static_cast<int>(err);
}

int rnb_peer_handle_bytes() { return sizeof(cudaIpcMemHandle_t); }

// The IPC handle of an allocation, written into `handle`
// (rnb_peer_handle_bytes() bytes).
int rnb_peer_export(void* ptr, int device, void* handle) {
  cudaError_t err = cudaSetDevice(device);
  cudaIpcMemHandle_t h;
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&h, ptr);
  if (err == cudaSuccess) memcpy(handle, &h, sizeof h);
  return static_cast<int>(err);
}

// A peer's allocation mapped into this process, peer access enabled
// lazily where it lies on another card.
int rnb_peer_open(const void* handle, int device, void** out) {
  cudaError_t err = cudaSetDevice(device);
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  if (err == cudaSuccess) {
    err = cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
  }
  return static_cast<int>(err);
}

int rnb_peer_close(void* ptr, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(ptr);
  return static_cast<int>(err);
}

// A zeroed report word in pinned host memory that the card writes and the
// host reads with no copy: its host address in *host, the card's in *dev.
int rnb_error_word_alloc(void** host, void** dev) {
  cudaError_t err = cudaHostAlloc(host, 64,
                                  cudaHostAllocMapped | cudaHostAllocPortable);
  if (err == cudaSuccess) {
    memset(*host, 0, 64);
    err = cudaHostGetDevicePointer(dev, *host, 0);
  }
  return static_cast<int>(err);
}

int rnb_error_word_free(void* host) {
  return static_cast<int>(cudaFreeHost(host));
}

}  // extern "C"
