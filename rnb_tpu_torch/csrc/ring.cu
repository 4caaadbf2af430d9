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
//   one member a process, each with its own CUDA context. Each member owns
//   a receive window and two counters, `recv` and `ack`, allocated here
//   with cudaMalloc (each the base of its own allocation) and opened by
//   its peers through CUDA IPC with the lazy peer-access flag
//   (rnb_tpu_torch/parallel/peers.py): on one card the peers' stores land
//   in the same HBM, across cards they travel over NVLink with no change
//   here. A hop of epoch e is two launches on each member's stream:
//     send:  wait until the successor's `ack` reaches e - 1 (it has placed
//            the last hop out of its window, so the window is free), move
//            this member's tiles into the successor's window (and its
//            shift-0 tiles into its own slots), then the launch's last
//            block writes the hop's layout (a digest of the window's
//            tiles) beside the successor's `recv` and adds one to `recv`;
//     place: wait until its own `recv` reaches e, check that the layout
//            beside it is the one its own table reads, move the window
//            into the destinations, then the last block adds one to its
//            own `ack`.
//   The sender never writes past its successor's window: the wrapper
//   knows each peer's window size and refuses a hop that needs more. A
//   pair of processes whose tables disagree (other shapes) so fails the
//   hop on the card instead of placing the wrong bytes.
//   Ordering follows the CUDA memory model: every thread of a block stores
//   its bytes, the block meets, its first thread fences (__threadfence)
//   and counts the block into a device word of finished blocks; the block
//   that finds itself last has seen every block's count, fences at system
//   scope (__threadfence_system; causality is transitive across the two
//   scopes), resets the word for the next launch and signals with a
//   release add at system scope (red.release.sys). A system fence in every
//   block cost the conv5 hop's two launches 0.0137 ms against 0.0094. A
//   waiting block's first thread spins on an
//   acquire load at system scope (ld.acquire.sys), then the block meets,
//   so no thread reads the window before the count is seen. Every wait is
//   bounded: past `cap_ns` of the global timer, or when another wait of
//   the same member already gave up, the thread writes the member's error
//   word (device memory), its block moves nothing, and the last block
//   signals nothing, so the peer's wait gives up in turn; the last block
//   copies a set word into pinned host memory, which the wrapper reads
//   after the collective with no copy, and raises: a dead peer fails the
//   run, it never hangs it. (Every block reading the pinned word would
//   cross PCIe each time: the conv5 hop's two launches took 0.26 ms so,
//   against 0.0095.)
//   The route is device counters rather than IPC events: an event wait
//   (cudaStreamWaitEvent on an interprocess event) cannot be bounded, and
//   it needs the sender's host to record the event after its launch,
//   where the counter is set by the kernel itself.
//
//   Two contexts on one card time-slice (no MPS): a waiting kernel holds
//   its context's slice until the scheduler switches, so a hop between two
//   processes on one card costs about a slice on top of its copy (PERF.md
//   section 7).
//
//   Measured (chip_smoke.py's process phase, two processes on an NVIDIA
//   H100 80GB HBM3 at 700 W; ptxas: 38 registers, 0 bytes of stack frame):
//   the conv5 temporal hop's send and place launches alone, no waiting,
//   about 0.0095 ms for 1,769,472 B (the bound, the shard read and written
//   once, 0.00106 ms; the hop moves it twice, through the window), where
//   Tensor.copy_ into the peer's window takes 0.0014; with its semaphores
//   0.3 ms when the peer's send is already queued, about 2.7 ms when the
//   card must switch contexts first.
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

// The synchronisation of a hop: null pointers (the one-process form) make
// the kernel a plain move.
struct RingSync {
  // a counter (this member's or a peer's) to reach before moving, or null
  const unsigned long long* wait;
  unsigned long long wait_for;
  // a counter (this member's or a peer's) that the launch's last block
  // adds one to, or null
  unsigned long long* signal;
  // blocks of this launch that have finished (this member's own word)
  unsigned int* done;
  // the member's error word (device memory): non-zero once a wait gave up
  int* error;
  // pinned host memory the last block copies a set error word into, or
  // null
  int* report;
  unsigned long long cap_ns;
  // the hop's layout (a digest of its window's tiles, never 0): a sending
  // launch's last block writes it to *layout_out (the successor's word)
  // before it signals, and a waiting launch gives up unless *layout_in
  // (its own word) holds it once the wait is over; either may be null
  unsigned long long layout;
  unsigned long long* layout_out;
  const unsigned long long* layout_in;
};

// the error word's value after a wait timed out
constexpr int kTimedOut = 1;
// the error word's value where the predecessor's window holds another
// layout than this member's table reads (the processes' tables disagree)
constexpr int kLayoutDiffers = 2;

// The system-scope primitives of a hop (the host emulation runs them on
// std::atomic_ref).
#ifdef RNB_HOST_EMULATION
__device__ __forceinline__ unsigned long long load_acquire_sys(
    const unsigned long long* p) {
  return std::atomic_ref<const unsigned long long>(*p).load(
      std::memory_order_acquire);
}
__device__ __forceinline__ void add_release_sys(unsigned long long* p) {
  std::atomic_ref<unsigned long long>(*p).fetch_add(
      1, std::memory_order_release);
}
__device__ __forceinline__ void fence_sys() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
__device__ __forceinline__ void fence_gpu() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
__device__ __forceinline__ unsigned add_done(unsigned* p) {
  return std::atomic_ref<unsigned>(*p).fetch_add(1,
                                                 std::memory_order_acq_rel);
}
__device__ __forceinline__ int load_error(const int* p) {
  return std::atomic_ref<const int>(*p).load(std::memory_order_relaxed);
}
__device__ __forceinline__ void store_error(int* p, int v) {
  std::atomic_ref<int>(*p).store(v, std::memory_order_relaxed);
}
__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  return std::atomic_ref<const unsigned long long>(*p).load(
      std::memory_order_relaxed);
}
__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  std::atomic_ref<unsigned long long>(*p).store(v,
                                                std::memory_order_relaxed);
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
__device__ __forceinline__ void add_release_sys(unsigned long long* p) {
  asm volatile("red.release.sys.global.add.u64 [%0], 1;"
               :
               : "l"(p)
               : "memory");
}
__device__ __forceinline__ void fence_sys() { __threadfence_system(); }
__device__ __forceinline__ void fence_gpu() { __threadfence(); }
__device__ __forceinline__ unsigned add_done(unsigned* p) {
  return atomicAdd(p, 1u);
}
__device__ __forceinline__ int load_error(const int* p) {
  return *static_cast<const volatile int*>(p);
}
__device__ __forceinline__ void store_error(int* p, int v) {
  *static_cast<volatile int*>(p) = v;
}
__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  return *static_cast<const volatile unsigned long long*>(p);
}
__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  *static_cast<volatile unsigned long long*>(p) = v;
}
__device__ __forceinline__ unsigned long long clock_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void pause() { __nanosleep(64); }
#endif

// The first thread of a block: wait for *sync.wait to reach
// sync.wait_for. False where the wait gave up (past the cap, or the
// member's error word already set), with the error word written.
__device__ __noinline__ bool wait_counter(const RingSync& sync) {
  const unsigned long long start = clock_ns();
  unsigned spins = 0;
  while (load_acquire_sys(sync.wait) < sync.wait_for) {
    if ((++spins & 31u) == 0) {
      if (load_error(sync.error) != 0) return false;
      if (clock_ns() - start > sync.cap_ns) {
        store_error(sync.error, kTimedOut);
        return false;
      }
    }
    pause();
  }
  if (sync.layout_in != nullptr && load_word(sync.layout_in) != sync.layout) {
    store_error(sync.error, kLayoutDiffers);
    return false;
  }
  return load_error(sync.error) == 0;
}

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

// The hop: wait, move, and the last block signals. A grid of one block
// with no tiles only waits and signals.
__global__ void __launch_bounds__(kThreads)
ring_hop_kernel(const __grid_constant__ RingTiles tiles,
                const __grid_constant__ RingSync sync) {
  __shared__ int go;
  const int block = static_cast<int>(blockIdx.x);
  if (threadIdx.x == 0) {
    go = sync.wait == nullptr ? load_error(sync.error) == 0
                              : wait_counter(sync);
  }
  __syncthreads();
  if (go && block < tiles.first_block[tiles.count]) {
    move_block(tiles, block);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    fence_gpu();
    if (add_done(sync.done) == gridDim.x - 1) {
      // every block's stores are fenced and counted: publish the hop
      fence_sys();
      *sync.done = 0;
      const int error = load_error(sync.error);
      if (error != 0 && sync.report != nullptr) {
        store_error(sync.report, error);
      } else if (error == 0 && sync.signal != nullptr) {
        if (sync.layout_out != nullptr) store_word(sync.layout_out,
                                                   sync.layout);
        add_release_sys(sync.signal);
      }
    }
  }
}

// Resolve a table of `entries` entries of a ring of n members into tiles
// and a grid (see rnb_ring_shift); 0, or the CUDA error code of what it
// refuses.
int fill_tiles(const void* const* srcs, void* const* dsts,
               const long long* src_pitch, const long long* dst_pitch,
               const int* shifts, const long long* rows,
               const long long* row_bytes, int n, int entries,
               RingTiles* tiles, long long* grid) {
  if (n < 1 || n > kMaxMembers || entries < 0 ||
      static_cast<long long>(entries) * n > kMaxTiles) {
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

// One launch of a hop across processes: the table as rnb_ring_shift's
// (the wrapper passes this member's tiles, n = 1, shifts 0; a destination
// may be a peer's window), every block first waiting for *wait to reach
// wait_for (no wait where `wait` is null), the last block then adding one
// to *signal (none where null). `done` is this member's word of finished
// blocks (0 between launches), `error` its error word in device memory (a
// wait that gives up after cap_ns writes it), `report` pinned host memory
// the last block copies a set error word into (none where null). Where
// `layout_out` is set, the last block writes `layout` there before it
// signals; where `layout_in` is set, a block whose wait is over moves
// nothing unless *layout_in holds `layout` (it writes the error word). A
// table with no tiles still launches one block, which waits and signals.
// Refused as rnb_ring_shift, without `done` or `error`, and with a layout
// word but a layout of 0.
int rnb_ring_hop(const void* const* srcs, void* const* dsts,
                 const long long* src_pitch, const long long* dst_pitch,
                 const int* shifts, const long long* rows,
                 const long long* row_bytes, int n, int entries,
                 const void* wait, unsigned long long wait_for, void* signal,
                 void* done, void* error, void* report, long long cap_ns,
                 unsigned long long layout, void* layout_out,
                 const void* layout_in, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (done == nullptr || error == nullptr || cap_ns < 0 ||
      (layout == 0 && (layout_out != nullptr || layout_in != nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingTiles tiles = {};
  long long blocks = 0;
  const int refused = fill_tiles(srcs, dsts, src_pitch, dst_pitch, shifts,
                                 rows, row_bytes, n, entries, &tiles,
                                 &blocks);
  if (refused != 0) return refused;
  RingSync sync;
  sync.wait = static_cast<const unsigned long long*>(wait);
  sync.wait_for = wait_for;
  sync.signal = static_cast<unsigned long long*>(signal);
  sync.done = static_cast<unsigned int*>(done);
  sync.error = static_cast<int*>(error);
  sync.report = static_cast<int*>(report);
  sync.cap_ns = static_cast<unsigned long long>(cap_ns);
  sync.layout = layout;
  sync.layout_out = static_cast<unsigned long long*>(layout_out);
  sync.layout_in = static_cast<const unsigned long long*>(layout_in);
  ring_hop_kernel<<<static_cast<unsigned>(blocks > 0 ? blocks : 1), kThreads,
                    0, static_cast<cudaStream_t>(stream)>>>(tiles, sync);
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
