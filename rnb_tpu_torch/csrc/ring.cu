// Ring-shift kernel of the shard ring collectives, hand-written for Hopper
// (sm_90a). Built by rnb_tpu_torch/ops/_kernels.py with nvcc into a shared
// library with a plain C interface, bound with ctypes.
//
// rnb_ring_shift -- port of the Pallas kernel `_pallas_shift_body`
//   (rnb_tpu/ops/handoff_dma.py:104-140, pallas_call at :134): every ring
//   member's whole buffer goes to the member `shift` places along the
//   ring, dst[(i + shift) % n] <- src[i] for i < n, byte for byte, so it
//   is exact for any dtype. It is the one hop under every ring collective
//   of rnb_tpu_torch/ops/handoff_dma.py: the weight all-gathers of a
//   sharded stage's forward and the head's merge gather.
//   The TPU kernel DMAs each core's shard into its neighbour's HBM over
//   ICI. Here the ring's members share one card (a shard ring over
//   several cards raises in rnb_tpu_torch/parallel/mesh.py), so a hop is
//   a copy inside the card's memory; the cross-card form, with peer
//   pointers written over NVLink, is the multi-card slice's work.
//   Bound: memory. A hop reads and writes every byte it moves: at degree
//   2 the conv5 temporal kernel's two shards move 2 x 3,538,944 B, about
//   2.1 us at 3.35 TB/s; most leaves and the merge blocks (12,000 B a
//   member at 15 rows) are far smaller, so their launch bounds them.
//   Design: one launch a hop, over all members. The n source and n
//   destination pointers travel by value in the kernel's parameters (a
//   struct of 8 + 8 pointers), so a launch needs no pointer table in
//   device memory and captures into a CUDA graph as it stands. The grid
//   is (blocks, members); each thread holds kVectors 16-byte vectors in
//   registers before it stores any of them, so its loads are in flight
//   together, and strides over the member's buffer. A byte loop covers
//   the tail, and a buffer whose source or destination is not 16-byte
//   aligned goes through the byte loop whole.
//   What held the first version back (chip_smoke.py's ring phase on an
//   NVIDIA H100 80GB HBM3 at 700 W, conv5 leaf at degree 2: 0.00423 ms
//   with L2 warm, 0.00701 flushed, slower than two plain copies): it
//   indexed the pointer struct by the member at run time, so ptxas gave
//   every thread a 128-byte stack frame and each thread copied the struct
//   there first, 7 MB of local stores beside the 7 MB the hop moves. The
//   pointers are now picked with constant indices (no stack frame):
//   0.00252 ms warm, 0.00472 flushed, 84% / 45% of the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxMembers = 8;
constexpr int kThreads = 256;
// 16-byte vectors a thread holds in registers at once
constexpr int kVectors = 4;
// blocks a member at most: enough to fill the card at any degree
constexpr long long kMaxBlocks = 1024;

struct RingBuffers {
  const uint8_t* src[kMaxMembers];
  uint8_t* dst[kMaxMembers];
};

__global__ void __launch_bounds__(kThreads)
ring_shift_kernel(RingBuffers ring, int n, int shift, long long bytes) {
  const int member = blockIdx.y;
  const int target = (member + shift) % n;
  // the member's pointers picked with constant indices: a run-time index
  // into the parameter struct makes every thread copy the struct to its
  // stack first (128 bytes a thread, 7 MB at the conv5 leaf)
  const uint8_t* from = ring.src[0];
  uint8_t* to = ring.dst[0];
#pragma unroll
  for (int i = 1; i < kMaxMembers; ++i) {
    if (i == member) from = ring.src[i];
    if (i == target) to = ring.dst[i];
  }
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long tail = 0;
  if (((reinterpret_cast<uintptr_t>(from) | reinterpret_cast<uintptr_t>(to))
       & 15u) == 0) {
    const long long vectors = bytes / 16;
    const uint4* __restrict__ f = reinterpret_cast<const uint4*>(from);
    uint4* __restrict__ t = reinterpret_cast<uint4*>(to);
    const long long begin =
        static_cast<long long>(blockIdx.x) * kThreads * kVectors + threadIdx.x;
    for (long long base = begin; base < vectors; base += threads * kVectors) {
      // every load of the step in flight before its first store
      uint4 held[kVectors];
#pragma unroll
      for (int k = 0; k < kVectors; ++k) {
        const long long v = base + static_cast<long long>(k) * kThreads;
        if (v < vectors) held[k] = f[v];
      }
#pragma unroll
      for (int k = 0; k < kVectors; ++k) {
        const long long v = base + static_cast<long long>(k) * kThreads;
        if (v < vectors) t[v] = held[k];
      }
    }
    tail = vectors * 16;
  }
  for (long long b = tail + first; b < bytes; b += threads) {
    to[b] = from[b];
  }
}

}  // namespace

extern "C" {

const char* rnb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// srcs, dsts: host arrays of n device pointers, each buffer `bytes` long
// (all on one card; checked by the Python wrapper). 1 <= n <= 8 and
// 0 <= shift < n. Reads the arrays before it returns: nothing of them is
// kept.
int rnb_ring_shift(const void* const* srcs, void* const* dsts, int n,
                   int shift, long long bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || n > kMaxMembers || shift < 0 || shift >= n || bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bytes == 0) return 0;
  RingBuffers ring = {};
  for (int i = 0; i < n; ++i) {
    ring.src[i] = static_cast<const uint8_t*>(srcs[i]);
    ring.dst[i] = static_cast<uint8_t*>(dsts[i]);
  }
  const long long per_block = static_cast<long long>(kThreads) * kVectors * 16;
  long long blocks = (bytes + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
  ring_shift_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(ring, n, shift,
                                                           bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
