"""Ring collectives: the ring-shift hop and the collectives built on it.

PyTorch counterpart of ``rnb_tpu/ops/handoff_dma.py``. The port has no
``shard_map``: a sharded value is a list of ``n`` per-member tensors in
ring order (member ``i`` hands its buffer to member ``i + 1``), lying
on the members of a :class:`rnb_tpu_torch.parallel.mesh.Ring`.

* :func:`ring_shift` — the hop: ``out[(i + shift) % n] = shards[i]``,
  every member's whole buffer moved byte for byte. On CUDA tensors it
  launches the hand-written kernel (``csrc/ring.cu``,
  ``rnb_ring_shift``), one launch for all members; on CPU tensors it
  runs the plain version :func:`ring_shift_reference`, a list rotation
  with ``clone()``. There is no fallback from one to the other.
* :func:`ring_all_gather` / :func:`ring_psum_scatter` — the intra-stage
  sharding collectives (rnb_tpu_torch.parallel.shardplan), each ``n - 1``
  one-step hops of :func:`ring_shift` composed with local placement
  (gather) or local adds (reduce-scatter), as the reference composes its
  one hop primitive. The all-gather moves data only, so every member's
  result is bitwise the concatenation of the shards; the reduce-scatter
  adds in the reference's ring order, chunk for chunk.

Placing a hop's buffer at its offset in the full-width result is the
reference's ``dynamic_update_slice``, an op outside the Pallas body; here
it is a slice copy. ``reshard``, ``ring_shift_amount`` and
``dma_available`` belong to the inter-stage handoff and wait for it.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Sequence

import torch

from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.parallel.mesh import MAX_MEMBERS

Members = List[torch.Tensor]


def ring_shift_reference(shards: Sequence[torch.Tensor],
                         shift: int = 1) -> Members:
    """The plain version: the list rotated by ``shift``, every buffer
    copied (the reference's ``lax.ppermute`` twin)."""
    n = len(shards)
    out: list = [None] * n
    for i, shard in enumerate(shards):
        out[(i + shift) % n] = shard.clone()
    return out


def _is_block(t: torch.Tensor) -> bool:
    """Do ``t``'s elements fill one gap-free block of memory starting at
    its data pointer (contiguous in some order of its dims)?"""
    expected = 1
    for d in sorted((d for d in range(t.dim()) if t.shape[d] != 1),
                    key=t.stride):
        if t.stride(d) != expected:
            return False
        expected *= t.shape[d]
    return True


def _check_members(shards: Sequence[torch.Tensor]) -> None:
    first = shards[0]
    if first.device.type != "cuda":
        raise ValueError("ring_shift runs its kernel on cuda tensors, got "
                         "%s" % first.device)
    for i, t in enumerate(shards):
        if t.device != first.device:
            raise ValueError("ring_shift moves buffers within one card: "
                             "member 0 on %s, member %d on %s"
                             % (first.device, i, t.device))
        if t.dtype != first.dtype or t.shape != first.shape:
            raise ValueError("ring_shift needs every member's buffer of "
                             "one dtype and shape: member 0 %s %s, member "
                             "%d %s %s" % (first.dtype, tuple(first.shape),
                                           i, t.dtype, tuple(t.shape)))
        if not _is_block(t):
            raise ValueError("ring_shift moves whole buffers: member %d's "
                             "tensor is not one dense block (strides %s)"
                             % (i, t.stride()))


def ring_shift(shards: Sequence[torch.Tensor], shift: int = 1) -> Members:
    """Move every member's buffer to the member ``shift`` places along
    the ring: ``out[(i + shift) % n] = shards[i]`` (value-wise the
    reference's ``jnp.roll`` by ``shift`` shards). A shift of 0 returns
    the members as they are, as the reference does. On CUDA tensors,
    one launch of ``rnb_ring_shift`` on the current stream into new
    buffers of the members' layout; on CPU tensors, the plain
    version."""
    shards = list(shards)
    n = len(shards)
    if not 1 <= n <= MAX_MEMBERS:
        raise ValueError("ring_shift takes 1 to %d members, got %d"
                         % (MAX_MEMBERS, n))
    shift = int(shift) % n
    if shift == 0:
        return shards
    if all(t.device.type == "cpu" for t in shards):
        return ring_shift_reference(shards, shift)
    _check_members(shards)
    out: list = [None] * n
    for i, shard in enumerate(shards):
        # the source's strides: a dense block maps byte for byte
        out[(i + shift) % n] = torch.empty_like(shard)
    nbytes = shards[0].numel() * shards[0].element_size()
    if nbytes:
        srcs = (ctypes.c_void_p * n)(*(t.data_ptr() for t in shards))
        # member i's destination is out[(i + shift) % n]: the kernel
        # takes the destinations in member order and applies the shift
        dsts = (ctypes.c_void_p * n)(*(t.data_ptr() for t in out))
        _kernels.RING_SHIFT.launch(srcs, dsts, n, shift, nbytes,
                                   device=shards[0].device)
    return out


def _one_step_shift_body(n: int) -> Callable[[Members], Members]:
    """The shared ring primitive both collectives below ride: move every
    member's buffer to its +1 neighbour."""
    def shift(shards: Members) -> Members:
        if len(shards) != n:
            raise ValueError("a ring of %d members got %d buffers"
                             % (n, len(shards)))
        return ring_shift(shards, 1)
    return shift


def _full_width(shard: torch.Tensor, n: int, ax: int) -> torch.Tensor:
    """An empty tensor ``n`` times ``shard``'s extent along ``ax``, in
    its memory format (a channels-last conv kernel stays channels-last,
    so the gathered weight is laid out as the unsharded one)."""
    shape = list(shard.shape)
    shape[ax] *= n
    fmt = torch.contiguous_format
    if not shard.is_contiguous():
        for dims, channels_last in ((5, torch.channels_last_3d),
                                    (4, torch.channels_last)):
            if shard.dim() == dims and shard.is_contiguous(
                    memory_format=channels_last):
                fmt = channels_last
    return torch.empty(shape, dtype=shard.dtype, device=shard.device,
                       memory_format=fmt)


def ring_all_gather_body(n: int, axis: int = -1
                         ) -> Callable[[Members], Members]:
    """Per-member shards along ``axis`` -> each member's full
    concatenation, assembled by ``n - 1`` one-step hops. Pure movement:
    each global chunk lands at ``chunk_index * chunk`` exactly once, so
    every member's result is bitwise the unsharded tensor."""
    shift = _one_step_shift_body(n)

    def body(shards: Members) -> Members:
        shards = list(shards)
        if len(shards) != n:
            raise ValueError("a ring of %d members got %d shards"
                             % (n, len(shards)))
        if n == 1:
            return shards
        ax = axis % shards[0].dim()
        chunk = shards[0].shape[ax]
        out = []
        for idx, shard in enumerate(shards):
            full = _full_width(shard, n, ax)
            full.narrow(ax, idx * chunk, chunk).copy_(shard)
            out.append(full)
        buf = shards
        for s in range(1, n):
            buf = shift(buf)
            for idx in range(n):
                # after s hops member idx holds the shard that started on
                # member (idx - s) mod n: place it at that chunk's offset
                src = (idx - s) % n
                out[idx].narrow(ax, src * chunk, chunk).copy_(buf[idx])
        return out

    return body


def ring_psum_scatter_body(n: int, axis: int = -1
                           ) -> Callable[[Members], Members]:
    """Per-member full-width operands -> member ``j`` holds chunk ``j``
    of their elementwise sum along ``axis`` (``lax.psum_scatter``), as
    ``n - 1`` one-step hops each followed by one local chunk add, in the
    reference's ring order: chunk ``c`` is seeded on member ``c + 1`` and
    adds the members' pieces around the ring, member ``c``'s last."""
    shift = _one_step_shift_body(n)

    def body(operands: Members) -> Members:
        operands = list(operands)
        if len(operands) != n:
            raise ValueError("a ring of %d members got %d operands"
                             % (n, len(operands)))
        ax = axis % operands[0].dim()
        width = operands[0].shape[ax]
        if width % n:
            raise ValueError(
                "ring_psum_scatter: axis %d extent %d not divisible by %d "
                "ring members" % (ax, width, n))
        if n == 1:
            return operands
        chunk = width // n

        def piece(member: int, m: int) -> torch.Tensor:
            return operands[member].narrow(ax, m * chunk, chunk)

        acc = [piece(j, (j - 1) % n).contiguous() for j in range(n)]
        for s in range(1, n):
            acc = shift(acc)
            acc = [acc[j] + piece(j, (j - 1 - s) % n) for j in range(n)]
        return acc

    return body


def ring_all_gather(shards: Sequence[torch.Tensor], ring=None,
                    axis: int = -1) -> Members:
    """Standalone entry: the members' shards along ``axis`` -> the full
    tensor on every member (bitwise the unsharded tensor). With ``ring``
    the shards are checked against its members."""
    shards = list(shards)
    if ring is not None:
        ring.check(shards, "ring_all_gather")
    return ring_all_gather_body(len(shards), axis)(shards)


def ring_psum_scatter(operands: Sequence[torch.Tensor], ring=None,
                      axis: int = -1) -> Members:
    """Standalone entry: one full-width operand a member -> member ``i``
    holds chunk ``i`` of their sum along ``axis``; the chunks in member
    order concatenate to the full sum. With ``ring`` the operands are
    checked against its members."""
    operands = list(operands)
    if ring is not None:
        ring.check(operands, "ring_psum_scatter")
    return ring_psum_scatter_body(len(operands), axis)(operands)

