"""Ring collectives: the ring-shift hop and the collectives built on it.

PyTorch counterpart of ``rnb_tpu/ops/handoff_dma.py``. The port has no
``shard_map``: a sharded value is a list of ``n`` per-member tensors in
ring order (member ``i`` hands its buffer to member ``i + 1``), lying
on the members of a :class:`rnb_tpu_torch.parallel.mesh.Ring`.

* :func:`ring_shift_group` -- the grouped hop: a table of
  :class:`RingEntry`, each one buffer of every member, member ``i``'s
  source written into the destination of member ``(i + shift) % n``
  byte for byte, each entry with its own shift (0 places a member's own
  buffer). Destinations may be slots of larger tensors: a dim-0 slice,
  or a column block of a row-major matrix (rows at a pitch). On CUDA
  tensors it launches the hand-written kernel (``csrc/ring.cu``,
  ``rnb_ring_shift``), one launch for the whole table, or as few as hold
  it (:data:`RING_MAX_TILES`); on CPU tensors it runs the plain version
  :func:`ring_shift_group_reference`, a ``copy_`` per entry and member.
  There is no fallback from one to the other.
* :func:`ring_shift` -- one buffer a member into new buffers:
  ``out[(i + shift) % n] = shards[i]``, a table of one entry.
* :func:`ring_all_gather_many` / :func:`ring_all_gather` /
  :func:`ring_psum_scatter` -- the intra-stage sharding collectives
  (rnb_tpu_torch.parallel.shardplan). The all-gather allocates each
  member's full-width tensor and writes every shard straight into its
  slot there (:func:`ring_gather_tables`): its first table places each
  member's own shard and hands it to the next member, and hop ``s >= 2``
  hands on the slot that hop ``s - 1`` filled, as the reference hands
  each hop's buffer on, so ``n - 1`` grouped hops gather any number of
  leaves. It moves data only, so
  every member's result is bitwise the concatenation of the shards. The
  reduce-scatter is ``n - 1`` one-step hops of :func:`ring_shift`, each
  followed by a local add, in the reference's ring order, chunk for
  chunk.

The reference places each hop's buffer with ``dynamic_update_slice``, an
op outside the Pallas body; here the hop writes the slot itself.

The inter-stage handoff's half (``rnb_tpu_torch.handoff``):

* :func:`reshard` -- the one entry the edge calls: a tensor re-homed on a
  device or a :class:`rnb_tpu_torch.parallel.mesh.NamedSharding`,
  adopted where it already lies, else one device-to-device copy, never
  through the host. The reference's ring route (a pure ring shift of a
  one-axis sharding, one neighbour DMA a core) moves shards between
  distinct cards, which no port mesh spans yet, so it raises "not yet
  ported" (ROADMAP.md, queue 1 item 5).
* :func:`ring_shift_amount` -- the pattern detector, the reference's
  rule: the shift ``k`` that maps one sharding's member ring onto the
  other's, or ``None``.
* :func:`dma_available` -- the gate of the ring route.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.parallel.mesh import MAX_MEMBERS, NamedSharding

Members = List[torch.Tensor]

#: (entry, member) pairs one launch of ``rnb_ring_shift`` moves at most
#: (``kMaxTiles`` in csrc/ring.cu: the table rides in the kernel's 4 KB of
#: parameters); a larger table takes as few launches as hold it
RING_MAX_TILES = 80


class RingEntry(NamedTuple):
    """One buffer of every ring member: member ``i``'s ``srcs[i]`` is
    written into ``dsts[(i + shift) % n]``. All of one dtype and shape."""
    srcs: Sequence[torch.Tensor]
    dsts: Sequence[torch.Tensor]
    shift: int


def ring_shift_reference(shards: Sequence[torch.Tensor],
                         shift: int = 1) -> Members:
    """The plain version of :func:`ring_shift`: the list rotated by
    ``shift``, every buffer copied (the reference's ``lax.ppermute``
    twin)."""
    n = len(shards)
    out: list = [None] * n
    for i, shard in enumerate(shards):
        out[(i + shift) % n] = shard.clone()
    return out


def _check_table(table: Sequence[RingEntry]) -> int:
    """The ring's degree, after checking every entry: one buffer a
    member on both sides, a shift in ``0..n-1``, one dtype and shape."""
    n = len(table[0].srcs)
    if not 1 <= n <= MAX_MEMBERS:
        raise ValueError("ring_shift takes 1 to %d members, got %d"
                         % (MAX_MEMBERS, n))
    for e, entry in enumerate(table):
        if len(entry.srcs) != n or len(entry.dsts) != n:
            raise ValueError("ring_shift entry %d: %d sources and %d "
                             "destinations for a ring of %d members"
                             % (e, len(entry.srcs), len(entry.dsts), n))
        if not 0 <= entry.shift < n:
            raise ValueError("ring_shift entry %d: shift %d outside 0..%d"
                             % (e, entry.shift, n - 1))
        first = entry.srcs[0]
        for i, t in enumerate(list(entry.srcs) + list(entry.dsts)):
            if t.dtype != first.dtype or t.shape != first.shape:
                raise ValueError(
                    "ring_shift needs every buffer of an entry of one dtype "
                    "and shape: entry %d member 0 %s %s, buffer %d %s %s"
                    % (e, first.dtype, tuple(first.shape), i, t.dtype,
                       tuple(t.shape)))
    return n


def ring_shift_group_reference(table: Sequence[RingEntry]) -> None:
    """The plain version of :func:`ring_shift_group`: for each entry and
    member, ``dsts[(i + shift) % n].copy_(srcs[i])``; data movement, as
    the kernel's, so outside autograd."""
    table = list(table)
    if not table:
        return
    n = _check_table(table)
    with torch.no_grad():
        for entry in table:
            for i, src in enumerate(entry.srcs):
                entry.dsts[(i + entry.shift) % n].copy_(src)


def _is_block(shape: Sequence[int], stride: Sequence[int]) -> bool:
    """Do a tensor's elements fill one gap-free block of memory starting
    at its data pointer (contiguous in some order of its dims)?"""
    expected = 1
    for d in sorted((d for d in range(len(shape)) if shape[d] != 1),
                    key=stride.__getitem__):
        if stride[d] != expected:
            return False
        expected *= shape[d]
    return True


def _row_pitch(shape: Sequence[int], stride: Sequence[int]
               ) -> Optional[int]:
    """Elements from one row to the next where a tensor is rows of its
    last dim, each row dense and the rows at one pitch (a column block
    of a row-major matrix); else None."""
    if not shape or (shape[-1] != 1 and stride[-1] != 1):
        return None
    lead = [d for d in range(len(shape) - 1) if shape[d] != 1]
    if not lead:
        return shape[-1]
    for outer, inner in zip(lead, lead[1:]):
        if stride[outer] != stride[inner] * shape[inner]:
            return None
    pitch = stride[lead[-1]]
    return pitch if pitch >= shape[-1] else None


@functools.lru_cache(maxsize=256)
def _layout_of(shape: torch.Size, size: int, n: int,
               strides: Tuple[Tuple[int, ...], ...]):
    """(rows, row_bytes, source pitches, destination pitches) in bytes
    of an entry's ``2 n`` buffers of one ``shape`` and element ``size``
    (sources first): one row where every buffer is one dense block laid
    out alike, else rows of the last dim at each buffer's pitch. The
    index of the first buffer that is neither, in place of the tuple."""
    if all(_is_block(shape, stride) for stride in strides) and len({
            tuple(st for st, extent in zip(stride, shape) if extent != 1)
            for stride in strides}) == 1:
        nbytes = math.prod(shape) * size
        return 1, nbytes, (nbytes,) * n, (nbytes,) * n
    pitches = []
    for i, stride in enumerate(strides):
        pitch = _row_pitch(shape, stride)
        if pitch is None:
            return i
        pitches.append(pitch * size)
    return (math.prod(shape[:-1]), shape[-1] * size, tuple(pitches[:n]),
            tuple(pitches[n:]))


def _layout(entry: RingEntry, e: int) -> tuple:
    """:func:`_layout_of` the entry's buffers, or raise where one is
    neither a dense block laid out as the others nor rows at a pitch."""
    tensors = list(entry.srcs) + list(entry.dsts)
    first = tensors[0]
    layout = _layout_of(first.shape, first.element_size(), len(entry.srcs),
                        tuple(t.stride() for t in tensors))
    if isinstance(layout, int):
        raise ValueError(
            "ring_shift moves whole buffers or rows: entry %d buffer %d is "
            "not one dense block laid out as the others, nor rows at one "
            "pitch (strides %s)" % (e, layout, tensors[layout].stride()))
    return layout


def ring_launches(table: Sequence[RingEntry]) -> List[tuple]:
    """The C arguments (before device and stream) of the launches of
    ``rnb_ring_shift`` that move ``table``: empty entries dropped, the
    rest in order, as few launches as hold them."""
    table = [entry for entry in table if entry.srcs[0].numel()]
    if not table:
        return []
    n = len(table[0].srcs)
    per_launch = RING_MAX_TILES // n
    launches = []
    for start in range(0, len(table), per_launch):
        chunk = table[start:start + per_launch]
        srcs, dsts, src_pitch, dst_pitch, rows, row_bytes = ([] for _ in
                                                             range(6))
        for e, entry in enumerate(chunk):
            layout = _layout(entry, start + e)
            rows.append(layout[0])
            row_bytes.append(layout[1])
            src_pitch += layout[2]
            dst_pitch += layout[3]
            srcs += [t.data_ptr() for t in entry.srcs]
            dsts += [t.data_ptr() for t in entry.dsts]
        pairs, count = len(srcs), len(chunk)
        launches.append((
            (ctypes.c_void_p * pairs)(*srcs), (ctypes.c_void_p * pairs)(*dsts),
            (ctypes.c_longlong * pairs)(*src_pitch),
            (ctypes.c_longlong * pairs)(*dst_pitch),
            (ctypes.c_int * count)(*(entry.shift for entry in chunk)),
            (ctypes.c_longlong * count)(*rows),
            (ctypes.c_longlong * count)(*row_bytes), n, count))
    return launches


def ring_shift_group(table: Sequence[RingEntry]) -> None:
    """Move every entry of ``table``: member ``i``'s source into the
    destination of member ``(i + shift) % n``, written in place. On CUDA
    tensors, one launch of ``rnb_ring_shift`` on the current stream for
    the whole table (as few as hold it past :data:`RING_MAX_TILES`
    entry-member pairs); on CPU tensors, the plain version."""
    table = [RingEntry(list(entry.srcs), list(entry.dsts), int(entry.shift))
             for entry in table]
    if not table:
        return
    _check_table(table)
    tensors = [t for entry in table for t in entry.srcs + entry.dsts]
    if all(t.device.type == "cpu" for t in tensors):
        ring_shift_group_reference(table)
        return
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError("ring_shift runs its kernel on cuda tensors, got "
                         "%s" % device)
    for i, t in enumerate(tensors):
        if t.device != device:
            raise ValueError("ring_shift moves buffers within one card: "
                             "buffer 0 on %s, buffer %d on %s"
                             % (device, i, t.device))
    for args in ring_launches(table):
        _kernels.RING_SHIFT.launch(*args, device=device)


def _check_members(shards: Sequence[torch.Tensor]) -> None:
    """:func:`ring_shift`'s members off the CPU: on one card, of one
    dtype and shape, each one dense block."""
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
        if not _is_block(t.shape, t.stride()):
            raise ValueError("ring_shift moves whole buffers: member %d's "
                             "tensor is not one dense block (strides %s)"
                             % (i, t.stride()))


def ring_shift(shards: Sequence[torch.Tensor], shift: int = 1) -> Members:
    """Move every member's buffer to the member ``shift`` places along
    the ring: ``out[(i + shift) % n] = shards[i]`` (value-wise the
    reference's ``jnp.roll`` by ``shift`` shards). A shift of 0 returns
    the members as they are, as the reference does. Otherwise a table of
    one entry into new buffers of the members' layout: one launch of
    ``rnb_ring_shift`` on CUDA tensors, the plain version on CPU
    tensors."""
    shards = list(shards)
    n = len(shards)
    if not 1 <= n <= MAX_MEMBERS:
        raise ValueError("ring_shift takes 1 to %d members, got %d"
                         % (MAX_MEMBERS, n))
    shift = int(shift) % n
    if shift == 0:
        return shards
    if not all(t.device.type == "cpu" for t in shards):
        _check_members(shards)
    # the source's strides: a dense block maps byte for byte
    out = [torch.empty_like(shard) for shard in shards]
    ring_shift_group([RingEntry(shards, out, shift)])
    return out


def _one_step_shift_body(n: int) -> Callable[[Members], Members]:
    """The ring primitive the reduce-scatter rides: move every member's
    buffer to its +1 neighbour."""
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


def ring_gather_tables(leaves: Sequence[Sequence[torch.Tensor]],
                       axis: int = -1
                       ) -> Tuple[List[Members], List[List[RingEntry]]]:
    """The all-gather of every leaf's per-member shards along ``axis``
    as ``n - 1`` tables of the grouped hop, in launch order, and the
    full-width tensors (one a member and leaf, in the shard's memory
    format) that they fill. The first table places every member's own
    shard into its slot (shift 0) and hands it to the next member's slot
    (shift 1); table ``s >= 2`` hands on the slot that hop ``s - 1``
    filled, the ring's own order. Each chunk lands in each member's
    result exactly once."""
    leaves = [list(shards) for shards in leaves]
    if not leaves:
        return [], []
    n = len(leaves[0])
    for shards in leaves:
        if len(shards) != n:
            raise ValueError("a ring of %d members got %d shards"
                             % (n, len(shards)))
    if n == 1:
        return leaves, []
    gathered = []
    tables: List[List[RingEntry]] = [[] for _ in range(n - 1)]
    for shards in leaves:
        ax = axis % shards[0].dim()
        chunk = shards[0].shape[ax]
        full = [_full_width(shard, n, ax) for shard in shards]
        # slots[j][c]: chunk c's place in member j's result
        slots = [[f.narrow(ax, c * chunk, chunk) for c in range(n)]
                 for f in full]
        tables[0].append(RingEntry(shards, [slots[j][j] for j in range(n)],
                                   0))
        tables[0].append(RingEntry(
            shards, [slots[j][(j - 1) % n] for j in range(n)], 1))
        for s in range(2, n):
            # member i holds chunk i - s + 1 since hop s - 1
            tables[s - 1].append(RingEntry(
                [slots[i][(i - s + 1) % n] for i in range(n)],
                [slots[j][(j - s) % n] for j in range(n)], 1))
        gathered.append(full)
    return gathered, tables


def ring_all_gather_many(leaves: Sequence[Sequence[torch.Tensor]],
                         axis: int = -1) -> List[Members]:
    """Per-member shards along ``axis`` of every leaf -> each member's
    full concatenation of each leaf, all leaves in the same ``n - 1``
    grouped hops (:func:`ring_gather_tables`), each shard written
    straight into its slots. Pure movement, so every result is bitwise
    the unsharded tensor."""
    gathered, tables = ring_gather_tables(leaves, axis)
    for table in tables:
        ring_shift_group(table)
    return gathered


def ring_all_gather_body(n: int, axis: int = -1
                         ) -> Callable[[Members], Members]:
    """Per-member shards along ``axis`` -> each member's full
    concatenation (:func:`ring_all_gather_many` of one leaf): at degree
    2 one launch."""
    def body(shards: Members) -> Members:
        shards = list(shards)
        if len(shards) != n:
            raise ValueError("a ring of %d members got %d shards"
                             % (n, len(shards)))
        return ring_all_gather_many([shards], axis)[0]

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


# -- the inter-stage handoff --------------------------------------------------

def dma_available(*tensors: torch.Tensor) -> bool:
    """Is the ring route usable for ``tensors``? Only where
    ``rnb_ring_shift`` is built and every tensor lies on a card."""
    return bool(tensors) and all(t.is_cuda for t in tensors) \
        and os.path.exists(_kernels.library_path(_kernels.RING_SHIFT.source))


def ring_shift_amount(src_sharding, dst_sharding) -> Optional[int]:
    """The ring shift ``k`` (in member positions, ``1 <= k < n``) that
    maps the source placement onto the target placement, or ``None``
    when the move is not a pure ring shift: both are
    :class:`NamedSharding` s with equal specs over single-axis meshes of
    one axis name and the same ``n >= 2`` members, and the target's
    member list is the source's rotated by ``k``."""
    for s in (src_sharding, dst_sharding):
        if not isinstance(s, NamedSharding):
            return None
    if len(src_sharding.axis_names) != 1 \
            or tuple(dst_sharding.axis_names) \
            != tuple(src_sharding.axis_names):
        return None
    if tuple(src_sharding.spec) != tuple(dst_sharding.spec):
        return None
    src_devs = list(src_sharding.devices)
    dst_devs = list(dst_sharding.devices)
    n = len(src_devs)
    if n < 2 or len(dst_devs) != n:
        return None
    for k in range(1, n):
        if dst_devs == src_devs[k:] + src_devs[:k]:
            return k
    return None


def is_resident(data: torch.Tensor, device: torch.device) -> bool:
    """Does ``data`` lie on ``device`` (a card without an index meaning
    the current one)?"""
    if data.device.type != device.type:
        return False
    if device.type != "cuda":
        return True
    target = device.index if device.index is not None \
        else torch.cuda.current_device()
    return data.device.index == target


def reshard(data: torch.Tensor, target,
            source: Optional[NamedSharding] = None) -> torch.Tensor:
    """Re-home ``data`` onto ``target`` (a device, or a
    :class:`NamedSharding` whose members share one) without host
    memory: adopted by reference where it already lies there, else one
    ``.to(device, non_blocking=True)``, device to device on the current
    stream. ``source`` is the sharding ``data`` lies under (a tensor
    carries none): where it and ``target`` are one ring shift apart and
    :func:`dma_available`, the reference moves each shard to its
    neighbour by remote DMA. A shift between members on one card moves
    nothing, so that route starts only across distinct cards, and it
    raises "not yet ported"."""
    if isinstance(target, NamedSharding):
        distinct = len(set(target.devices))
        if distinct > 1 and dma_available(data) \
                and ring_shift_amount(source, target) is not None:
            raise NotImplementedError(
                "the ring route of reshard across %d distinct devices is "
                "not yet ported to rnb_tpu_torch: its hop between cards "
                "waits for peer access (ROADMAP.md, queue 1 item 5)"
                % distinct)
        device = target.device
    else:
        device = torch.device(target)
    if is_resident(data, device):
        return data
    return data.to(device, non_blocking=True)
