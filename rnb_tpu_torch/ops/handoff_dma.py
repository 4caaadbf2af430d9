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

A ring that spans the processes of a launch (a :class:`rnb_tpu_torch.
parallel.mesh.Ring` with one member a process) takes the same calls,
``ring=`` given: each process passes its own member's buffers and gets
its own member's results, and the contracts stay the reference's. On
CUDA tensors every hop is the kernel's cross-process form
(``rnb_ring_hop``, :mod:`rnb_tpu_torch.parallel.peers`), one launch a
hop: the results the collectives return lie in each member's arena, so
the sender writes each byte once, straight into its successor's
destination (through the memory CUDA IPC opened), where the successor
posted it, each side behind a device counter (the reference's
``send_sem``/``recv_sem``, numbered on the card, so a captured hop
replays as the next); at the end of the collective the process waits
for its card and raises where a wait gave up or the processes' tables
disagreed. A step that issues its gathers through
:func:`ring_all_gather_issued` waits once, where it ends
(``ShardedInference.run``), as the reference's one program waits on its
semaphores inside. On CPU tensors the plain version sends and receives
over the launch's gloo group (the counterpart of the reference's
``_ppermute_shift_body``), bounded by the same cap. On CUDA tensors no
byte goes through gloo, the host or a library copy.

The inter-stage handoff's half (``rnb_tpu_torch.handoff``):

* :func:`reshard` -- the one entry the edge calls: a tensor re-homed on a
  device or a :class:`rnb_tpu_torch.parallel.mesh.NamedSharding`,
  adopted where it already lies, else one device-to-device copy, never
  through the host. The reference's ring route (a pure ring shift of a
  one-axis sharding, one neighbour DMA a core) moves shards between
  distinct cards of one program, which no port mesh spans yet (two cards
  in one process wait for peer access), so it raises "not yet ported"
  (ROADMAP.md, queue 1 item 5).
* :func:`ring_shift_amount` -- the pattern detector, the reference's
  rule: the shift ``k`` that maps one sharding's member ring onto the
  other's, or ``None``.
* :func:`dma_available` -- the gate of the ring route.
"""

from __future__ import annotations

import datetime
import functools
import math
import os
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.parallel import peers
from rnb_tpu_torch.parallel.mesh import MAX_MEMBERS, NamedSharding, Ring

Members = List[torch.Tensor]

#: (entry, member) pairs one launch of ``rnb_ring_shift`` moves at most
#: (``kMaxTiles`` in csrc/ring.cu: the table rides in the kernel's 4 KB of
#: parameters); a larger table takes as few launches as hold it
RING_MAX_TILES = _kernels.RING_MAX_TILES


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


def _check_entry(entry: RingEntry, e: int, buffers: int, n: int,
                 what: str) -> None:
    """Raise unless ``entry`` holds ``buffers`` sources and destinations
    (``what`` names them), a shift in ``0..n-1``, all of one dtype and
    shape."""
    if len(entry.srcs) != buffers or len(entry.dsts) != buffers:
        raise ValueError("ring_shift entry %d: %d sources and %d "
                         "destinations for %s"
                         % (e, len(entry.srcs), len(entry.dsts), what))
    if not 0 <= entry.shift < n:
        raise ValueError("ring_shift entry %d: shift %d outside 0..%d"
                         % (e, entry.shift, n - 1))
    first = entry.srcs[0]
    for i, t in enumerate(list(entry.srcs) + list(entry.dsts)):
        if t.dtype != first.dtype or t.shape != first.shape:
            raise ValueError(
                "ring_shift needs every buffer of an entry of one dtype "
                "and shape: entry %d buffer 0 %s %s, buffer %d %s %s"
                % (e, first.dtype, tuple(first.shape), i, t.dtype,
                   tuple(t.shape)))


def _check_table(table: Sequence[RingEntry]) -> int:
    """The ring's degree, after checking every entry: one buffer a
    member on both sides, a shift in ``0..n-1``, one dtype and shape."""
    n = len(table[0].srcs)
    if not 1 <= n <= MAX_MEMBERS:
        raise ValueError("ring_shift takes 1 to %d members, got %d"
                         % (MAX_MEMBERS, n))
    for e, entry in enumerate(table):
        _check_entry(entry, e, n, n, "a ring of %d members" % n)
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
    entries = []
    for e, entry in enumerate(table):
        rows, row_bytes, src_pitches, dst_pitches = _layout(entry, e)
        entries.append(_kernels.RingTableEntry(
            [t.data_ptr() for t in entry.srcs],
            [t.data_ptr() for t in entry.dsts], src_pitches, dst_pitches,
            entry.shift, rows, row_bytes))
    return _kernels.ring_table(entries, len(table[0].srcs))


def ring_shift_group(table: Sequence[RingEntry],
                     ring: Optional[Ring] = None) -> None:
    """Move every entry of ``table``: member ``i``'s source into the
    destination of member ``(i + shift) % n``, written in place. On CUDA
    tensors, one launch of ``rnb_ring_shift`` on the current stream for
    the whole table (as few as hold it past :data:`RING_MAX_TILES`
    entry-member pairs); on CPU tensors, the plain version. Over a
    ``ring`` that spans processes, each entry holds this process's
    member's source and destination (:func:`_group_across`): a
    destination in this member's arena is written straight by the
    predecessor; a caller's own destination outside it lands in an arena
    slot that one more local launch then places. No collective the port
    runs takes that second route: each allocates its results in the
    arena."""
    table = [RingEntry(list(entry.srcs), list(entry.dsts), int(entry.shift))
             for entry in table]
    if not table:
        return
    if _across(ring):
        _finish_across(_group_across(table, ring))
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


# -- rings that span processes ----------------------------------------------

def _across(ring: Optional[Ring]) -> bool:
    """Does ``ring`` span processes (so each process holds one member)?"""
    return ring is not None and ring.spans_processes


def _card_path(ring: Ring) -> bool:
    """Does a collective over ``ring`` (which spans processes) run on the
    card, through ``rnb_ring_hop``? False on the CPU (the plain version
    over gloo)."""
    if ring.device.type not in ("cpu", "cuda"):
        raise ValueError("ring_shift runs its kernel on cuda tensors, got "
                         "%s" % ring.device)
    return ring.device.type == "cuda"


def _check_across(table: Sequence[RingEntry], ring: Ring) -> None:
    """Check a cross-process table: one source and one destination an
    entry, a shift in ``0..n-1``, one dtype and shape, every buffer on
    the member's device."""
    device = ring.device
    for e, entry in enumerate(table):
        _check_entry(entry, e, 1, ring.degree, "the one member of a ring "
                     "across processes in this process")
        for t in (entry.srcs[0], entry.dsts[0]):
            if t.device != device:
                raise ValueError("ring_shift entry %d: a buffer on %s, "
                                 "the ring's member on %s"
                                 % (e, t.device, device))


def _empty_across(specs: Sequence[peers.Spec], ring: Ring
                  ) -> List[torch.Tensor]:
    """The tensors a collective over ``ring`` returns, one a spec (shape,
    stride, dtype), taken at its start: in this member's arena on the
    card (so the predecessor writes into them), else plain tensors."""
    if _card_path(ring):
        return peers.endpoint(ring).empty(specs)
    return [torch.empty_strided(shape, stride, dtype=dtype,
                                device=ring.device)
            for shape, stride, dtype in specs]


def _group_across(table: Sequence[RingEntry], ring: Ring
                  ) -> Optional[peers.Endpoint]:
    """One process's part of a grouped hop over a ring that spans
    processes. On CUDA tensors: shift-0 entries are tiles within the
    member; each other shift, in the order the table first names it, is
    one hop of ``rnb_ring_hop`` (:meth:`peers.Endpoint.hop`; a shift of
    more than ``peers.HOP_MAX_TILES`` entries, as few hops as hold
    them), whose launch posts where each of its entries lands in this
    member and writes this member's sources where the successor posted
    its own. A destination in the arena (every collective the port runs
    allocates its results there) is posted as it is; a caller's own
    destination outside it lands in an arena slot, taken at the start,
    that one local launch then places (:meth:`peers.Endpoint.place`,
    counted as a launch). Every process builds the same table, so the
    posts agree with the sends. On CPU tensors, the plain version over
    gloo. Returns the endpoint of a hop on the card (None for none),
    whose card the caller waits for (:func:`_finish_across`)."""
    _check_across(table, ring)
    if not _card_path(ring):
        _group_across_reference(table, ring)
        return None
    local: List[peers.Tile] = []
    hops: dict = {}
    for e, entry in enumerate(table):
        src, dst = entry.srcs[0], entry.dsts[0]
        if not src.numel():
            continue
        rows, row_bytes, (src_pitch,), (dst_pitch,) = _layout(
            RingEntry([src], [dst], 0), e)
        tile = peers.Tile(src.data_ptr(), dst.data_ptr(), rows, row_bytes,
                          src_pitch, dst_pitch)
        if entry.shift == 0:
            local.append(tile)
        else:
            hops.setdefault(entry.shift, []).append(tile)
    if not hops:
        for args in _kernels.ring_table(
                [_kernels.RingTableEntry((t.src,), (t.dst,), (t.src_pitch,),
                                         (t.dst_pitch,), 0, t.rows,
                                         t.row_bytes) for t in local], 1):
            _kernels.RING_SHIFT.launch(*args, device=ring.device)
        return None
    ep = peers.endpoint(ring)
    # a caller's destinations outside the arena: slots, then one placement
    outside = [(shift, i) for shift, tiles in hops.items()
               for i, t in enumerate(tiles) if ep.arena.place(
                   t.dst, peers.extent(t.rows, t.row_bytes, t.dst_pitch))
               is None]
    slots = ep.reserve([hops[shift][i].rows * hops[shift][i].row_bytes
                        for shift, i in outside])
    placed = []
    for (shift, i), slot in zip(outside, slots):
        t = hops[shift][i]
        placed.append(peers.Tile(slot.ptr, t.dst, t.rows, t.row_bytes,
                                 t.row_bytes, t.dst_pitch))
        hops[shift][i] = t._replace(dst=slot.ptr, dst_pitch=t.row_bytes)
    room = peers.HOP_MAX_TILES
    for shift, tiles in hops.items():
        for start in range(0, len(tiles), room):
            remote = [t._replace(dst=ep.arena.place(t.dst, peers.extent(
                t.rows, t.row_bytes, t.dst_pitch)))
                for t in tiles[start:start + room]]
            # the shift-0 tiles ride in the first hop where they fit
            riding = local if len(local) + len(remote) <= room else []
            if local and not riding:
                for begin in range(0, len(local), room):
                    ep.place(local[begin:begin + room])
            ep.hop(shift, riding, remote)
            local = []
    for begin in range(0, len(placed), room):
        ep.place(placed[begin:begin + room])
    return ep


def _group_across_reference(table: Sequence[RingEntry], ring: Ring) -> None:
    """The plain version of :func:`_group_across`: shift-0 entries a
    ``copy_``; every other entry's bytes sent to the successor's process
    and received from the predecessor's over the launch's gloo group
    (tagged by entry), each transfer bounded by ``peers.wait_cap_s``.
    Each entry's byte count goes first and is checked against the
    receiver's, so processes whose tables disagree raise."""
    m, n = ring.local[0], ring.degree
    timeout = datetime.timedelta(seconds=peers.wait_cap_s)
    moves = []
    with torch.no_grad():
        for e, entry in enumerate(table):
            src, dst = entry.srcs[0], entry.dsts[0]
            if entry.shift == 0:
                dst.copy_(src)
            elif src.numel():
                moves.append((e, src, dst,
                              ring.processes[(m + entry.shift) % n],
                              ring.processes[(m - entry.shift) % n]))
        sizes = [(torch.tensor([src.numel() * src.element_size()]),
                  torch.zeros(1, dtype=torch.int64))
                 for _, src, _, _, _ in moves]
        _transfer([(2 * e, mine, theirs, succ, pred)
                   for (e, _, _, succ, pred), (mine, theirs)
                   in zip(moves, sizes)], ring, m, timeout)
        for (e, _, dst, _, pred), (_, theirs) in zip(moves, sizes):
            want = dst.numel() * dst.element_size()
            if int(theirs) != want:
                raise ValueError(
                    "ring %s: member %d's entry %d receives %d bytes from "
                    "process %d, where its destination holds %d: the "
                    "processes' tables disagree (other shapes)"
                    % (peers.ring_key(ring), m, e, int(theirs), pred, want))
        bufs = [torch.empty(dst.numel() * dst.element_size(),
                            dtype=torch.uint8) for _, _, dst, _, _ in moves]
        _transfer([(2 * e + 1, src.contiguous().reshape(-1).view(
            torch.uint8), buf, succ, pred)
                   for (e, src, _, succ, pred), buf in zip(moves, bufs)],
                  ring, m, timeout)
        for (_, _, dst, _, _), buf in zip(moves, bufs):
            dst.copy_(buf.view(dst.dtype).reshape(dst.shape))


def _transfer(moves, ring: Ring, m: int, timeout) -> None:
    """Each (tag, out, into, successor, predecessor) of ``moves``: ``out``
    sent to the successor's process and ``into`` received from the
    predecessor's over gloo, every transfer within ``timeout``; gloo's
    failure named."""
    import torch.distributed as dist
    peer = None
    try:
        pending = []
        for tag, out, into, succ, pred in moves:
            peer = succ
            pending.append((dist.isend(out, succ, tag=tag), succ))
            peer = pred
            pending.append((dist.irecv(into, pred, tag=tag), pred))
        for work, peer in pending:
            work.wait(timeout)
    except RuntimeError as err:  # gloo's own, named
        raise RuntimeError(
            "ring %s: member %d's transfer with process %s gave up within "
            "the %.1f s cap: %s" % (peers.ring_key(ring), m, peer,
                                    peers.wait_cap_s, err)) from err


def _finish_across(ep: Optional[peers.Endpoint]) -> None:
    """The end of a collective over a ring that spans processes: where it
    hopped on the card, wait for this process's stream and raise where a
    wait gave up."""
    if ep is not None:
        ep.finish()


def _shift_across(shards: Members, shift: int, ring: Ring,
                  out: Optional[Members] = None
                  ) -> Tuple[Members, Optional[peers.Endpoint]]:
    """:func:`ring_shift` of this process's member over a ring that spans
    processes (into ``out`` where given, else a new tensor laid out as
    the shard, in the arena on the card), without waiting for the card;
    and the endpoint of its hop on the card."""
    ring.check(shards, "ring_shift")
    shift = int(shift) % ring.degree
    if shift == 0:
        return shards, None
    if out is None:
        out = _empty_across([peers.spec_like(shards[0])], ring)
    return out, _group_across([RingEntry(shards, out, shift)], ring)


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


def ring_shift(shards: Sequence[torch.Tensor], shift: int = 1,
               ring: Optional[Ring] = None) -> Members:
    """Move every member's buffer to the member ``shift`` places along
    the ring: ``out[(i + shift) % n] = shards[i]`` (value-wise the
    reference's ``jnp.roll`` by ``shift`` shards). A shift of 0 returns
    the members as they are, as the reference does. Otherwise a table of
    one entry into new buffers of the members' layout: one launch of
    ``rnb_ring_shift`` on CUDA tensors, the plain version on CPU
    tensors. Over a ``ring`` that spans processes, ``shards`` is this
    process's member's buffer and so is the result: one hop of the
    cross-process form."""
    shards = list(shards)
    if _across(ring):
        out, ep = _shift_across(shards, shift, ring)
        _finish_across(ep)
        return out
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


def _full_width(shard: torch.Tensor, n: int, ax: int,
                device=None) -> torch.Tensor:
    """An empty tensor ``n`` times ``shard``'s extent along ``ax``, in
    its memory format (a channels-last conv kernel stays channels-last,
    so the gathered weight is laid out as the unsharded one), on
    ``device`` (by default the shard's)."""
    shape = list(shard.shape)
    shape[ax] *= n
    fmt = torch.contiguous_format
    if not shard.is_contiguous():
        for dims, channels_last in ((5, torch.channels_last_3d),
                                    (4, torch.channels_last)):
            if shard.dim() == dims and shard.is_contiguous(
                    memory_format=channels_last):
                fmt = channels_last
    return torch.empty(shape, dtype=shard.dtype,
                       device=device or shard.device, memory_format=fmt)


def _gather_tables_across(leaves: List[Members], axis: int, ring: Ring
                          ) -> Tuple[List[Members], List[List[RingEntry]]]:
    """:func:`ring_gather_tables` for this process's member of a ring
    that spans processes: its full-width tensors and its side of each
    table, in the same ring order (member ``m`` places its own shard,
    hands it on, and hands on at hop ``s`` the chunk hop ``s - 1``
    brought)."""
    n, m = ring.degree, ring.local[0]
    for shards in leaves:
        ring.check(shards, "ring_all_gather")
    if n == 1:
        return leaves, []
    gathered = []
    tables: List[List[RingEntry]] = [[] for _ in range(n - 1)]
    # the full-width tensors, in the arena on the card, taken at once
    fulls = _empty_across([peers.spec_like(_full_width(
        shard, n, axis % shard.dim(), "meta")) for (shard,) in leaves], ring)
    for (shard,), full in zip(leaves, fulls):
        ax = axis % shard.dim()
        chunk = shard.shape[ax]
        slots = [full.narrow(ax, c * chunk, chunk) for c in range(n)]
        tables[0].append(RingEntry([shard], [slots[m]], 0))
        tables[0].append(RingEntry([shard], [slots[(m - 1) % n]], 1))
        for s in range(2, n):
            tables[s - 1].append(RingEntry([slots[(m - s + 1) % n]],
                                           [slots[(m - s) % n]], 1))
        gathered.append([full])
    return gathered, tables


def ring_gather_tables(leaves: Sequence[Sequence[torch.Tensor]],
                       axis: int = -1, ring: Optional[Ring] = None
                       ) -> Tuple[List[Members], List[List[RingEntry]]]:
    """The all-gather of every leaf's per-member shards along ``axis``
    as ``n - 1`` tables of the grouped hop, in launch order, and the
    full-width tensors (one a member and leaf, in the shard's memory
    format) that they fill. The first table places every member's own
    shard into its slot (shift 0) and hands it to the next member's slot
    (shift 1); table ``s >= 2`` hands on the slot that hop ``s - 1``
    filled, the ring's own order. Each chunk lands in each member's
    result exactly once. Over a ``ring`` that spans processes, each leaf
    is this process's member's shard and so is each result."""
    leaves = [list(shards) for shards in leaves]
    if not leaves:
        return [], []
    if _across(ring):
        return _gather_tables_across(leaves, axis, ring)
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
                         axis: int = -1, ring: Optional[Ring] = None
                         ) -> List[Members]:
    """Per-member shards along ``axis`` of every leaf -> each member's
    full concatenation of each leaf, all leaves in the same ``n - 1``
    grouped hops (:func:`ring_gather_tables`), each shard written
    straight into its slots. Pure movement, so every result is bitwise
    the unsharded tensor. Over a ``ring`` that spans processes, this
    process's member's shards in, its results out, once the card is
    waited for."""
    if _across(ring):
        gathered, ep = _gather_across(leaves, axis, ring)
        _finish_across(ep)
        return gathered
    gathered, tables = ring_gather_tables(leaves, axis, ring)
    for table in tables:
        ring_shift_group(table)
    return gathered


def _gather_across(leaves: Sequence[Sequence[torch.Tensor]], axis: int,
                   ring: Ring) -> Tuple[List[Members],
                                        Optional[peers.Endpoint]]:
    """The all-gather over a ring that spans processes, issued: its
    results, and the endpoint of its hops on the card (None for none)."""
    gathered, tables = ring_gather_tables(leaves, axis, ring)
    eps = [_group_across(table, ring) for table in tables]
    return gathered, eps[-1] if eps else None


def ring_all_gather_issued(leaves: Sequence[Sequence[torch.Tensor]],
                           axis: int, ring: Ring) -> List[Members]:
    """:func:`ring_all_gather_many` over a ``ring`` that spans
    processes, issued and not waited for: no host wait. The caller waits
    for its stream once, where its step ends, and then checks the ring's
    error word (``peers.Endpoint.check_reported``), as
    ``ShardedInference.run`` does; so the step captures into one CUDA
    graph. On CPU tensors the plain version over gloo, as the waiting
    form."""
    if not _across(ring):
        raise ValueError("ring_all_gather_issued takes a ring that spans "
                         "processes, got %r" % (ring,))
    return _gather_across(leaves, axis, ring)[0]


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
    the shards are checked against its members; over a ring that spans
    processes they are this process's member's, as is the result."""
    shards = list(shards)
    if ring is not None:
        ring.check(shards, "ring_all_gather")
    if _across(ring):
        return ring_all_gather_many([shards], axis, ring)[0]
    return ring_all_gather_body(len(shards), axis)(shards)


def _psum_scatter_across(operands: Members, ring: Ring,
                         axis: int) -> Members:
    """:func:`ring_psum_scatter_body` for this process's member ``m`` of
    a ring that spans processes: the reference's ring order, hop for
    hop (one cross-process hop each, then the local add)."""
    n, m = ring.degree, ring.local[0]
    (x,) = operands
    ax = axis % x.dim()
    width = x.shape[ax]
    if width % n:
        raise ValueError(
            "ring_psum_scatter: axis %d extent %d not divisible by %d "
            "ring members" % (ax, width, n))
    if n == 1:
        return operands
    chunk = width // n
    acc = [x.narrow(ax, ((m - 1) % n) * chunk, chunk).contiguous()]
    # every hop's moved chunk, in the arena on the card, taken at once
    moves = _empty_across([peers.spec_like(acc[0])] * (n - 1), ring)
    ep = None
    for s in range(1, n):
        moved, ep = _shift_across(acc, 1, ring, [moves[s - 1]])
        acc = [moved[0] + x.narrow(ax, ((m - 1 - s) % n) * chunk, chunk)]
    _finish_across(ep)
    return acc


def ring_psum_scatter(operands: Sequence[torch.Tensor], ring=None,
                      axis: int = -1) -> Members:
    """Standalone entry: one full-width operand a member -> member ``i``
    holds chunk ``i`` of their sum along ``axis``; the chunks in member
    order concatenate to the full sum. With ``ring`` the operands are
    checked against its members; over a ring that spans processes they
    are this process's member's, as is the result."""
    operands = list(operands)
    if ring is not None:
        ring.check(operands, "ring_psum_scatter")
    if _across(ring):
        return _psum_scatter_across(operands, ring, axis)
    return ring_psum_scatter_body(len(operands), axis)(operands)


# -- the inter-stage handoff --------------------------------------------------

def dma_available(*tensors: torch.Tensor) -> bool:
    """Is the ring route usable for ``tensors``? Only where
    ``rnb_ring_shift`` is built and every tensor lies on a card (as for
    a ring across processes, whose hop is the same library's
    ``rnb_ring_hop``)."""
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
