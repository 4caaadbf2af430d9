"""The peers' memory of a ring that spans processes.

New in the port: the reference's remote DMA names its destination by a
mesh device id and XLA's runtime finds the memory (``rnb_tpu/ops/
handoff_dma.py``, ``make_async_remote_copy`` with
``DeviceIdType.MESH``). Across the processes of a launch
(:mod:`rnb_tpu_torch.parallel.distributed`) each process has its own
CUDA context, so a member reaches its successor's memory through CUDA
IPC: an :class:`Endpoint` is one process's end of one ring, made at the
ring's first collective and kept for its life.

* Each member allocates once, with ``cudaMalloc`` (so each is the base
  of its own allocation and its handle opens at offset 0), a counter
  allocation laid out as ``csrc/ring.cu`` reads it (``recv``,
  ``posted``, the launch's block counts, the error word on the card and
  the post of the current hop), reported into a pinned word the host
  reads; and a result :class:`Arena`: segments of device memory the
  cross-process collectives allocate the tensors they return from, so
  a sender can write straight into its successor's destination.
* It exports them as IPC handles, exchanges them through the launch's
  store, and opens its peers' handles with the lazy peer-access flag.
  Nothing is opened a hop: the counters at the ring's first collective,
  an arena segment when every member adds one at once
  (:meth:`Endpoint.reserve`, at a collective's start, as rarely as the
  arena doubles; a segment is never freed while a result views it).
* :meth:`Endpoint.hop` is one hop of the kernel ``rnb_ring_hop``, one
  launch on the member's stream: it posts where the hop lands in this
  member (each tile's arena place, rows, row length and pitch), waits
  for the successor's post, checks it against its own tiles (processes
  whose tables disagree fail there, before any byte moves), writes each
  byte once into the successor's arena, signals the successor's
  ``recv`` and waits for its own, every wait bounded by
  :data:`wait_cap_s`. The hop's number lives on the card (the member's
  count of hops launched, in its counter allocation), so the same
  launch, captured into a CUDA graph and replayed, is the next hop.
  :meth:`Endpoint.finish` waits for the card (:func:`wait_for_card`,
  counted in :data:`host_waits`) and raises where a wait gave up or a
  post disagreed; a caller that issues several collectives waits once
  and calls :meth:`Endpoint.check_reported` itself.
* :class:`Capture`: a CUDA graph capture of collectives across
  processes gets the arena tensors its warm-up took, holds them for the
  graph's life, and never takes from or grows an arena.
* :func:`close_all` (from ``distributed.shutdown``): every endpoint
  waits for its card, closes its peers' handles, meets the others at a
  barrier, then frees its own memory (an arena segment a live result
  still views once that result dies).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import datetime
import pickle
import sys
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import torch

from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.parallel.mesh import Ring

#: seconds a wait on a peer (a counter on the card, a store read, a
#: barrier, a gloo transfer) may take before the call raises
DEFAULT_WAIT_CAP_S = 60.0
wait_cap_s = DEFAULT_WAIT_CAP_S

#: the counter allocation (``kRecv`` .. ``kHops`` in ring.cu): ``recv``
#: (hops landed here), ``posted`` (hops posted), the launch's finished
#: blocks (64 bits: their count, and in the high half those that moved
#: nothing) and started blocks, the error word, the post's tile count,
#: then the post, one tile of POST_TILE_BYTES each; in the last 64 bytes
#: ``hops``, the hops this member has launched (a launch's number is one
#: more)
COUNTER_BYTES = 4096
RECV, POSTED, DONE, CLAIM, ERROR, POST_COUNT, POST, HOPS = (
    0, 64, 128, 192, 256, 320, 384, 4032)
POST_TILE_BYTES = 32
#: the pinned report (64 bytes; ``kReportHop``): the error word, then at
#: REPORT_HOP the number of the first hop that reported it
REPORT_HOP = 8
#: the error word's values (``kTimedOut``, ``kTablesDiffer`` in ring.cu)
TIMED_OUT, TABLES_DIFFER = 1, 2
#: tiles one hop's launch moves at most; arena segments a member holds at
#: most
HOP_MAX_TILES = _kernels.RING_HOP_MAX_TILES
MAX_SEGMENTS = _kernels.RING_HOP_MAX_SEGMENTS
#: a posted place: segment << SEGMENT_SHIFT | offset
SEGMENT_SHIFT = 40
#: an arena segment is a multiple of this (and at least doubles the
#: arena); a lease starts at a multiple of ARENA_ALIGN (the kernel's
#: 16-byte vector path)
ARENA_QUANTUM = 1 << 20
ARENA_ALIGN = 256

_P, _L = ctypes.c_void_p, ctypes.c_longlong

#: the host's waits for the card at the end of collectives across
#: processes and of ``ShardedInference.run`` (:func:`wait_for_card`); a
#: capture's are tallied in it (:class:`Capture`), not here
host_waits = 0


def wait_for_card(device: torch.device) -> None:
    """The host waits for this process's stream on ``device`` (nothing
    to wait for on the CPU), counted in :data:`host_waits`."""
    global host_waits
    capture = capturing()
    if capture is not None:
        capture.host_waits += 1
    else:
        host_waits += 1
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def set_wait_cap(seconds: float) -> float:
    """Bound every wait on a peer to ``seconds``; returns the previous
    bound."""
    global wait_cap_s
    if not seconds > 0:
        raise ValueError("a wait cap must be positive, got %r" % (seconds,))
    previous, wait_cap_s = wait_cap_s, float(seconds)
    return previous


class Tile(NamedTuple):
    """One move of a hop: ``rows`` rows of ``row_bytes`` from ``src`` (at
    ``src_pitch``) to ``dst`` (at ``dst_pitch``). In a tile that lands in
    the successor (a remote tile) ``dst`` and ``dst_pitch`` are this
    member's post: where it receives the same entry (an arena place,
    :meth:`Arena.place`) and that destination's pitch."""
    src: int
    dst: int
    rows: int
    row_bytes: int
    src_pitch: int
    dst_pitch: int


def extent(rows: int, row_bytes: int, pitch: int) -> int:
    """Bytes from the first byte of ``rows`` rows at ``pitch`` to past
    their last."""
    return 0 if rows <= 0 else (rows - 1) * pitch + row_bytes


def _library():
    lib = _kernels._library(_kernels.RING_SHIFT.source)
    if not getattr(lib, "_rnb_peers_bound", False):
        for name, argtypes in (
                ("rnb_peer_alloc", [_L, ctypes.c_int, ctypes.POINTER(_P)]),
                ("rnb_peer_free", [_P, ctypes.c_int]),
                ("rnb_peer_handle_bytes", []),
                ("rnb_peer_export", [_P, ctypes.c_int, ctypes.c_char_p]),
                ("rnb_peer_open", [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.POINTER(_P)]),
                ("rnb_peer_close", [_P, ctypes.c_int]),
                ("rnb_error_word_alloc", [ctypes.POINTER(_P),
                                          ctypes.POINTER(_P)]),
                ("rnb_error_word_free", [_P])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        lib._rnb_peers_bound = True
    return lib


def _call(lib, name: str, *args) -> None:
    code = getattr(lib, name)(*args)
    if code != 0:
        raise RuntimeError("%s failed: CUDA error %d (%s)" % (
            name, code, lib.rnb_error_string(code).decode()))


def hop_args(tiles: Sequence[Tile], remote: int, succ: Optional[int],
             segments: Sequence[Tuple[int, int]], counters: int,
             report: Optional[int], cap_ns: int) -> tuple:
    """The C arguments of one launch of ``rnb_ring_hop`` (before device
    and stream): ``tiles`` (at most :data:`HOP_MAX_TILES`, the first
    ``remote`` landing in the successor's arena), the successor's counter
    allocation ``succ`` (None: a local launch) and its arena ``segments``
    ``(pointer, bytes)`` as mapped here, this member's ``counters``, the
    pinned ``report`` word and the cap. They name no hop: the kernel
    numbers it from the member's count on the card, so launched again
    they are the next hop."""
    if len(tiles) > HOP_MAX_TILES or len(segments) > MAX_SEGMENTS:
        raise ValueError("a hop's launch moves at most %d tiles into at "
                         "most %d segments, got %d and %d"
                         % (HOP_MAX_TILES, MAX_SEGMENTS, len(tiles),
                            len(segments)))
    (table,) = _kernels.ring_table(
        [_kernels.RingTableEntry((t.src,), (t.dst,), (t.src_pitch,),
                                 (t.dst_pitch,), 0, t.rows, t.row_bytes)
         for t in tiles], 1, at_least_one=True)
    return (*table, remote, succ,
            (_P * MAX_SEGMENTS)(*(p for p, _ in segments)),
            (_L * MAX_SEGMENTS)(*(b for _, b in segments)), len(segments),
            counters, report, cap_ns)


def ring_key(ring: Ring) -> str:
    """A ring's name in the launch's store: its axis, members and
    processes (every process of the ring makes the same)."""
    return "%s:%s:%s" % (ring.axis_name,
                         ",".join(str(d) for d in ring.devices),
                         ",".join(str(p) for p in ring.processes))


# -- the arena ----------------------------------------------------------------

def _align(nbytes: int) -> int:
    return -(-nbytes // ARENA_ALIGN) * ARENA_ALIGN


class _Lease:
    """One range of an arena, held by the tensor that views it (through
    its array interface): the range goes back to the arena when the
    tensor's storage dies."""

    def __init__(self, arena: "Arena", segment: int, offset: int,
                 nbytes: int, ptr: int, stream):
        self.arena = arena
        self.segment = segment
        self.offset = offset
        self.nbytes = nbytes
        self.ptr = ptr
        self.stream = stream

    def _interface(self, version: int) -> dict:
        return {"shape": (self.nbytes,), "typestr": "|u1",
                "data": (self.ptr, False), "version": version}

    @property
    def __cuda_array_interface__(self) -> dict:
        return self._interface(2)

    @property
    def __array_interface__(self) -> dict:
        return self._interface(3)

    def __del__(self):
        if not sys.is_finalizing():
            self.arena._release(self)


class Arena:
    """A ring member's result memory: segments (each its own allocation,
    exported to the peers), ranges of them leased to the tensors the
    cross-process collectives return.

    ``allocate(nbytes) -> pointer`` and ``free(pointer)`` make and drop a
    segment; ``stream()`` is the stream a lease is taken on. A range goes
    back to the arena when the storage of the tensor that views it dies,
    and is handed out again under the caching allocator's stream rule:
    on the stream it was taken on, later work follows the work queued
    before its free in stream order (the successor's write follows this
    member's post, queued after it); on another stream, that stream first
    waits for the one it was taken on. A result used on a stream of the
    caller's own is the caller's to order, as with the caching allocator
    (``record_stream``). Growth (:meth:`add`) never frees a segment; once
    the arena is closed, a segment is freed when its last lease dies.

    A lease dies in ``__del__``, which can run inside a garbage collection
    that an allocation under ``_lock`` started on the very thread that
    holds it. So a release never waits for the lock: it is queued on
    ``_pending`` (a deque append needs no lock), and folded into the free
    lists by whoever holds the lock next, before it reads them; where the
    lock is free at once the releasing thread folds it in itself. Every
    holder looks at the queue again after it lets go, so no release stays
    queued behind a holder that has finished. (A re-entrant lock would
    let the inner release change a free list while the outer holder keeps
    an index into it.)"""

    GUARDED_BY = {"bases": "_lock", "sizes": "_lock", "_ranges": "_lock",
                  "leased": "_lock", "closed": "_lock", "_orphans": "_lock"}
    UNGUARDED_OK = {"_pending": "a deque: a dying lease appends without "
                                "the lock, a holder of the lock pops"}

    def __init__(self, device: torch.device,
                 allocate: Callable[[int], int],
                 free: Callable[[int], None],
                 stream: Optional[Callable[[], object]] = None):
        self.device = device
        self._allocate = allocate
        self._free = free
        if stream is None:
            stream = ((lambda: torch.cuda.current_stream(device))
                      if device.type == "cuda" else (lambda: None))
        self._stream = stream
        self._lock = threading.Lock()
        #: per segment: its base (0 once freed), its bytes, its free
        #: ranges [offset, bytes, streams] by offset, its leased bytes
        self.bases: List[int] = []
        self.sizes: List[int] = []
        self._ranges: List[List[list]] = []
        self.leased: List[int] = []
        self.closed = False
        #: leases that died and are not yet folded into the free lists
        self._pending: collections.deque = collections.deque()
        #: the bases of segments a fold freed (a closed arena's last
        #: lease of them), freed once the lock is let go
        self._orphans: List[int] = []

    def _fold_locked(self) -> None:
        """Fold the queued releases into the free lists (``_lock`` held)."""
        while self._pending:
            orphan = self._release_locked(self._pending.popleft())
            if orphan:
                self._orphans.append(orphan)

    def _drain_locked(self) -> List[int]:
        """Fold the queued releases in and hand over the orphaned
        segments' bases (``_lock`` held)."""
        self._fold_locked()
        orphans, self._orphans = self._orphans, []
        return orphans

    def _settle(self) -> None:
        """After letting go of the lock: fold in the releases queued
        meanwhile and free the orphaned segments, wherever the lock is
        free at once. Never waits (see the class's docstring)."""
        while self._lock.acquire(blocking=False):
            try:
                orphans = self._drain_locked()
            finally:
                self._lock.release()
            for ptr in orphans:
                self._free(ptr)
            if not self._pending:
                return

    @property
    def nbytes(self) -> int:
        with self._lock:
            self._fold_locked()
            size = sum(self.sizes)
        self._settle()
        return size

    @staticmethod
    def _fit(ranges: List[List[list]], nbytes: int):
        """First fit of ``nbytes`` (aligned) in ``ranges``, carved out:
        (segment, offset, the streams the range was freed on), or None."""
        for s, free in enumerate(ranges):
            for i, (offset, size, streams) in enumerate(free):
                if size >= nbytes:
                    if size == nbytes:
                        del free[i]
                    else:
                        free[i] = [offset + nbytes, size - nbytes, streams]
                    return s, offset, streams
        return None

    def shortfall(self, sizes: Sequence[int]) -> int:
        """Bytes of ``sizes`` (each aligned) that do not fit the arena's
        free ranges as they are: 0 where every one does."""
        with self._lock:
            self._fold_locked()
            ranges = [[list(r) for r in free] for free in self._ranges]
        self._settle()
        return sum(_align(n) for n in sizes
                   if self._fit(ranges, _align(n)) is None)

    def grown_size(self, shortfall: int) -> int:
        """The size of the segment that holds ``shortfall`` more bytes:
        at least the arena's size (so it doubles), a multiple of
        :data:`ARENA_QUANTUM`."""
        size = max(shortfall, self.nbytes)
        return -(-size // ARENA_QUANTUM) * ARENA_QUANTUM

    def add(self, ptr: int, nbytes: int) -> None:
        """One more segment, of ``nbytes`` at ``ptr`` (from ``allocate``)."""
        with self._lock:
            self._fold_locked()
            self.bases.append(ptr)
            self.sizes.append(nbytes)
            self._ranges.append([[0, nbytes, ()]])
            self.leased.append(0)
        self._settle()

    def take(self, sizes: Sequence[int]) -> List[_Lease]:
        """A lease of each of ``sizes`` bytes, on the current stream;
        raises where one does not fit (see :meth:`shortfall`)."""
        current = self._stream()
        taken = []
        try:
            with self._lock:
                self._fold_locked()
                for n in sizes:
                    got = self._fit(self._ranges, _align(n))
                    if got is None:
                        raise RuntimeError(
                            "the arena's %d bytes hold no free range of %d"
                            % (sum(self.sizes), n))
                    segment, offset, streams = got
                    for stream in streams:
                        if stream is not None and stream != current:
                            current.wait_stream(stream)
                    self.leased[segment] += _align(n)
                    taken.append((segment, offset, _align(n),
                                  self.bases[segment] + offset))
        finally:
            self._settle()
        return [_Lease(self, s, o, n, ptr, current)
                for s, o, n, ptr in taken]

    def _release(self, lease: _Lease) -> None:
        """A lease's range goes back (from its ``__del__``): queued, then
        folded in where the lock is free at once."""
        self._pending.append(lease)
        self._settle()

    def _release_locked(self, lease: _Lease) -> int:
        """``lease``'s range back into its segment's free list, coalesced
        (``_lock`` held); returns the segment's base where that was a
        closed arena's last lease of it, else 0."""
        free = self._ranges[lease.segment]
        i = 0
        while i < len(free) and free[i][0] < lease.offset:
            i += 1
        free.insert(i, [lease.offset, lease.nbytes, (lease.stream,)])
        # coalesce with the neighbours, keeping every stream to wait on
        for j in (i, i - 1):
            if 0 <= j < len(free) - 1 and \
                    free[j][0] + free[j][1] == free[j + 1][0]:
                streams = tuple(dict.fromkeys(free[j][2] + free[j + 1][2]))
                free[j] = [free[j][0], free[j][1] + free[j + 1][1],
                           streams]
                del free[j + 1]
        self.leased[lease.segment] -= lease.nbytes
        if self.closed and self.leased[lease.segment] == 0:
            orphan, self.bases[lease.segment] = self.bases[lease.segment], 0
            return orphan
        return 0

    def place(self, ptr: int, nbytes: int) -> Optional[int]:
        """The place (``segment << SEGMENT_SHIFT | offset``) of ``nbytes``
        at ``ptr`` where they lie in one segment, else None."""
        found = None
        with self._lock:
            self._fold_locked()
            for s, (base, size) in enumerate(zip(self.bases, self.sizes)):
                if base and base <= ptr and ptr + nbytes <= base + size:
                    found = s << SEGMENT_SHIFT | (ptr - base)
                    break
        self._settle()
        return found

    def tensor(self, lease: _Lease, shape: Sequence[int],
               stride: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
        """A tensor of ``shape`` and ``stride`` over ``lease``, which it
        holds."""
        if self.device.type == "cuda":
            flat = torch.as_tensor(lease, device=self.device)
        else:
            import numpy as np
            flat = torch.from_numpy(np.asarray(lease))
        return torch.as_strided(flat.view(dtype), tuple(shape),
                                tuple(stride))

    def close(self) -> None:
        """Free every segment no lease views; the others go with their
        last lease."""
        with self._lock:
            self._fold_locked()
            self.closed = True
            idle = [s for s, n in enumerate(self.leased)
                    if n == 0 and self.bases[s]]
            ptrs = [self.bases[s] for s in idle]
            for s in idle:
                self.bases[s] = 0
        for ptr in ptrs:
            self._free(ptr)
        self._settle()


#: a result's shape, stride and dtype
Spec = Tuple[Sequence[int], Sequence[int], torch.dtype]


def spec_like(t: torch.Tensor) -> Spec:
    """The spec of a tensor laid out as ``t`` (its strides where it is
    dense, as ``torch.empty_like``)."""
    return (t.shape, torch.empty_like(t, device="meta").stride(), t.dtype)


def spec_bytes(spec: Spec) -> int:
    shape, stride, dtype = spec
    if not all(shape):
        return 0
    elements = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
    return elements * dtype.itemsize


class Endpoint:
    """This process's end of one ring that spans processes, on CUDA:
    its member's counters (``counters``; its error word at
    ``counters + ERROR``; ``report_host``/``report_dev``, the pinned word
    it is reported into) and result arena, and its peers' opened
    counters and arena segments."""

    def __init__(self, ring: Ring, key: str, store):
        if len(ring.local) != 1:
            raise ValueError("a ring across processes has one member in "
                             "this process, got %d" % len(ring.local))
        self._setup(ring, key, store)
        self.lib = _library()
        index = self._index()
        ptr = _P()
        _call(self.lib, "rnb_peer_alloc", COUNTER_BYTES, index,
              ctypes.byref(ptr))
        self.counters = ptr.value
        host, dev = _P(), _P()
        _call(self.lib, "rnb_error_word_alloc", ctypes.byref(host),
              ctypes.byref(dev))
        self.report_host, self.report_dev = host.value, dev.value
        self.arena = Arena(self.device, self._allocate, self._free)
        self.peer_counters = {m: ptr for m, (ptr, _) in self._exchange(
            self.counters, COUNTER_BYTES).items()}

    def _setup(self, ring: Ring, key: str, store) -> None:
        self.ring = ring
        self.key = key
        self.store = store
        self.member = ring.local[0]
        self.degree = ring.degree
        self.device = ring.device
        self.epoch = 0
        self.broken: Optional[str] = None
        #: each peer's arena segments: (pointer here, bytes)
        self.peer_segments: Dict[int, List[Tuple[int, int]]] = {
            m: [] for m in range(self.degree) if m != self.member}
        self.peer_counters: Dict[int, int] = {}
        self._round = 0
        self._closed = False

    def _index(self) -> int:
        return self.device.index or 0

    def _allocate(self, nbytes: int) -> int:
        ptr = _P()
        _call(self.lib, "rnb_peer_alloc", nbytes, self._index(),
              ctypes.byref(ptr))
        return ptr.value

    def _free(self, ptr: int) -> None:
        self.lib.rnb_peer_free(_P(ptr), self._index())

    # -- the control plane: the launch's store -----------------------------

    def _name(self, what: str, member: int) -> str:
        return "rnb-peers/%s/%d/%s/%d" % (self.key, self._round, what,
                                          member)

    def _wait_keys(self, what: str) -> None:
        keys = [self._name(what, m) for m in range(self.degree)]
        try:
            self.store.wait(keys, datetime.timedelta(seconds=wait_cap_s))
        except Exception as e:  # the store's timeout, named
            raise RuntimeError(
                "ring %s: member %d waited %.1f s for its peers at %s: %s"
                % (self.key, self.member, wait_cap_s, what, e)) from e

    def barrier(self, what: str) -> None:
        """Meet every member of the ring (bounded by :data:`wait_cap_s`)."""
        self._round += 1
        self.store.set(self._name(what, self.member), b"1")
        self._wait_keys(what)

    def _exchange(self, ptr: int, nbytes: int) -> Dict[int, tuple]:
        """Export the allocation of ``nbytes`` at ``ptr``, publish its
        handle (offset 0) and size, and open every peer's: ``{member:
        (its pointer here, its size)}``."""
        self._round += 1
        size = self.lib.rnb_peer_handle_bytes()
        handle = ctypes.create_string_buffer(size)
        _call(self.lib, "rnb_peer_export", _P(ptr), self._index(), handle)
        self.store.set(self._name("handle", self.member),
                       pickle.dumps((handle.raw, 0, nbytes)))
        self._wait_keys("handle")
        opened = {}
        for m in range(self.degree):
            if m == self.member:
                continue
            raw, offset, peer_bytes = pickle.loads(self.store.get(
                self._name("handle", m)))
            out = _P()
            _call(self.lib, "rnb_peer_open", raw, self._index(),
                  ctypes.byref(out))
            opened[m] = (out.value + offset, peer_bytes)
        return opened

    # -- the arena ---------------------------------------------------------

    def reserve(self, sizes: Sequence[int]) -> List[_Lease]:
        """Leases of ``sizes`` bytes for a collective's results, at its
        start. Where they do not fit, every member adds a segment at once
        (the same program asks for the same bytes at the same collective)
        and the peers open it (:meth:`_grow`). In a graph capture, the
        leases its warm-up took (:class:`Capture`)."""
        return _lend(self, ("reserve", tuple(sizes)),
                     lambda: self._reserve(sizes))

    def _reserve(self, sizes: Sequence[int]) -> List[_Lease]:
        short = self.arena.shortfall(sizes)
        if short:
            self._grow(self.arena.grown_size(short))
        leases = self.arena.take(sizes)
        capture = _capture_of_thread()
        if capture is not None:
            capture.leases.extend(leases)
        return leases

    def _grow(self, nbytes: int) -> None:
        """One more arena segment of ``nbytes`` on every member,
        exchanged: each peer's is opened here."""
        if len(self.arena.sizes) >= MAX_SEGMENTS:
            raise RuntimeError("ring %s: member %d's arena has %d segments "
                               "already" % (self.key, self.member,
                                            MAX_SEGMENTS))
        ptr = self._allocate(nbytes)
        self.arena.add(ptr, nbytes)
        for m, segment in self._exchange(ptr, nbytes).items():
            self.peer_segments[m].append(segment)

    def empty(self, specs: Sequence[Spec]) -> List[torch.Tensor]:
        """A tensor in the arena for each spec (shape, stride, dtype), all
        leased at once; in a graph capture, the tensors its warm-up took
        (:class:`Capture`)."""
        key = ("empty", tuple((tuple(shape), tuple(stride), dtype)
                              for shape, stride, dtype in specs))
        return _lend(self, key, lambda: self._empty(specs))

    def _empty(self, specs: Sequence[Spec]) -> List[torch.Tensor]:
        sizes = [spec_bytes(spec) for spec in specs]
        leases = iter(self._reserve([n for n in sizes if n]))
        return [self.arena.tensor(next(leases), shape, stride, dtype)
                if n else torch.empty_strided(shape, stride, dtype=dtype,
                                              device=self.device)
                for (shape, stride, dtype), n in zip(specs, sizes)]

    # -- the hop -----------------------------------------------------------

    def hop(self, shift: int, local: Sequence[Tile],
            remote: Sequence[Tile]) -> None:
        """One hop at ``shift`` on the current stream, one launch: the
        ``remote`` tiles into the successor's arena at its posted places
        (each ``dst`` this member's own post), the ``local`` tiles within
        the member. The launch ends once the predecessor's hop has landed
        here. The card numbers the hop; :attr:`epoch`, the host's count,
        names it in messages (in a capture each replay adds it)."""
        if self.broken is not None:
            raise RuntimeError(self.broken)
        succ = (self.member + shift) % self.degree
        self._launch(hop_args(
            list(remote) + list(local), len(remote),
            self.peer_counters[succ], self.peer_segments[succ],
            self.counters, self.report_dev, int(wait_cap_s * 1e9)))
        capture = capturing()
        if capture is not None:
            capture.hops[self] = capture.hops.get(self, 0) + 1
        else:
            self.epoch += 1

    def place(self, tiles: Sequence[Tile]) -> None:
        """``tiles`` within the member in one local launch, which moves
        nothing once a hop of the ring failed (its error word set)."""
        self._launch(hop_args(tiles, 0, None, [], self.counters,
                              self.report_dev, int(wait_cap_s * 1e9)))

    def _launch(self, args: tuple) -> None:
        _kernels.RING_SHIFT.launch(*args, device=self.device,
                                   entry=_kernels.RING_HOP_ENTRY)

    def reported(self) -> int:
        """The error word as the card reported it (read with no copy)."""
        return ctypes.c_int.from_address(self.report_host).value

    def reported_hop(self) -> int:
        """The number of the first hop that reported an error (0: none),
        as the card counts them."""
        return ctypes.c_longlong.from_address(self.report_host
                                              + REPORT_HOP).value

    def finish(self) -> None:
        """Wait for this process's stream (:func:`wait_for_card`), then
        raise where a wait of the collective gave up (a peer that died or
        stalled past the cap) or a post disagreed with this member's
        table."""
        wait_for_card(self.device)
        self.check_reported()

    def check_reported(self) -> None:
        """Raise where the card reported a wait that gave up or a post
        that disagreed (the ring is then broken for good), naming the
        ring and the hop. Read only once the card has done the work
        (after :func:`wait_for_card`)."""
        code = self.reported()
        if code and self.broken is None:
            hop = self.reported_hop() or self.epoch
            self.broken = (
                "ring %s: member %d's hop %d: the successor posted other "
                "destinations than this member's table sends (the "
                "processes' tables disagree); the ring is broken"
                % (self.key, self.member, hop)
                if code == TABLES_DIFFER else
                "ring %s: member %d's hop %d %s: a peer died, stalled past "
                "the %.1f s cap or found the tables disagree; the ring is "
                "broken"
                % (self.key, self.member, hop,
                   "timed out" if code == TIMED_OUT else "gave up",
                   wait_cap_s))
        if self.broken is not None:
            raise RuntimeError(self.broken)

    # -- teardown ----------------------------------------------------------

    def close(self) -> None:
        """Wait for the card, close the peers' handles, meet the other
        members, then free this member's memory (a segment a live result
        views, once that result dies). Frees even where the barrier times
        out (a dead peer), then raises."""
        if self._closed:
            return
        self._closed = True
        failure = None
        try:
            torch.cuda.synchronize(self.device)
            opened = [p for segments in self.peer_segments.values()
                      for p, _ in segments]
            for ptr in opened + list(self.peer_counters.values()):
                _call(self.lib, "rnb_peer_close", _P(ptr), self._index())
            self.peer_segments, self.peer_counters = {}, {}
            self.barrier("close")
        except Exception as e:  # re-raised once the memory is freed
            failure = e
        self.arena.close()
        if self.counters:
            self.lib.rnb_peer_free(_P(self.counters), self._index())
        self.lib.rnb_error_word_free(_P(self.report_host))
        self.counters = 0
        if failure is not None:
            raise failure


# -- CUDA graph captures ------------------------------------------------------

_capture_state = threading.local()


def _capture_of_thread() -> Optional["Capture"]:
    return getattr(_capture_state, "capture", None)


def _lend(ep: "Endpoint", key: tuple, make: Callable[[], list]) -> list:
    capture = _capture_of_thread()
    return make() if capture is None else capture.lend(ep, key, make)


def capturing() -> Optional["Capture"]:
    """The :class:`Capture` this thread is recording a graph of, if any
    (not its warm-up)."""
    capture = _capture_of_thread()
    return capture if capture is not None and capture.phase == "capture" \
        else None


class Capture:
    """The rings' side of one CUDA graph capture of a step that issues
    collectives across processes (``ShardedInference.run``). Every member
    captures the same step at the same call, so their graphs' hops pair
    as their eager hops do.

    * :meth:`warm` around the warm-up run (eager, on the capture stream):
      the arena tensors and leases each endpoint hands out are recorded
      in order, with what was asked (an arena grows here if it must);
    * :meth:`capture` around the capture: each endpoint hands out again,
      in the same order, what its warm-up took, so the capture takes
      nothing from an arena and grows none (cudaMalloc and an exchange of
      handles cannot be captured) and makes no tensor over one; a request
      other than the warm-up's raises. The record holds every lease for
      the graph's life, so no replay writes into memory handed out again.
      Each hop is tallied in :attr:`hops`, each host wait in
      :attr:`host_waits` (a wait inside a capture fails it);
    * :meth:`held` after the capture: the leases go back, when the graph
      dies, on the stream its replays run on;
    * :meth:`replayed` after each replay: the tallied hops added to the
      endpoints' host counts."""

    def __init__(self):
        self.phase: Optional[str] = None
        #: per endpoint: (what was asked, what was handed out), in order,
        #: and how many of them the capture has had again
        self.lent: Dict[Endpoint, List[tuple]] = {}
        self._again: Dict[Endpoint, int] = {}
        self.leases: List[_Lease] = []
        self.hops: Dict[Endpoint, int] = {}
        self.host_waits = 0

    @contextlib.contextmanager
    def _in(self, phase: str):
        previous = _capture_of_thread()
        _capture_state.capture, self.phase = self, phase
        try:
            yield self
        finally:
            _capture_state.capture, self.phase = previous, None

    def warm(self):
        return self._in("warm")

    def capture(self):
        return self._in("capture")

    def lend(self, ep: Endpoint, key: tuple, make: Callable[[], list]
             ) -> list:
        """``make()`` recorded in the warm-up; in the capture, the warm-up's
        result for the same request, in the same order."""
        if self.phase == "warm":
            made = make()
            self.lent.setdefault(ep, []).append((key, made))
            return list(made)
        record = self.lent.get(ep, [])
        i = self._again.get(ep, 0)
        if i >= len(record) or record[i][0] != key:
            raise RuntimeError(
                "ring %s: member %d's CUDA graph capture asks its arena for "
                "%r where its warm-up asked for %r: a capture takes only "
                "what its warm-up took" % (
                    ep.key, ep.member, key,
                    record[i][0] if i < len(record) else None))
        self._again[ep] = i + 1
        return list(record[i][1])

    def held(self, stream) -> None:
        for lease in self.leases:
            lease.stream = stream

    def replayed(self) -> None:
        for ep, hops in self.hops.items():
            ep.epoch += hops


_endpoints: Dict[str, Endpoint] = {}
#: endpoints made for each ring key (a ring closed and made again gets a
#: new name in the store)
_made: Dict[str, int] = {}


def endpoint(ring: Ring) -> Endpoint:
    """This process's endpoint of ``ring`` (made at its first collective,
    with every other member of the ring at once)."""
    from rnb_tpu_torch.parallel import distributed
    key = ring_key(ring)
    ep = _endpoints.get(key)
    if ep is None:
        launch = distributed.launch()
        if launch is None:
            raise RuntimeError("ring %s spans processes but this process "
                               "joined no launch (distributed."
                               "maybe_initialize)" % key)
        _made[key] = _made.get(key, 0) + 1
        ep = Endpoint(ring, "%s#%d" % (key, _made[key]), launch.store)
        _endpoints[key] = ep
    return ep


def close_all() -> None:
    """Close every endpoint, in the order they were made (the same on
    every process); raises the first failure after closing them all."""
    failure = None
    for key in list(_endpoints):
        ep = _endpoints.pop(key)
        try:
            ep.close()
        except Exception as e:  # every endpoint is closed first
            failure = failure or e
    if failure is not None:
        raise failure
