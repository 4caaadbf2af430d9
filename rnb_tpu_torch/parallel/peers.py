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
  of its own allocation and its handle opens at offset 0), a pair of
  device counters, ``recv`` and ``ack``, and a receive window, sized by
  the caller and grown (by every member at once: a collective
  allocation) when a hop needs more; and an error word on the card,
  reported into a pinned word the host reads.
* It exports them as IPC handles with their byte offsets, exchanges them
  through the launch's store, and opens its peers' handles with the
  lazy peer-access flag. Nothing is opened a hop.
* :meth:`Endpoint.hop` is one hop of the kernel ``rnb_ring_hop``
  (``rnb_tpu_torch/csrc/ring.cu``): a send launch into the successor's
  window and a place launch out of its own, each gated on a counter and
  signalling one, every wait bounded by :data:`wait_cap_s`. Each member
  publishes its window's size with its handle, so a hop that needs more
  than the successor's window raises before it launches; the send
  carries the hop's layout (a digest of its window tiles) and the place
  checks it against its own, so processes whose tables disagree fail
  the hop instead of placing the wrong bytes.
  :meth:`Endpoint.finish` waits for the card and raises where a wait
  gave up or the layouts disagreed.
* :func:`close_all` (from ``distributed.shutdown``): every endpoint
  waits for its card, closes its peers' handles, meets the others at a
  barrier, then frees its own memory.
"""

from __future__ import annotations

import array
import ctypes
import datetime
import pickle
import zlib
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.parallel.mesh import Ring

#: seconds a wait on a peer (a counter on the card, a store read, a
#: barrier, a gloo transfer) may take before the call raises
DEFAULT_WAIT_CAP_S = 60.0
wait_cap_s = DEFAULT_WAIT_CAP_S

#: the counters' allocation: ``recv`` at 0 with the hop's layout beside
#: it at 64 and ``ack`` at 128 (exported), the send and place launches'
#: words of finished blocks at 256 and 384 and the error word at 448
#: (this member's own)
COUNTER_BYTES = 512
RECV, LAYOUT, ACK, SEND_DONE, PLACE_DONE, ERROR = 0, 64, 128, 256, 384, 448
#: the error word's values (``kTimedOut``, ``kLayoutDiffers`` in ring.cu)
TIMED_OUT, LAYOUT_DIFFERS = 1, 2
#: a window grows to a multiple of this (and at least doubles)
WINDOW_QUANTUM = 1 << 20
#: window offsets of a hop's tiles are multiples of this: the kernel's
#: 16-byte vector path
WINDOW_ALIGN = 256

_P, _L = ctypes.c_void_p, ctypes.c_longlong


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
    ``src_pitch``) to ``dst`` (at ``dst_pitch``). In a send tile ``dst``
    is an offset into the successor's window, in a place tile ``src`` one
    into this member's own."""
    src: int
    dst: int
    rows: int
    row_bytes: int
    src_pitch: int
    dst_pitch: int


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


def launch_args(tiles: Sequence[Tile]) -> List[tuple]:
    """The C table arguments of ``rnb_ring_hop`` for ``tiles`` (each an
    entry of one member, shift 0), as few launches as hold them (at
    least one: a launch with no tiles still waits and signals)."""
    return _kernels.ring_table(
        [_kernels.RingTableEntry((t.src,), (t.dst,), (t.src_pitch,),
                                 (t.dst_pitch,), 0, t.rows, t.row_bytes)
         for t in tiles], 1, at_least_one=True)


def layout(tiles: Sequence[Tile], window_side: str) -> int:
    """The digest (never 0) of a hop's window layout: the offset and
    the bytes of each tile in the window (``window_side`` is ``dst`` for
    a send, ``src`` for a place; a tile's rows lie packed there), the
    same on both ends of a hop whose processes built the same table."""
    words = [v for t in tiles
             for v in (getattr(t, window_side), t.rows * t.row_bytes)]
    return zlib.crc32(array.array("q", words).tobytes()) + 1


def ring_key(ring: Ring) -> str:
    """A ring's name in the launch's store: its axis, members and
    processes (every process of the ring makes the same)."""
    return "%s:%s:%s" % (ring.axis_name,
                         ",".join(str(d) for d in ring.devices),
                         ",".join(str(p) for p in ring.processes))


class Endpoint:
    """This process's end of one ring that spans processes, on CUDA:
    its member's counters, error word (``error``, on the card at
    ``counters + ERROR``; ``report_host``/``report_dev``, the pinned word
    it is reported into) and window, and its peers' opened counters and
    windows."""

    def __init__(self, ring: Ring, key: str, store):
        if len(ring.local) != 1:
            raise ValueError("a ring across processes has one member in "
                             "this process, got %d" % len(ring.local))
        self.ring = ring
        self.key = key
        self.store = store
        self.member = ring.local[0]
        self.degree = ring.degree
        self.device = ring.device
        self.lib = _library()
        self.epoch = 0
        self.broken: Optional[str] = None
        self.window = 0
        self.window_bytes = 0
        #: each peer's window: its pointer here and its size
        self.peer_windows: Dict[int, int] = {}
        self.peer_window_bytes: Dict[int, int] = {}
        self.peer_counters: Dict[int, int] = {}
        self._round = 0
        self._closed = False
        index = self._index()
        ptr = _P()
        _call(self.lib, "rnb_peer_alloc", COUNTER_BYTES, index,
              ctypes.byref(ptr))
        self.counters = ptr.value
        host, dev = _P(), _P()
        _call(self.lib, "rnb_error_word_alloc", ctypes.byref(host),
              ctypes.byref(dev))
        self.report_host, self.report_dev = host.value, dev.value
        self.error = self.counters + ERROR
        self.peer_counters = {m: ptr for m, (ptr, _) in self._exchange(
            self.counters, COUNTER_BYTES).items()}

    def _index(self) -> int:
        return self.device.index or 0

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

    # -- the window --------------------------------------------------------

    def reserve(self, nbytes: int) -> None:
        """A window of at least ``nbytes`` on every member. Every member
        asks for the same bytes at the same hop (the same program on
        every process), so every member grows at once: waits for its
        card, closes its peers' old windows, meets them, frees its own,
        and exchanges the new ones."""
        if nbytes <= self.window_bytes:
            return
        size = max(nbytes, 2 * self.window_bytes)
        size = -(-size // WINDOW_QUANTUM) * WINDOW_QUANTUM
        torch.cuda.synchronize(self.device)
        for ptr in self.peer_windows.values():
            _call(self.lib, "rnb_peer_close", _P(ptr), self._index())
        self.peer_windows, self.peer_window_bytes = {}, {}
        self.barrier("grow")
        if self.window:
            _call(self.lib, "rnb_peer_free", _P(self.window), self._index())
            self.window, self.window_bytes = 0, 0
        ptr = _P()
        _call(self.lib, "rnb_peer_alloc", size, self._index(),
              ctypes.byref(ptr))
        self.window, self.window_bytes = ptr.value, size
        opened = self._exchange(self.window, size)
        self.peer_windows = {m: p for m, (p, _) in opened.items()}
        self.peer_window_bytes = {m: b for m, (_, b) in opened.items()}

    # -- the hop -----------------------------------------------------------

    def hop(self, shift: int, local: Sequence[Tile], send: Sequence[Tile],
            place: Sequence[Tile], window_bytes: int) -> None:
        """One hop at ``shift`` on the current stream: ``local`` tiles
        (within this member) and ``send`` tiles (into the successor's
        window) in the send launches, after the successor has placed the
        last hop; then the ``place`` tiles out of this member's window
        once the predecessor's send has landed with the same layout.
        Raises, launching nothing and breaking the ring, where the send
        needs more than the successor's window."""
        if self.broken is not None:
            raise RuntimeError(self.broken)
        self.reserve(window_bytes)
        succ = (self.member + shift) % self.degree
        needed = max((t.dst + t.rows * t.row_bytes for t in send),
                     default=0)
        if needed > self.peer_window_bytes[succ]:
            self.broken = (
                "ring %s: member %d's hop %d sends %d bytes into member "
                "%d's window of %d: the processes' tables disagree (other "
                "shapes); the ring is broken"
                % (self.key, self.member, self.epoch + 1, needed, succ,
                   self.peer_window_bytes[succ]))
            raise ValueError(self.broken)
        epoch = self.epoch + 1
        remote = [t._replace(dst=self.peer_windows[succ] + t.dst)
                  for t in send]
        own = [t._replace(src=self.window + t.src) for t in place]
        self._launch(list(local) + remote,
                     wait=(self.peer_counters[succ] + ACK, epoch - 1),
                     signal=self.peer_counters[succ] + RECV,
                     done=self.counters + SEND_DONE,
                     layout=(layout(send, "dst"),
                             self.peer_counters[succ] + LAYOUT, None))
        self._launch(own, wait=(self.counters + RECV, epoch),
                     signal=self.counters + ACK,
                     done=self.counters + PLACE_DONE,
                     layout=(layout(place, "src"), None,
                             self.counters + LAYOUT))
        self.epoch = epoch

    def _launch(self, tiles, wait, signal, done, layout) -> None:
        """``tiles`` in as few launches of ``rnb_ring_hop`` as hold them:
        the first waits (and checks the layout word it is given), the
        last writes the layout word it is given and signals."""
        chunks = launch_args(tiles)
        cap_ns = int(wait_cap_s * 1e9)
        digest, out, into = layout
        for i, args in enumerate(chunks):
            first, last = i == 0, i == len(chunks) - 1
            _kernels.RING_SHIFT.launch(
                *args, _P(wait[0]) if first else None,
                ctypes.c_ulonglong(wait[1] if first else 0),
                _P(signal) if last else None, _P(done), _P(self.error),
                _P(self.report_dev), cap_ns, ctypes.c_ulonglong(digest),
                _P(out) if last and out else None,
                _P(into) if first and into else None, device=self.device,
                entry=_kernels.RING_HOP_ENTRY)

    def reported(self) -> int:
        """The error word as the card reported it (read with no copy)."""
        return ctypes.c_int.from_address(self.report_host).value

    def finish(self) -> None:
        """Wait for this process's stream, then raise where a wait of the
        collective gave up (a peer that died or stalled past the cap)."""
        torch.cuda.current_stream(self.device).synchronize()
        code = self.reported()
        if code and self.broken is None:
            self.broken = (
                "ring %s: member %d's hop %d: the predecessor's window "
                "holds another layout than this member's table reads (the "
                "processes' tables disagree); the ring is broken"
                % (self.key, self.member, self.epoch)
                if code == LAYOUT_DIFFERS else
                "ring %s: member %d's hop %d %s: a peer died or stalled "
                "past the %.1f s cap; the ring is broken"
                % (self.key, self.member, self.epoch,
                   "timed out" if code == TIMED_OUT else "gave up",
                   wait_cap_s))
        if self.broken is not None:
            raise RuntimeError(self.broken)

    # -- teardown ----------------------------------------------------------

    def close(self) -> None:
        """Wait for the card, close the peers' handles, meet the other
        members, then free this member's memory. Frees even where the
        barrier times out (a dead peer), then raises."""
        if self._closed:
            return
        self._closed = True
        failure = None
        try:
            torch.cuda.synchronize(self.device)
            for ptr in list(self.peer_windows.values()) + list(
                    self.peer_counters.values()):
                _call(self.lib, "rnb_peer_close", _P(ptr), self._index())
            self.peer_windows, self.peer_counters = {}, {}
            self.barrier("close")
        except Exception as e:  # re-raised once the memory is freed
            failure = e
        for ptr in (self.window, self.counters):
            if ptr:
                self.lib.rnb_peer_free(_P(ptr), self._index())
        self.lib.rnb_error_word_free(_P(self.report_host))
        self.window = self.counters = 0
        if failure is not None:
            raise failure


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

