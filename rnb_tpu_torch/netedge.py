"""The network ingest edge: a crash-tolerant transport in front of step 0.

Counterpart of ``rnb_tpu/netedge.py``. The main process keeps the
client, the local step-0 fallback and every downstream stage; a *peer*
process (``python -m rnb_tpu_torch.netedge --serve``) runs a second copy
of step 0 and serves requests over the length-prefixed, checksummed TCP
frame protocol of :mod:`rnb_tpu_torch.ops.wire`.

Every signal the health machinery consumes is on the wire:

* liveness beats are ``BEAT`` frames every ``beat_ms``;
* the peer's in-flight depth rides the header of every frame;
* ``deadline_s`` rides the REQ header, so expiry shedding fires on
  both sides without decoding the payload;
* the sender reconnects with capped exponential backoff and jitter and
  keeps a bounded, sequence-numbered resend window;
* both sides keep dedup ledgers, so a resend after a lost ack never
  dispatches twice (the peer re-serves its cached response; the main
  side drops responses for settled sequences);
* the receiver is bound to a :class:`~rnb_tpu_torch.health.LaneHealthBoard`
  with one lane (:data:`NET_LANE`): a dead or wedged peer walks it
  healthy -> suspect -> open, new requests drain to the local fallback,
  and every request still terminates exactly once.

A window entry leaves the window only on a terminal event: its DATA
injected downstream, its DISPOSE processed, a receive-boundary deadline
shed, a corrupt-frame dead letter, or a local reroute. Acks only
suppress resends, so ``frames_sent == frames_acked + resent_pending``
holds at teardown by construction (``parse_utils`` checks it).

The peer is a second process on the same card: it builds its step-0
stage on the config's device, on the platform the main process names
(``--platform``; never the CPU unless asked). A DATA frame carries host
rows, so the peer copies each emission's valid rows to the host once
(:func:`rnb_tpu_torch.ops.wire.host_batch`); the receiver injects them
into step 0's out queue as :class:`~rnb_tpu_torch.health.DirectPayload`
items, which the executor uploads through a pinned buffer on its stream
(:class:`rnb_tpu_torch.staging.PinnedUpload`).

A fatal fault stays fatal: a peer whose stage fails to build exits before
it binds, and :func:`spawn_peer` raises, so the run never starts; a peer
that dies of an unclassified error while serving exits with
:data:`PEER_FATAL_RC`, and the sender aborts the run instead of evicting
the lane and serving on locally. A peer killed any other way (the fault
plan's fatal ``net_reset``) is a lost lane: evicted, served locally.

Clocks: ``deadline_s`` stamps are wall clock (``time.time()``), comparable
across processes on one host; the board's staleness math is monotonic and
local to the main process.
"""

from __future__ import annotations

import argparse
import os
import queue
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rnb_tpu_torch import lockwitness
from rnb_tpu_torch.control import TerminationFlag, dispose_requests
from rnb_tpu_torch.faults import (FATAL, TRANSIENT, NetCorruptFrameError,
                                  NetPartialFrameError, NetRefusedError,
                                  NetResetError, NetTimeoutError,
                                  classify_error, fault_reason)
from rnb_tpu_torch.health import DirectPayload, deadline_site, expired
from rnb_tpu_torch.ops import wire

#: the edge's lane on its own LaneHealthBoard: there is one peer
NET_LANE = 0

#: reconnect backoff: exponential from ``backoff_ms``, capped here
BACKOFF_CAP_MS = 2000.0
#: uniform jitter fraction added on top of each capped base delay
JITTER_FRAC = 0.25

#: every blocking wait of the edge polls at this period, so the board
#: keeps evaluating (and the circuit can open) while the peer is wedged
_TICK_S = 0.05

#: peer: exit when connected once, then idle with no connection this long
_PEER_IDLE_S = 60.0
#: peer: dedup ledger size (seq -> cached response), far beyond any legal
#: resend_window, so a resend always finds its cached response
_PEER_LEDGER_MAX = 4096
#: peer exit code of an unclassified error while serving: the sender
#: aborts the run on it (EX_SOFTWARE)
PEER_FATAL_RC = 70
#: seconds the main process waits for a peer to exit after EOS
PEER_EXIT_S = 10.0


def parse_addr(addr: str) -> Tuple[str, int]:
    """``"host:port"`` -> ``(host, port)`` (IPv4/hostname only)."""
    host, sep, port = str(addr).rpartition(":")
    if not sep or not host:
        raise ValueError("netedge address %r is not host:port" % (addr,))
    return host, int(port)


def backoff_schedule_ms(backoff_ms: float, max_retries: int,
                        seed: int) -> List[float]:
    """The seeded reconnect delay schedule of one dial cycle: attempt
    ``i`` sleeps ``min(backoff_ms * 2**i, BACKOFF_CAP_MS)`` plus uniform
    jitter up to ``JITTER_FRAC`` of that base. The same schedule serves
    every cycle (the attempt counter resets after a connect), so a chaos
    run's dial storm replays exactly."""
    rng = np.random.default_rng(int(seed) if seed else 0)
    schedule = []
    for attempt in range(int(max_retries)):
        base = min(float(backoff_ms) * (2.0 ** attempt), BACKOFF_CAP_MS)
        schedule.append(base + float(rng.uniform(0.0, base * JITTER_FRAC)))
    return schedule


class NetEdgeSettings:
    """Validated, defaulted view of the root ``netedge`` config key."""

    __slots__ = ("listen", "connect", "beat_ms", "io_timeout_ms",
                 "max_retries", "backoff_ms", "resend_window", "spawn")

    def __init__(self, listen: Optional[str] = None,
                 connect: Optional[str] = None,
                 beat_ms: float = 200.0,
                 io_timeout_ms: float = 2000.0,
                 max_retries: int = 5,
                 backoff_ms: float = 50.0,
                 resend_window: int = 8,
                 spawn: bool = False):
        if not beat_ms > 0:
            raise ValueError("netedge beat_ms must be > 0")
        if not io_timeout_ms > beat_ms:
            raise ValueError(
                "netedge io_timeout_ms (%g) must be > beat_ms (%g): "
                "a receive timeout shorter than the heartbeat period "
                "would classify a healthy peer as silent"
                % (io_timeout_ms, beat_ms))
        if int(max_retries) < 1:
            raise ValueError("netedge max_retries must be >= 1")
        if backoff_ms < 0:
            raise ValueError("netedge backoff_ms must be >= 0")
        if int(resend_window) < 1:
            raise ValueError("netedge resend_window must be >= 1")
        if connect is None and not spawn:
            raise ValueError(
                "netedge needs 'connect' (host:port of a running "
                "peer) or 'spawn: true' (launch the peer locally)")
        if connect is not None:
            parse_addr(connect)
        if listen is not None:
            parse_addr(listen)
        self.listen = listen
        self.connect = connect
        self.beat_ms = float(beat_ms)
        self.io_timeout_ms = float(io_timeout_ms)
        self.max_retries = int(max_retries)
        self.backoff_ms = float(backoff_ms)
        self.resend_window = int(resend_window)
        self.spawn = bool(spawn)

    @staticmethod
    def from_config(raw: Optional[dict]) -> Optional["NetEdgeSettings"]:
        """Settings from the validated config dict, or None when the key
        is absent or ``enabled`` is false: no edge, no ``Net:`` lines,
        byte-stable logs."""
        if raw is None or not raw.get("enabled", True):
            return None
        return NetEdgeSettings(
            listen=raw.get("listen"),
            connect=raw.get("connect"),
            beat_ms=raw.get("beat_ms", 200.0),
            io_timeout_ms=raw.get("io_timeout_ms", 2000.0),
            max_retries=raw.get("max_retries", 5),
            backoff_ms=raw.get("backoff_ms", 50.0),
            resend_window=raw.get("resend_window", 8),
            spawn=raw.get("spawn", False))


class NetStats:
    """Thread-safe edge counters: the ``Net:``/``Net errors:`` lines, the
    ``net.*`` metrics poll and the ``net_*`` result fields all read one
    :meth:`snapshot`."""

    COUNTERS = ("frames_sent", "frames_acked", "resent_pending",
                "resends", "beats", "reconnects", "remote", "local",
                "dedup_drops", "dup_arrivals", "wire_bytes",
                "frame_bytes", "window_stranded",
                "open_before_timeout", "err_total", "err_refused",
                "err_reset", "err_timeout", "err_partial_frame",
                "err_corrupt")

    _ERR_FIELD = {"net_refused": "err_refused",
                  "net_reset": "err_reset",
                  "net_timeout": "err_timeout",
                  "net_partial_frame": "err_partial_frame",
                  "net_corrupt": "err_corrupt"}

    GUARDED_BY = {
        "_c": "_lock",
        "peer_depth": "_lock",
        "_t_first_open": "_lock",
        "_t_first_timeout": "_lock",
    }

    def __init__(self):
        self._lock = lockwitness.lock("NetStats._lock")
        self._c: Dict[str, int] = {k: 0 for k in self.COUNTERS}
        self.peer_depth = 0.0
        self._t_first_open: Optional[float] = None
        self._t_first_timeout: Optional[float] = None

    def inc(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._c[key] += n

    def err(self, reason: str, n: int = 1) -> None:
        """Count one classified net error (a ``fault_reason`` string)."""
        with self._lock:
            self._c["err_total"] += n
            self._c[self._ERR_FIELD[reason]] += n
            if reason == "net_timeout" and self._t_first_timeout is None:
                self._t_first_timeout = time.monotonic()

    def gauge_depth(self, depth: float) -> None:
        with self._lock:
            self.peer_depth = float(depth)

    def note_open(self) -> None:
        """The dispatcher saw the lane's circuit open (or evicted)."""
        with self._lock:
            if self._t_first_open is None:
                self._t_first_open = time.monotonic()

    def finalize(self, stranded: int) -> None:
        """Teardown: the window's remainder, the unacked remainder and
        whether the circuit opened before the io timeout first fired."""
        with self._lock:
            self._c["window_stranded"] = int(stranded)
            self._c["resent_pending"] = (self._c["frames_sent"]
                                         - self._c["frames_acked"])
            self._c["open_before_timeout"] = int(
                self._t_first_open is not None
                and (self._t_first_timeout is None
                     or self._t_first_open < self._t_first_timeout))

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            snap: Dict[str, object] = dict(self._c)
            snap["peer_depth"] = self.peer_depth
            return snap


class _WindowEntry:
    """One in-flight remote request (window-lock protected)."""

    __slots__ = ("seq", "path", "card", "frame", "acked")

    def __init__(self, seq: int, path, card, frame: bytes):
        self.seq = seq
        self.path = path
        self.card = card
        self.frame = frame   # cached wire bytes, ready to resend
        self.acked = False


class NetEdgeClient:
    """Main-process side of the edge: a dispatcher thread (``netedge-tx``)
    routing filename-queue items remote or local, and a receiver thread
    (``netedge-rx``) turning response frames into step-0 out-queue items.
    Neither joins the pipeline barriers: the edge is a transport, not a
    stage. ``rows_sink``, when given, receives the valid rows of every
    DATA frame whose request id is already a key of it."""

    GUARDED_BY = {
        "_sock": "_send_lock",
        "_window": "_wlock",
        "_seq_next": "_wlock",
        "_finalizing": "_wlock",
        "_pad": "_pad_lock",
    }
    UNGUARDED_OK = {
        "_dial_count": "tx thread is the sole dialer",
        "_ever_connected": "tx-thread confined (dial path only)",
        "_fired": "tx-thread confined (dial path only)",
        "_eos_sent": "tx-thread confined (EOS drain runs on tx)",
        "_evicted": "written only by the tx dial path; other threads' "
                    "bare bool reads are monotone (never un-evicted)",
        "rows_sink": "the caller's dict: the rx thread alone writes it, "
                     "the caller reads it after the run joined",
    }

    def __init__(self, settings: NetEdgeSettings, *, board, stats,
                 fault_plan, fault_stats, deadline_stats, counter,
                 num_videos, termination, filename_queue, local_queue,
                 inject_queue, num_markers, seed: int = 0,
                 peer_proc=None, rows_sink: Optional[dict] = None):
        self.settings = settings
        self.board = board
        self.stats = stats
        self.fault_plan = fault_plan
        self.fault_stats = fault_stats
        self.deadline_stats = deadline_stats
        self.counter = counter
        self.num_videos = num_videos
        self.termination = termination
        self.filename_queue = filename_queue
        self.local_queue = local_queue
        self.inject_queue = inject_queue
        self.num_markers = int(num_markers)
        self.peer_proc = peer_proc
        self.rows_sink = rows_sink
        self._io_s = settings.io_timeout_ms / 1000.0
        self._schedule = backoff_schedule_ms(
            settings.backoff_ms, settings.max_retries, seed)
        self._addr = parse_addr(settings.connect)
        # -- connection (the tx thread is the sole dialer) ----------------
        self._sock: Optional[socket.socket] = None
        self._send_lock = lockwitness.lock("NetEdgeClient._send_lock")
        self._connected = threading.Event()
        self._ever_connected = False
        self._dial_count = 0
        self._fired: set = set()   # (fault_idx, id) net-fault ledger
        self._evicted = False
        #: EOS shipped: the peer closing its end after it is the
        #: protocol's goodbye, not a net_reset to count
        self._eos_sent = False
        # -- resend window ------------------------------------------------
        self._wlock = lockwitness.lock("NetEdgeClient._wlock")
        self._window: "OrderedDict[int, _WindowEntry]" = OrderedDict()
        self._seq_next = 1
        self._resend_due = threading.Event()
        #: entries popped by the receiver but not yet settled: the EOS
        #: drain must not release end-of-stream markers while an
        #: injection is mid-flight (the pop comes first, for dedup)
        self._finalizing = 0
        # -- the receiver's pad count: remote cards carry the peer
        # loader's pad_rows stamps, but the peer's PadCounter dies with
        # the peer, so the receiver counts shipped emissions here and the
        # launcher appends it to the job's pad sink
        self._pad_lock = lockwitness.lock("NetEdgeClient._pad_lock")
        self._pad = {"pad_rows": 0, "total_rows": 0, "emissions": 0}
        self._stop = threading.Event()
        self._tx = threading.Thread(target=self._tx_loop,
                                    name="netedge-tx", daemon=True)
        self._rx = threading.Thread(target=self._rx_loop,
                                    name="netedge-rx", daemon=True)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._rx.start()
        self._tx.start()

    @property
    def eos_sent(self) -> bool:
        """The clean goodbye went out: the peer exits by itself."""
        return self._eos_sent

    def stop(self, timeout_s: float = 30.0) -> None:
        """Join both threads (the tx thread ends itself after the EOS
        drain) and finalize the teardown counters. Safe to repeat, and
        before :meth:`start`."""
        if self._tx.ident is not None:
            self._tx.join(timeout=timeout_s)
        self._stop.set()
        self._close_sock()
        if self._rx.ident is not None:
            self._rx.join(timeout=5.0)
        with self._wlock:
            stranded = len(self._window)
        self.stats.finalize(stranded)

    def pad_snapshot(self) -> Dict[str, int]:
        with self._pad_lock:
            return dict(self._pad)

    # -- connection management (tx thread only) -----------------------------

    def _close_sock(self) -> None:
        with self._send_lock:
            sock, self._sock = self._sock, None
            self._connected.clear()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _mark_dead(self, sock) -> None:
        """The receiver saw the connection die; the dispatcher redials."""
        with self._send_lock:
            if self._sock is sock:
                self._sock = None
                self._connected.clear()
        try:
            sock.close()
        except OSError:
            pass

    def _peer_failed(self, wait_s: float = 0.0) -> bool:
        """Did the spawned peer die of an unclassified error? Then the
        run aborts: a fatal fault is never served on locally."""
        if self.peer_proc is None:
            return False
        try:
            rc = self.peer_proc.wait(timeout=wait_s) if wait_s > 0 \
                else self.peer_proc.poll()
        except subprocess.TimeoutExpired:
            return False
        if rc != PEER_FATAL_RC:
            return False
        print("[rnb-tpu-torch] netedge peer died of an unclassified error "
              "(exit %d): aborting the run" % rc, file=sys.stderr)
        self.termination.raise_flag(TerminationFlag.INTERNAL_ERROR)
        return True

    def _dial_once(self) -> socket.socket:
        """One dial attempt; the fault plan's ``net_refused`` draws come
        first (the dial counter as the request id)."""
        self._dial_count += 1
        if self.fault_plan is not None:
            hit = self.fault_plan.net_fault("net_refused", self._dial_count)
            if hit is not None:
                key = (hit[0], self._dial_count)
                if key not in self._fired:
                    self._fired.add(key)
                    raise NetRefusedError(
                        "injected dial refusal (fault %d, dial %d)"
                        % (hit[0], self._dial_count))
        try:
            sock = socket.create_connection(self._addr, timeout=self._io_s)
        except Exception as exc:  # noqa: BLE001 - classified below
            net = wire.classify_io_error(exc)
            if net is None and isinstance(exc, OSError):
                # dialing a dead host surfaces as assorted OSErrors
                # (EHOSTUNREACH, ENETUNREACH...): all "refused" here
                net = NetRefusedError(str(exc))
            if net is not None:
                raise net from exc
            raise
        sock.settimeout(self._io_s)
        return sock

    def _ensure_connected(self) -> bool:
        """A live connection or bust: dial on the seeded backoff schedule;
        an exhausted cycle (``max_retries`` failed dials) evicts the lane
        and reroutes the whole window locally, unless the peer died of an
        unclassified error, which aborts the run."""
        if self._connected.is_set():
            return True
        if self._evicted:
            return False
        last_reason = "net_refused"
        for attempt in range(self.settings.max_retries):
            if self._stop.is_set() or self._aborted() \
                    or self._peer_failed():
                return False
            try:
                sock = self._dial_once()
            except (NetRefusedError, NetResetError,
                    NetTimeoutError) as exc:
                last_reason = fault_reason(exc)
                self.stats.err(last_reason)
                if attempt < len(self._schedule):
                    self._sleep_ticking(self._schedule[attempt] / 1000.0)
                continue
            with self._send_lock:
                self._sock = sock
                self._connected.set()
            if self._ever_connected:
                self.stats.inc("reconnects")
            self._ever_connected = True
            self._resend_all()
            return True
        if self._peer_failed(wait_s=self._io_s):
            return False
        self._evict("netedge peer unreachable (%s after %d dials)"
                    % (last_reason, self.settings.max_retries))
        return False

    def _evict(self, reason: str) -> None:
        self._evicted = True
        self.board.evict(NET_LANE, reason)
        self.stats.note_open()   # evicted is as open as it gets
        self._close_sock()
        self._reroute_window()

    # -- resend window --------------------------------------------------------

    def _resend_all(self) -> None:
        """After a reconnect: resend every non-terminal entry in sequence
        order. The peer's ledger re-acks and re-serves the processed
        ones; the rest were lost and enter now."""
        with self._wlock:
            frames = [e.frame for e in self._window.values()]
        for frame in frames:
            if not self._send_raw(frame):
                return
            self.stats.inc("resends")

    def _maybe_resend(self) -> None:
        """Receive-timeout recovery: nothing heard for a whole io
        timeout, so nudge the oldest unacked entry (an ack lost to a
        reset would otherwise strand it until a reconnect)."""
        if not self._resend_due.is_set():
            return
        self._resend_due.clear()
        if not self._connected.is_set():
            return
        with self._wlock:
            frame = next((e.frame for e in self._window.values()
                          if not e.acked), None)
        if frame is not None and self._send_raw(frame):
            self.stats.inc("resends")

    def _reroute_window(self) -> None:
        """Move every non-terminal window entry onto the local fallback,
        each popped atomically, so a response racing in for it hits the
        dedup ledger instead of dispatching twice."""
        while True:
            with self._wlock:
                if not self._window:
                    return
                _, entry = self._window.popitem(last=False)
            card = entry.card
            card.redispatched = getattr(card, "redispatched", 0) + 1
            self.board.note_redispatch(NET_LANE)
            self.board.note_settle(NET_LANE)
            self.stats.inc("local")
            self._put_local((None, entry.path, card, None))

    # -- dispatcher (netedge-tx) ----------------------------------------------

    def _aborted(self) -> bool:
        """Abnormal termination only: a reached target keeps the edge
        draining, so requests already made still terminate."""
        return (self.termination.terminated
                and int(self.termination.value) != 0)

    def _tick(self) -> None:
        """The idle path's health tick: evaluate the board's clock-driven
        transitions (an empty consult claims no probe) and note the first
        open. ``board.beat()`` would be wrong here: it refreshes the
        last beat and hides the staleness this tick lets the board see."""
        self.board.route_filter(())
        if self.board.state(NET_LANE) in ("open", "evicted"):
            self.stats.note_open()

    def _sleep_ticking(self, seconds: float) -> None:
        deadline = time.monotonic() + seconds
        while not self._stop.is_set() and not self._aborted():
            self._tick()
            left = deadline - time.monotonic()
            if left <= 0:
                return
            time.sleep(min(_TICK_S, left))

    def _put_local(self, item) -> None:
        while not self._stop.is_set():
            try:
                self.local_queue.put(item, timeout=_TICK_S)
                return
            except queue.Full:
                if self._aborted():
                    return
                self._tick()

    def _route_remote(self) -> bool:
        """Cheap pre-filter of the next dispatch: evaluate the board and
        rule out an open or evicted lane. It claims nothing:
        ``consult_and_route`` in :meth:`_send_request` is the one routing
        arbiter (it claims a half-open probe and accounts the route
        atomically)."""
        if self._evicted:
            return False
        self.board.route_filter(())   # pure evaluation tick
        state = self.board.state(NET_LANE)
        if state in ("open", "evicted"):
            self.stats.note_open()
            return False
        return state in ("healthy", "suspect", "half_open")

    def _send_raw(self, frame: bytes) -> bool:
        with self._send_lock:
            sock = self._sock
            if sock is None:
                return False
            try:
                wire.send_frame(sock, frame)
            except (NetResetError, NetPartialFrameError,
                    NetTimeoutError) as exc:
                if not self._eos_sent:
                    self.stats.err(fault_reason(exc))
                self._sock = None
                self._connected.clear()
                try:
                    sock.close()
                except OSError:
                    pass
                return False
        self.stats.inc("wire_bytes", len(frame))
        return True

    def _send_request(self, path, card) -> bool:
        """Own this dispatch remotely: window slot, sequence number, REQ
        frame. True: the window owns it now (even if the send failed, a
        reconnect resends it); False: route it locally instead."""
        if not self._ensure_connected():
            return False
        # block for a window slot, re-consulting the route, so a wedged
        # peer (full window, circuit opening) releases new arrivals to
        # the local path instead of convoying them behind it
        while True:
            with self._wlock:
                if len(self._window) < self.settings.resend_window:
                    # the route and the slot are taken under one window
                    # lock hold, and the entry enters the window only on
                    # a claimed route, so a reconnect's _resend_all never
                    # ships an entry whose route was refused
                    if not self.board.consult_and_route(NET_LANE):
                        return False
                    seq = self._seq_next
                    self._seq_next += 1
                    frame = wire.encode_frame(
                        wire.REQ, wire.encode_req(path, card), seq=seq,
                        deadline=float(getattr(card, "deadline_s", 0.0)
                                       or 0.0),
                        depth=len(self._window))
                    self._window[seq] = _WindowEntry(seq, path, card, frame)
                    break
            if self._stop.is_set() or self._aborted():
                return False
            self._tick()
            self._maybe_resend()
            if not self._connected.is_set() \
                    and not self._ensure_connected():
                return False
            if self.board.state(NET_LANE) not in ("healthy", "suspect",
                                                  "half_open"):
                return False
            time.sleep(_TICK_S)
        self.board.note_enqueue(NET_LANE)
        self.stats.inc("frames_sent")
        self.stats.inc("remote")
        self._send_raw(frame)   # a failure is fine: the reconnect resends
        return True

    def _tx_loop(self) -> None:
        markers = 0
        while not self._stop.is_set():
            if self._aborted():
                return
            try:
                item = self.filename_queue.get(timeout=_TICK_S)
            except queue.Empty:
                self._tick()
                self._maybe_resend()
                if not self._connected.is_set() and not self._evicted \
                        and self._window_nonempty():
                    self._ensure_connected()
                continue
            if item is None:
                markers += 1
                if markers >= self.num_markers:
                    break
                continue
            _, path, card, _ = item
            if self._route_remote() and self._send_request(path, card):
                continue
            self.stats.inc("local")
            self._put_local((None, path, card, None))
        self._drain_window()
        # the markers only after the drain: every remote injection into
        # step 0's out queues precedes the end of the stream downstream,
        # and every reroute precedes the markers locally
        for _ in range(markers):
            self._put_local(None)
        self._send_eos()

    def _window_nonempty(self) -> bool:
        with self._wlock:
            return bool(self._window) or self._finalizing > 0

    def _drain_window(self) -> None:
        """Wait (bounded) for the in-flight responses, then reroute the
        rest locally: nothing strands."""
        budget = (self._io_s * (self.settings.max_retries + 2)
                  + sum(self._schedule) / 1000.0 + 1.0)
        deadline = time.monotonic() + budget
        while self._window_nonempty() and not self._evicted \
                and not self._aborted() \
                and time.monotonic() < deadline:
            self._tick()
            self._maybe_resend()
            if not self._connected.is_set():
                self._ensure_connected()
            time.sleep(_TICK_S)
        self._reroute_window()

    def _send_eos(self) -> None:
        self._eos_sent = True
        if self._connected.is_set():
            self._send_raw(wire.encode_frame(wire.EOS))

    # -- receiver (netedge-rx) --------------------------------------------------

    def _rx_loop(self) -> None:
        while not self._stop.is_set():
            # the tx thread swaps _sock on every reconnect: read it under
            # the lock that guards the swap
            with self._send_lock:
                sock = self._sock
            if sock is None:
                if self._evicted:
                    return
                self._connected.wait(_TICK_S)
                continue
            try:
                (ftype, _flags, depth, seq, _deadline,
                 payload) = wire.read_frame(sock)
            except NetTimeoutError:
                self.stats.err("net_timeout")
                self._resend_due.set()
                continue
            except NetCorruptFrameError as exc:
                self.stats.err("net_corrupt")
                self._dead_letter(getattr(exc, "seq", 0))
                continue
            except (NetResetError, NetPartialFrameError) as exc:
                if not self._stop.is_set() and not self._eos_sent:
                    self.stats.err(fault_reason(exc))
                self._mark_dead(sock)
                continue
            except OSError:
                self._mark_dead(sock)
                continue
            self.stats.inc("wire_bytes", wire.HEADER_SIZE + len(payload))
            self.board.beat(NET_LANE)
            self.stats.gauge_depth(depth)
            if ftype == wire.BEAT:
                self.stats.inc("beats")
            elif ftype == wire.ACK:
                self._on_ack(seq)
            elif ftype == wire.DATA:
                self._on_data(seq, payload)
            elif ftype == wire.DISPOSE:
                self._on_dispose(seq, payload)

    def _on_ack(self, seq: int) -> None:
        with self._wlock:
            entry = self._window.get(seq)
            if entry is not None and not entry.acked:
                entry.acked = True
                self.stats.inc("frames_acked")

    def _pop_entry(self, seq: int) -> Optional[_WindowEntry]:
        """The terminal-event pop, or the dedup verdict: a response for a
        sequence no longer in the window already terminated (a resend's
        twin), and is counted as a duplicate arrival."""
        with self._wlock:
            entry = self._window.pop(seq, None)
            if entry is not None:
                self._finalizing += 1
        if entry is None:
            self.stats.inc("dup_arrivals")
        return entry

    def _finalized(self) -> None:
        with self._wlock:
            self._finalizing -= 1

    def _on_data(self, seq: int, payload: bytes) -> None:
        entry = self._pop_entry(seq)
        if entry is None:
            # the drop (parse_utils: dedup_drops == dup_arrivals)
            self.stats.inc("dedup_drops")
            return
        batch, non_tensors, card, row_bytes = wire.decode_data(payload)
        self.stats.inc("frame_bytes", row_bytes)
        shipped = int(batch.data.shape[0])
        with self._pad_lock:
            self._pad["pad_rows"] += shipped - int(batch.valid)
            self._pad["total_rows"] += shipped
            self._pad["emissions"] += 1
        if self.rows_sink is not None and card.id in self.rows_sink:
            self.rows_sink[card.id] = batch.data[:int(batch.valid)]
        if self.deadline_stats is not None and expired(card):
            site = deadline_site("netedge")
            card.mark_shed(site)
            self.fault_stats.record_shed(site)
            self.deadline_stats.record(site)
            dispose_requests(self.counter, self.num_videos, self.termination)
        else:
            self._inject((DirectPayload((batch,)), non_tensors, card, None))
        self.board.note_settle(NET_LANE)
        self._finalized()

    def _on_dispose(self, seq: int, payload: bytes) -> None:
        entry = self._pop_entry(seq)
        if entry is None:
            self.stats.inc("dedup_drops")
            return
        outcome, reason, card = wire.decode_dispose(payload)
        if outcome == "failed":
            self.fault_stats.record_failure([card.id], 0, reason)
            self.board.note_failure(NET_LANE)
        else:
            self.fault_stats.record_shed(reason)
            if self.deadline_stats is not None \
                    and reason.endswith(":deadline_expired"):
                self.deadline_stats.record(reason)
        dispose_requests(self.counter, self.num_videos, self.termination)
        self.board.note_settle(NET_LANE)
        self._finalized()

    def _dead_letter(self, seq: int) -> None:
        """A corrupt frame read in full: framing survived, the request it
        carried did not (permanent: one dead letter, no retry)."""
        with self._wlock:
            entry = self._window.pop(seq, None)
            if entry is not None:
                self._finalizing += 1
        if entry is None:
            return
        card = entry.card
        card.mark_failed("net_corrupt")
        self.fault_stats.record_failure([card.id], 0, "net_corrupt")
        self.board.note_failure(NET_LANE)
        self.board.note_settle(NET_LANE)
        dispose_requests(self.counter, self.num_videos, self.termination)
        self._finalized()

    def _inject(self, item) -> None:
        while not self._stop.is_set():
            try:
                self.inject_queue.put(item, timeout=_TICK_S)
                return
            except queue.Full:
                if self.termination.terminated:
                    return


# -- the peer process -----------------------------------------------------------

class _PeerConnGone(Exception):
    """Internal: this connection is over; back to accept()."""


class NetEdgePeer:
    """The ingest peer: step 0 of the same config, served over the wire.
    One connection at a time (the edge has one sender); a beat thread
    keeps liveness flowing while the stage runs."""

    GUARDED_BY = {"_conn": "_send_lock"}
    UNGUARDED_OK = {
        "_ledger": "serve-thread confined",
        "_fired": "serve-thread confined",
        "_depth": "written by the serve thread; the beat thread's bare "
                  "int read is a depth gauge",
        "_wedge_until": "written by the serve thread; the beat thread "
                        "reads a float gate (at worst one extra beat)",
        "model": "published by build_model before the listener binds",
        "served": "serve-thread confined",
    }

    def __init__(self, config, listen: str, seed: int = 0):
        from rnb_tpu_torch.faults import FaultPlan
        self.config = config
        self.listen_addr = parse_addr(listen)
        self.step = config.steps[0]
        self.settings = (NetEdgeSettings.from_config(config.netedge)
                         or NetEdgeSettings(connect="127.0.0.1:1"))
        self._io_s = self.settings.io_timeout_ms / 1000.0
        self.plan = FaultPlan.resolve(config.fault_plan)
        self.device = self.step.groups[0].devices[0]
        self._fired: set = set()
        self._ledger: "OrderedDict[int, tuple]" = OrderedDict()
        self._depth = 0
        self._wedge_until = 0.0
        self._send_lock = lockwitness.lock("NetEdgePeer._send_lock")
        self._conn: Optional[socket.socket] = None
        self._beat_stop = threading.Event()
        self.model = None
        self.served = 0

    def build_model(self) -> None:
        """Build (and warm up) the stage BEFORE binding the listener, so
        a bound port means ready to serve."""
        from rnb_tpu_torch.utils.class_utils import load_class
        model_class = load_class(self.step.model)
        self.model = model_class(self.device,
                                 **self.step.kwargs_for_group(0))

    # -- framing helpers ------------------------------------------------------

    def _send(self, frame: bytes) -> None:
        with self._send_lock:
            conn = self._conn
            if conn is None:
                raise _PeerConnGone()
            try:
                wire.send_frame(conn, frame)
            except (NetResetError, NetPartialFrameError,
                    NetTimeoutError) as exc:
                raise _PeerConnGone() from exc

    def _beat_loop(self) -> None:
        period = self.settings.beat_ms / 1000.0
        while not self._beat_stop.wait(period):
            if time.monotonic() < self._wedge_until:
                continue   # a wedged peer is silent: that is the point
            try:
                self._send(wire.encode_frame(wire.BEAT, depth=self._depth))
            except _PeerConnGone:
                return

    # -- request serving ------------------------------------------------------

    def _net_hit(self, kind: str, rid: int):
        """One-shot fault draw: re-matches on resends (the plan is
        stateless) but fires once per (fault, request)."""
        if self.plan is None:
            return None
        hit = self.plan.net_fault(kind, rid)
        if hit is None:
            return None
        key = (hit[0], rid)
        if key in self._fired:
            return None
        self._fired.add(key)
        return hit[1]

    def _run_model(self, path, card):
        """The executor's containment, for one request, by the executor's
        classification (:func:`~rnb_tpu_torch.faults.classify_error`):
        transient errors retried within the step's budget, permanent ones
        dead-lettered. Anything unclassified propagates: the peer exits
        with PEER_FATAL_RC and the sender aborts the run. (The
        reference's peer catches the two base classes only, so an
        OSError there kills the peer.)"""
        card.add_device(self.device.label)
        card.record("runner%d_start" % 0)
        attempt = 0
        while True:
            card.record("inference%d_start" % 0)
            try:
                tensors, non_tensors, out_card = self.model(None, path, card)
                break
            except Exception as exc:
                kind = classify_error(exc)
                if kind is FATAL:
                    raise
                if kind is TRANSIENT and attempt < self.step.max_retries:
                    attempt += 1
                    time.sleep(self.step.retry_backoff_ms / 1000.0)
                    continue
                card.mark_failed(fault_reason(exc))
                return None, fault_reason(exc)
        if tensors is None or len(tensors) != 1:
            out_card.mark_failed("net_bad_emission")
            return None, "net_bad_emission"
        batch = tensors[0]
        if batch.data.is_cuda:
            # the honest finish stamp, as the executor's device sync
            torch.cuda.current_stream(batch.data.device).synchronize()
        out_card.record("inference%d_finish" % 0)
        return (batch, non_tensors, out_card), None

    def _serve_req(self, seq: int, deadline: float, payload: bytes) -> None:
        if seq in self._ledger:
            # a resend after a lost ack re-serves the cached outcome,
            # never a second stage call
            ack, response = self._ledger[seq]
            self._send(ack)
            self._send(response)
            return
        path, card = wire.decode_req(payload)
        rid = int(card.id)
        hit = self._net_hit("net_reset", rid)
        if hit is not None:
            if hit.get("fatal"):
                os._exit(1)   # the chaos peer kill: no goodbye
            with self._send_lock:
                conn, self._conn = self._conn, None
            if conn is not None:
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                struct.pack("ii", 1, 0))   # RST, not FIN
                conn.close()
            raise _PeerConnGone()
        self._depth += 1
        ack = wire.encode_frame(wire.ACK, seq=seq, depth=self._depth)
        self._send(ack)
        hit = self._net_hit("net_timeout", rid)
        if hit is not None:
            # the wedge: acked, then silent (beats pause too)
            stall_s = float(hit.get("ms", 0.0)) / 1000.0
            self._wedge_until = time.monotonic() + stall_s
            time.sleep(stall_s)
        if deadline > 0 and time.time() > deadline:
            site = deadline_site("netedge")
            card.mark_shed(site)
            response = wire.encode_frame(
                wire.DISPOSE, wire.encode_dispose("shed", site, card),
                seq=seq, depth=self._depth)
        else:
            served, reason = self._run_model(path, card)
            if served is None:
                response = wire.encode_frame(
                    wire.DISPOSE, wire.encode_dispose("failed", reason, card),
                    seq=seq, depth=self._depth)
            else:
                batch, non_tensors, out_card = served
                # the emission's one device-to-host copy
                response = wire.encode_frame(
                    wire.DATA, wire.encode_data(wire.host_batch(batch),
                                                non_tensors, out_card),
                    seq=seq, depth=self._depth)
                self.served += 1
        self._depth -= 1
        self._ledger[seq] = (ack, response)
        while len(self._ledger) > _PEER_LEDGER_MAX:
            self._ledger.popitem(last=False)
        if self._net_hit("net_corrupt", rid) is not None:
            # flip one payload byte AFTER the crc was computed
            corrupt = bytearray(response)
            corrupt[-1] ^= 0xff
            self._send(bytes(corrupt))
            return
        if self._net_hit("net_partial_frame", rid) is not None:
            half = response[:max(1, len(response) // 2)]
            self._send(half)
            with self._send_lock:
                conn, self._conn = self._conn, None
            if conn is not None:
                conn.close()
            raise _PeerConnGone()
        self._send(response)

    # -- accept loop ----------------------------------------------------------

    def serve_forever(self, port_file: Optional[str] = None,
                      parent_pid: Optional[int] = None) -> int:
        """Serve connections until EOS (0), or until orphaned (3): the
        main process ``parent_pid`` is gone, or it has not dialed again
        for ``_PEER_IDLE_S`` after a connection died."""
        lsock = socket.create_server(self.listen_addr)
        lsock.settimeout(1.0)
        port = lsock.getsockname()[1]
        if port_file:
            tmp = port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write("%d\n" % port)
            os.replace(tmp, port_file)   # atomic: readers never see ""
        served_any = False
        idle_since = time.monotonic()
        try:
            while True:
                try:
                    conn, _ = lsock.accept()
                except socket.timeout:
                    if (parent_pid is not None
                            and os.getppid() != parent_pid) or (
                            served_any and time.monotonic() - idle_since
                            > _PEER_IDLE_S):
                        return 3
                    continue
                served_any = True
                conn.settimeout(self._io_s)
                if self._serve_conn(conn):
                    return 0       # EOS: clean end of stream
                idle_since = time.monotonic()
        finally:
            lsock.close()

    def _serve_conn(self, conn) -> bool:
        """One connection until EOS (True) or until it dies (False)."""
        # published under the send lock: a previous connection's beat
        # thread may still be sending through _send
        with self._send_lock:
            self._conn = conn
        self._beat_stop.clear()
        beat = threading.Thread(target=self._beat_loop,
                                name="netedge-beat", daemon=True)
        beat.start()
        try:
            while True:
                try:
                    (ftype, _flags, _depth, seq, deadline,
                     payload) = wire.read_frame(conn)
                except NetTimeoutError:
                    continue   # an idle sender; beats still flow
                except (NetResetError, NetPartialFrameError,
                        NetCorruptFrameError):
                    return False
                if ftype == wire.EOS:
                    return True
                if ftype == wire.REQ:
                    try:
                        self._serve_req(seq, deadline, payload)
                    except _PeerConnGone:
                        return False
        finally:
            self._beat_stop.set()
            beat.join(timeout=2.0)
            with self._send_lock:
                conn, self._conn = self._conn, None
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass

    def memory_line(self) -> str:
        """The peer's own device memory: a second CUDA context on the
        main process's card."""
        if self.device.resolve().type != "cuda":
            return "netedge peer: served %d request(s) on the cpu" \
                % self.served
        dev = self.device.resolve()
        return ("netedge peer: served %d request(s) on %s; memory "
                "allocated %d B, peak %d B, reserved %d B"
                % (self.served, dev, torch.cuda.memory_allocated(dev),
                   torch.cuda.max_memory_allocated(dev),
                   torch.cuda.memory_reserved(dev)))


def spawn_peer(config_path: str, settings: NetEdgeSettings,
               platform: str, seed: int = 0, timeout_s: float = 600.0):
    """Launch the ingest peer as a second process (``subprocess``, never a
    fork: the main process may hold a CUDA context) on ``platform``, the
    same config file the main process runs, and wait for its bound port.
    Returns ``(proc, "host:port")``; the caller owns its termination. A
    peer that exits before binding (its stage failed to build, the card
    is out of reach) raises here: the run never starts."""
    listen = settings.listen or "127.0.0.1:0"
    host, _ = parse_addr(listen)
    tmpdir = tempfile.mkdtemp(prefix="rnb-netedge-")
    port_file = os.path.join(tmpdir, "port")
    cmd = [sys.executable, "-m", "rnb_tpu_torch.netedge", "--serve",
           "--config", config_path, "--listen", listen,
           "--port-file", port_file, "--seed", str(int(seed)),
           "--platform", platform, "--parent-pid", str(os.getpid())]
    env = dict(os.environ)
    # the peer imports this package and the config's stage classes from a
    # fresh interpreter; it inherits RNB_FAULT_PLAN, so both sides
    # resolve the same fault plan
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(cmd, env=env)
    try:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    "netedge peer exited rc=%d before binding its port"
                    % proc.returncode)
            if os.path.exists(port_file):
                with open(port_file) as f:
                    port = int(f.read().strip())
                return proc, "%s:%d" % (host, port)
            time.sleep(0.05)
        raise RuntimeError("netedge peer did not bind within %.0fs"
                           % timeout_s)
    except BaseException:
        stop_peer(proc, wait_s=0.0)
        raise
    finally:
        for name in ("port", "port.tmp"):
            try:
                os.remove(os.path.join(tmpdir, name))
            except OSError:
                pass
        os.rmdir(tmpdir)


def stop_peer(proc, wait_s: float = PEER_EXIT_S) -> int:
    """End a spawned peer: wait ``wait_s`` for its own exit (after EOS),
    then terminate, then kill. Returns its exit code."""
    try:
        return proc.wait(timeout=wait_s)
    except subprocess.TimeoutExpired:
        pass
    proc.terminate()
    try:
        return proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m rnb_tpu_torch.netedge",
        description="The ingest peer: serve step 0 of a pipeline config "
                    "over the netedge wire protocol.")
    parser.add_argument("--serve", action="store_true", required=True,
                        help="run the ingest peer (the only mode)")
    parser.add_argument("--config", required=True,
                        help="pipeline config JSON (the file the main "
                             "process runs)")
    parser.add_argument("--listen", default="127.0.0.1:0",
                        help="host:port to bind (port 0: ephemeral)")
    parser.add_argument("--port-file", default=None,
                        help="write the bound port here once serving")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--platform", choices=["cuda", "cpu"],
                        default="cuda")
    parser.add_argument("--parent-pid", type=int, default=None,
                        help="exit once this process is no longer the "
                             "parent (the main process died)")
    args = parser.parse_args(argv)
    from rnb_tpu_torch.config import load_config
    config = load_config(args.config, args.platform)
    peer = NetEdgePeer(config, args.listen, seed=args.seed)
    peer.build_model()
    try:
        rc = peer.serve_forever(port_file=args.port_file,
                                parent_pid=args.parent_pid)
    except Exception:
        traceback.print_exc()
        return PEER_FATAL_RC
    print("[rnb-tpu-torch] %s" % peer.memory_line(), file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
