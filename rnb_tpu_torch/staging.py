"""Pinned host staging slots + the pipelined host->device transfer.

Counterpart of ``rnb_tpu/staging.py``. A **staging slot** is a
pre-allocated pinned host tensor of a loader's max batch shape. The
loaders plan each request's rows in a slot when the request is
submitted, and the native decode pool decodes straight into them
(``DecodePool.submit_into``): an emission then ships the rows where the
decoder left them, with no assembly copy. A numpy decode is copied into
its planned rows on the decode thread instead.

Slots are referenced by row range, as in the reference: every planned
request holds one reference on its slot (``add_ref``) until its rows
are shipped or dropped (``release``), and a slot returns to the free
list only when no reference is left. A native ticket keeps its
reference until its decode is waited on, so no slot is reused while a
decoder may still write into it. The transfer is ``copy_`` with
``non_blocking=True`` on a dedicated CUDA stream, confirmed by a CUDA
event before any reference is released.

* :class:`StagingPool` — a bounded set of slots with counted
  backpressure: when no slot is free, ``acquire`` blocks
  (``acquire_waits``) instead of dropping work.
* :class:`TransferWorker` — a dedicated thread that runs transfer jobs,
  so batch N crosses the bus while batch N+1 is decoded and assembled
  (``transfer_async``). A failed job is recorded and re-raised on the
  executor thread; a dead transfer pipeline never hangs the run.

On the CPU platform the "transfer" is a copy into a fresh tensor, so a
recycled slot can never alias a batch still in flight.
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from rnb_tpu_torch import lockwitness, trace


class StagingSlot:
    """One pre-allocated host buffer (pinned when its target is a
    card); ``array`` is a numpy view of the same bytes for the decoder
    to fill. ``refs`` counts the holders of its rows."""

    __slots__ = ("buf", "array", "refs")

    def __init__(self, shape: Tuple[int, ...], pin: bool,
                 dtype: torch.dtype = torch.uint8):
        self.buf = torch.empty(shape, dtype=dtype, pin_memory=pin)
        self.array = self.buf.numpy()
        self.refs = 0


class StagingPool:
    """``num_slots`` staging slots of one shape and dtype (the wire's:
    uint8 planes, int16 coefficient rows) for one target device, plus
    the transfer stream all of their copies run on."""

    GUARDED_BY = {
        "_slots": "_lock",
        "_error": "_lock",
        "num_acquires": "_lock",
        "num_acquire_waits": "_lock",
        "num_transfers": "_lock",
        "num_transfer_bytes": "_lock",
        "num_staged_batches": "_lock",
        "num_copied_batches": "_lock",
        "num_bypassed_batches": "_lock",
    }

    def __init__(self, shape: Tuple[int, ...], num_slots: int,
                 device: torch.device, dtype: torch.dtype = torch.uint8):
        if num_slots < 1:
            raise ValueError("staging needs at least one slot, got %r"
                             % (num_slots,))
        self.device = device
        pin = device.type == "cuda"
        self._slots = [StagingSlot(tuple(shape), pin, dtype)
                       for _ in range(num_slots)]
        self._stream = (torch.cuda.Stream(device=device) if pin else None)
        self._lock = lockwitness.lock("StagingPool._lock")
        self._available = threading.Condition(self._lock)
        self._error: Optional[BaseException] = None
        self.num_acquires = 0
        self.num_acquire_waits = 0
        self.num_transfers = 0
        self.num_transfer_bytes = 0
        #: emissions whose every row the decoder wrote in place
        self.num_staged_batches = 0
        #: emissions holding rows that a host copy placed in the slot
        self.num_copied_batches = 0
        #: emissions that shipped no host bytes (feature-page hits)
        self.num_bypassed_batches = 0

    @property
    def stream(self) -> Optional["torch.cuda.Stream"]:
        """The transfer stream (None off the card)."""
        return self._stream

    def _claim_locked(self) -> Optional[StagingSlot]:
        if self._error is not None:
            raise self._error
        for slot in self._slots:
            if slot.refs == 0:
                slot.refs = 1
                self.num_acquires += 1
                return slot
        return None

    def try_acquire(self) -> Optional[StagingSlot]:
        """A free slot holding one reference (the caller's), or None."""
        with self._lock:
            return self._claim_locked()

    def acquire(self) -> StagingSlot:
        """A free slot holding one reference (the caller's); blocks
        (counted) while every slot is referenced."""
        with self._available:
            slot = self._claim_locked()
            if slot is not None:
                return slot
            self.num_acquire_waits += 1
            with trace.span("staging.acquire_wait"):
                while slot is None:
                    self._available.wait(timeout=0.05)
                    slot = self._claim_locked()
            return slot

    def available(self) -> int:
        """Slots no holder references (the tracer's occupancy counter)."""
        with self._lock:
            return sum(1 for slot in self._slots if slot.refs == 0)

    def add_ref(self, slot: StagingSlot) -> None:
        """One more holder of rows of ``slot``."""
        with self._lock:
            slot.refs += 1

    def release(self, slot: StagingSlot) -> None:
        """A holder is done with its rows; the slot is free at zero."""
        with self._available:
            if slot.refs <= 0:
                raise RuntimeError("staging slot released more often "
                                   "than referenced")
            slot.refs -= 1
            if slot.refs == 0:
                self._available.notify_all()

    def transfer(self, slot: StagingSlot, rows: int) -> torch.Tensor:
        """Copy the slot's leading ``rows`` rows to the pool's device,
        confirm the copy, and release the caller's reference."""
        try:
            return self.transfer_rows(((slot, 0, rows),), rows)
        finally:
            self.release(slot)

    def transfer_rows(self, runs: Sequence[Tuple[StagingSlot, int, int]],
                      shipped: int, zero_tail: bool = False
                      ) -> torch.Tensor:
        """One batch of ``shipped`` rows on the pool's device from row
        runs ``(slot, row0, n)`` of pinned slots, placed one after the
        other from row 0; the rows past them are zeroed on the device
        with ``zero_tail``, else left as the allocator gave them (a
        ragged pool's tail, which no consumer reads). The copies are
        confirmed before this returns; no reference is released. The
        result was allocated on the transfer stream: a consumer on
        another stream calls ``record_stream`` before its last use."""
        first = runs[0][0].buf
        shape = (int(shipped),) + tuple(first.shape[1:])
        nbytes = 0
        with (torch.cuda.stream(self._stream) if self._stream is not None
              else contextlib.nullcontext()):
            dst = torch.empty(shape, dtype=first.dtype, device=self.device)
            row = 0
            for slot, row0, n in runs:
                src = slot.buf[row0:row0 + n]
                dst[row:row + n].copy_(src, non_blocking=True)
                nbytes += src.nbytes
                row += n
            if zero_tail and row < shipped:
                dst[row:].zero_()
            if self._stream is not None:
                done = torch.cuda.Event()
                done.record(self._stream)
        if self._stream is not None:
            done.synchronize()
        with self._lock:
            self.num_transfers += 1
            self.num_transfer_bytes += nbytes
        return dst

    def note_emission(self, copied: bool) -> None:
        """Count a shipped emission: staged (the decoder wrote every row
        in place) or copied (some row was copied in on the host)."""
        with self._lock:
            if copied:
                self.num_copied_batches += 1
            else:
                self.num_staged_batches += 1

    def note_bypassed(self) -> None:
        """Count an emission that acquired no slot and moved no host
        bytes: every row came from the page allocator."""
        with self._lock:
            self.num_bypassed_batches += 1

    def fail(self, exc: BaseException) -> None:
        """Record a transfer-pipeline failure; every later acquire
        re-raises it."""
        with self._available:
            if self._error is None:
                self._error = exc
            self._available.notify_all()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"slots": len(self._slots),
                    "slot_bytes": sum(s.buf.nbytes for s in self._slots),
                    "acquires": self.num_acquires,
                    "acquire_waits": self.num_acquire_waits,
                    "transfers": self.num_transfers,
                    "transfer_bytes": self.num_transfer_bytes,
                    "staged_batches": self.num_staged_batches,
                    "copied_batches": self.num_copied_batches,
                    "bypassed_batches": self.num_bypassed_batches}


class TransferWorker:
    """A single thread running host->device transfer jobs in order.
    Job errors are kept and re-raised on the executor thread through
    :meth:`raise_if_failed`."""

    GUARDED_BY = {
        "_jobs": "_lock",
        "_outstanding": "_lock",
        "_error": "_lock",
        "_closed": "_lock",
    }

    def __init__(self, pool: StagingPool):
        self._jobs: "deque[Callable[[], None]]" = deque()
        self._lock = lockwitness.lock("TransferWorker._lock")
        self._wake = threading.Condition(self._lock)
        self._outstanding = 0
        self._error: Optional[BaseException] = None
        self._pool = pool
        self._closed = False
        self._thread = threading.Thread(target=self._run,
                                        name="rnb-transfer", daemon=True)
        self._thread.start()

    def submit(self, job: Callable[[], None]) -> None:
        with self._wake:
            if self._closed:
                raise RuntimeError("TransferWorker is closed")
            if self._error is not None:
                raise self._error
            self._jobs.append(job)
            self._outstanding += 1
            self._wake.notify_all()

    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding

    def raise_if_failed(self) -> None:
        with self._lock:
            if self._error is not None:
                raise self._error

    def _run(self) -> None:
        while True:
            with self._wake:
                while not self._jobs and not self._closed:
                    self._wake.wait(timeout=0.1)
                if not self._jobs and self._closed:
                    return
                job = self._jobs.popleft()
            try:
                with trace.span("transfer.job"):
                    job()
            except BaseException as exc:  # noqa: BLE001 — re-raised
                with self._wake:
                    if self._error is None:
                        self._error = exc
                self._pool.fail(exc)
            finally:
                with self._wake:
                    self._outstanding -= 1
                    self._wake.notify_all()

    def close(self, timeout: float = 30.0) -> None:
        """Drain the remaining jobs, then stop the thread."""
        with self._wake:
            self._closed = True
            self._wake.notify_all()
        self._thread.join(timeout=timeout)


class PinnedUpload:
    """Host rows to the card through a pinned buffer, ordered on the
    caller's current stream: the executor's upload of a payload that
    arrived as host rows (a netedge DATA frame), before the stage's
    forward replays on the same stream.

    One pinned buffer per shape and dtype, refilled once the copy out of
    it has run (its event). Off the card the rows are handed over as they
    are, on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        #: (shape, dtype) -> [pinned buffer, event of its last copy]
        self._buffers: Dict[tuple, list] = {}
        self.uploads = 0
        self.upload_bytes = 0

    def upload(self, host: torch.Tensor) -> torch.Tensor:
        if self.device.type != "cuda":
            return host
        key = (tuple(host.shape), host.dtype)
        entry = self._buffers.get(key)
        if entry is None:
            entry = [torch.empty(key[0], dtype=host.dtype, pin_memory=True),
                     torch.cuda.Event()]
            self._buffers[key] = entry
        else:
            # the last copy out of this buffer has run
            entry[1].synchronize()
        pinned, done = entry
        pinned.copy_(host)
        stream = torch.cuda.current_stream(self.device)
        dst = torch.empty(key[0], dtype=host.dtype, device=self.device)
        dst.copy_(pinned, non_blocking=True)
        done.record(stream)
        self.uploads += 1
        self.upload_bytes += pinned.nbytes
        return dst
