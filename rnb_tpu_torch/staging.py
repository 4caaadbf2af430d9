"""Pinned host staging slots + the pipelined host->device transfer.

Counterpart of ``rnb_tpu/staging.py``. The fusing loader assembles each
fused batch in a **staging slot** — a pre-allocated pinned host tensor
of the loader's max batch shape — and ships the slot's leading rows to
the card. The transfer is ``copy_(non_blocking=True)`` on a dedicated
CUDA stream, confirmed by a CUDA event; a slot goes back to the free
list only after its event has completed, so no copy can ever read a
slot that is being refilled.

* :class:`StagingPool` — a bounded set of slots with counted
  backpressure: when every slot is held by an unconfirmed transfer,
  ``acquire`` blocks (``acquire_waits``) instead of dropping work.
* :class:`TransferWorker` — a dedicated thread that runs transfer jobs,
  so batch N crosses the bus while batch N+1 is decoded and assembled
  (``transfer_async``). A failed job is recorded and re-raised on the
  executor thread; a dead transfer pipeline never hangs the run.

On the CPU platform the "transfer" is a copy into a fresh tensor, so a
recycled slot can never alias a batch still in flight.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, Optional, Tuple

import torch


class StagingSlot:
    """One pre-allocated host buffer (pinned when its target is a
    card); ``array`` is a numpy view of the same bytes for the decoder
    to fill."""

    __slots__ = ("buf", "array", "busy")

    def __init__(self, shape: Tuple[int, ...], pin: bool,
                 dtype: torch.dtype = torch.uint8):
        self.buf = torch.empty(shape, dtype=dtype, pin_memory=pin)
        self.array = self.buf.numpy()
        self.busy = False


class StagingPool:
    """``num_slots`` staging slots of one shape and dtype (the wire's:
    uint8 planes, int16 coefficient rows) for one target device, plus
    the transfer stream all of their copies run on."""

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
        self._lock = threading.Lock()
        self._available = threading.Condition(self._lock)
        self._error: Optional[BaseException] = None
        self.num_acquires = 0
        self.num_acquire_waits = 0
        self.num_transfers = 0
        self.num_transfer_bytes = 0
        #: emissions that shipped no host bytes (feature-page hits)
        self.num_bypassed_batches = 0

    @property
    def stream(self) -> Optional["torch.cuda.Stream"]:
        """The transfer stream (None off the card)."""
        return self._stream

    def acquire(self) -> StagingSlot:
        """A free slot; blocks (counted) while every slot is held by an
        unconfirmed transfer."""
        with self._available:
            waited = False
            while True:
                if self._error is not None:
                    raise self._error
                for slot in self._slots:
                    if not slot.busy:
                        slot.busy = True
                        self.num_acquires += 1
                        self.num_acquire_waits += int(waited)
                        return slot
                waited = True
                self._available.wait(timeout=0.05)

    def release(self, slot: StagingSlot) -> None:
        with self._available:
            slot.busy = False
            self._available.notify_all()

    def transfer(self, slot: StagingSlot, rows: int) -> torch.Tensor:
        """Copy the slot's leading ``rows`` rows to the pool's device,
        confirm the copy, and free the slot. The result was allocated
        on the transfer stream: a consumer on another stream calls
        ``record_stream`` before its last use."""
        src = slot.buf[:rows]
        try:
            if self._stream is None:
                return src.clone()
            with torch.cuda.stream(self._stream):
                dst = torch.empty(src.shape, dtype=src.dtype,
                                  device=self.device)
                dst.copy_(src, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._stream)
            done.synchronize()
            return dst
        finally:
            with self._lock:
                self.num_transfers += 1
                self.num_transfer_bytes += src.nbytes
            self.release(slot)

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
                    "bypassed_batches": self.num_bypassed_batches}


class TransferWorker:
    """A single thread running host->device transfer jobs in order.
    Job errors are kept and re-raised on the executor thread through
    :meth:`raise_if_failed`."""

    def __init__(self, pool: StagingPool):
        self._jobs: "deque[Callable[[], None]]" = deque()
        self._lock = threading.Lock()
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
