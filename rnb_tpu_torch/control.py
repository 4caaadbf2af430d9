"""Run-wide coordination: termination, request counting, exit markers.

Counterpart of the coordination half of ``rnb_tpu/control.py``. Stage
threads talk through bounded ``queue.Queue`` edges carrying
``(payload, non_tensors, TimeCard)`` items; a payload on the same
device is handed over by reference. Each producer instance holds a
:class:`RingCredits` of ``num_shared_tensors`` credits: it takes one
per published payload and the consumer gives it back once it has
taken the payload, which bounds the device memory in flight as the
reference's buffer rings did.
"""

from __future__ import annotations

import enum
import queue
import threading
import time
from typing import Optional, Tuple

#: end-of-stream markers sent on every edge
NUM_EXIT_MARKERS = 10


class TerminationFlag(enum.IntEnum):
    """Job-wide termination reason codes (same values as rnb_tpu)."""

    UNSET = -1
    TARGET_NUM_VIDEOS_REACHED = 0
    FILENAME_QUEUE_FULL = 1
    FRAME_QUEUE_FULL = 2
    INTERNAL_ERROR = 3


class TerminationState:
    """A raise-once job termination flag; the first raise wins."""

    def __init__(self):
        self._value = TerminationFlag.UNSET
        self._lock = threading.Lock()

    @property
    def value(self) -> TerminationFlag:
        return self._value

    def raise_flag(self, code: TerminationFlag) -> None:
        with self._lock:
            if self._value == TerminationFlag.UNSET:
                self._value = TerminationFlag(code)

    @property
    def terminated(self) -> bool:
        return self._value != TerminationFlag.UNSET


class InferenceCounter:
    """Locked global count of completed requests; drives the
    target-reached check."""

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def add(self, n: int) -> Tuple[int, int]:
        """Add n; return (old, new) atomically."""
        with self._lock:
            old = self._value
            self._value = old + n
            return old, self._value


class EdgeTracker:
    """Producer countdown for one queue edge: only the last producer
    to finish sends the exit markers, so markers never overtake a
    slower sibling's items."""

    def __init__(self, num_producers: int, num_markers: int):
        self._remaining = num_producers
        self._lock = threading.Lock()
        self.num_markers = num_markers

    def producer_finished(self) -> bool:
        with self._lock:
            self._remaining -= 1
            return self._remaining == 0


class RingCredits:
    """Backpressure for one producer instance: at most ``num_slots``
    published payloads not yet taken by a consumer."""

    POLL_INTERVAL_S = 0.05

    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError("a ring needs at least one slot")
        self._free = threading.Semaphore(num_slots)

    def acquire(self, termination: TerminationState) -> bool:
        """Take a credit; False if the job died while waiting."""
        while not self._free.acquire(timeout=self.POLL_INTERVAL_S):
            if termination.terminated:
                return False
        return True

    def release(self) -> None:
        self._free.release()


def send_exit_markers(target_queue: "queue.Queue",
                      num_markers: int = NUM_EXIT_MARKERS,
                      termination: Optional[TerminationState] = None,
                      timeout_s: float = 60.0) -> None:
    """Enqueue ``num_markers`` end-of-stream ``None`` markers, retrying
    while the queue is full until the job terminates or the deadline
    passes (then the job aborts instead of hanging its consumers)."""
    deadline = time.monotonic() + timeout_s
    for _ in range(num_markers):
        while True:
            try:
                target_queue.put(None, timeout=0.05)
                break
            except queue.Full:
                if termination is not None and termination.terminated:
                    return
                if time.monotonic() > deadline:
                    print("[WARNING] end-of-stream markers undeliverable "
                          "for %.0fs; aborting" % timeout_s)
                    if termination is not None:
                        termination.raise_flag(
                            TerminationFlag.INTERNAL_ERROR)
                    return
