"""Run-wide coordination: termination, request counting, exit markers.

Counterpart of the coordination half of ``rnb_tpu/control.py``. Stage
threads talk through bounded ``queue.Queue`` edges carrying
``(payload, non_tensors, TimeCard)`` items; a payload on the same
device is handed over by reference. Each producer instance holds a
:class:`RingCredits` of ``num_shared_tensors`` credits: it takes one
per published payload and the consumer gives it back once it has
taken the payload, which bounds the device memory in flight as the
reference's buffer rings did.

:class:`FaultStats` is the job-wide ledger of the containment layer
(:mod:`rnb_tpu_torch.runner`): dead letters with their reasons, sheds per
site, transient retries and abort-policy queue overflows.
:func:`dispose_requests` counts a dead letter or a shed toward the run
target, so a run whose last requests failed or were shed still ends.
"""

from __future__ import annotations

import enum
import math
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

from rnb_tpu_torch import metrics

#: end-of-stream markers sent on every edge
NUM_EXIT_MARKERS = 10


def get_segmented_shapes(shapes: Tuple[Tuple[int, ...], ...],
                         num_segments: int) -> Tuple[Tuple[int, ...], ...]:
    """Shrink per-output max shapes to one segment's worth of rows
    (the reference's ``get_segmented_shapes``): a step with
    ``num_segments=k`` splits each output batch row-wise into k segments,
    so downstream stages only ever see ``ceil(rows/k)`` rows."""
    if num_segments <= 1:
        return shapes
    out = []
    for shape in shapes:
        if not shape:
            raise ValueError(
                "cannot segment a scalar output shape %r" % (shape,))
        out.append((math.ceil(shape[0] / num_segments),) + tuple(shape[1:]))
    return tuple(out)


class TerminationFlag(enum.IntEnum):
    """Job-wide termination reason codes (same values as rnb_tpu)."""

    UNSET = -1
    TARGET_NUM_VIDEOS_REACHED = 0
    FILENAME_QUEUE_FULL = 1
    FRAME_QUEUE_FULL = 2
    INTERNAL_ERROR = 3


class TerminationState:
    """A raise-once job termination flag; the first raise wins."""

    UNGUARDED_OK = {
        "_value": "first-writer-wins under _lock; bare reads observe "
                  "a monotone raise-once flag",
    }

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


class FaultStats:
    """Job-wide fault accounting shared by the client and every stage
    executor (the reference's ledger, ``rnb_tpu/control.py``).

    Counts contained permanent failures (with per-reason totals and a
    bounded dead-letter record of ``(request_id, step_idx, reason)``),
    shed requests per site, transient retries, and per-edge queue
    overflows under the ``"abort"`` overload policy (the ``Queue
    overflows:`` line). All counts are exact; only the dead-letter
    detail list is capped.
    """

    MAX_DEAD_LETTERS = 1000

    GUARDED_BY = {
        "num_failed": "_lock",
        "num_shed": "_lock",
        "num_retries": "_lock",
        "failure_reasons": "_lock",
        "shed_sites": "_lock",
        "overflow_sites": "_lock",
        "dead_letters": "_lock",
    }

    def __init__(self):
        self._lock = threading.Lock()
        self.num_failed = 0
        self.num_shed = 0
        self.num_retries = 0
        self.failure_reasons: Dict[str, int] = {}
        self.shed_sites: Dict[str, int] = {}
        self.overflow_sites: Dict[str, int] = {}
        self.dead_letters: List[tuple] = []

    def record_failure(self, request_ids, step_idx: int,
                       reason: str) -> None:
        """Dead-letter one or more requests (a fused batch fails as a
        unit) with one reason at one step."""
        with self._lock:
            self.num_failed += len(request_ids)
            self.failure_reasons[reason] = \
                self.failure_reasons.get(reason, 0) + len(request_ids)
            for rid in request_ids:
                if len(self.dead_letters) < self.MAX_DEAD_LETTERS:
                    self.dead_letters.append((rid, step_idx, reason))
        # a dead letter is an SLO miss the burn window sees at once
        # (outside the ledger lock, so the two locks never nest)
        metrics.mark("slo.miss", len(request_ids))

    def record_shed(self, site: str, n: int = 1) -> None:
        with self._lock:
            self.num_shed += n
            self.shed_sites[site] = self.shed_sites.get(site, 0) + n
        # the shed-spike trigger and the SLO burn both window on these
        metrics.mark("faults.sheds", n)
        metrics.mark("slo.miss", n)

    def record_retries(self, n: int = 1) -> None:
        with self._lock:
            self.num_retries += n

    def record_overflow(self, edge: str, n: int = 1) -> None:
        """A queue hit its capacity under the ``"abort"`` policy, counted
        per edge: the telemetry names where the pipeline backed up."""
        with self._lock:
            self.overflow_sites[edge] = \
                self.overflow_sites.get(edge, 0) + n

    def snapshot(self) -> Dict[str, object]:
        """Point-in-time copy for reports (dead letters included)."""
        with self._lock:
            return {
                "num_failed": self.num_failed,
                "num_shed": self.num_shed,
                "num_retries": self.num_retries,
                "failure_reasons": dict(self.failure_reasons),
                "shed_sites": dict(self.shed_sites),
                "overflow_sites": dict(self.overflow_sites),
                "dead_letters": list(self.dead_letters),
            }


class InferenceCounter:
    """Locked global count of disposed requests — completed, dead-lettered
    or shed — driving the target-reached check: a request the pipeline
    will never owe more work counts toward the target, so a run with
    contained failures still ends."""

    UNGUARDED_OK = {
        "_value": "add() is atomic under _lock; bare value reads are "
                  "a progress gauge",
    }

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    @property
    def value(self) -> int:
        return self._value

    def add(self, n: int) -> Tuple[int, int]:
        """Add n; return (old, new) atomically."""
        with self._lock:
            old = self._value
            self._value = old + n
            return old, self._value


def dispose_requests(counter: InferenceCounter, num_videos: int,
                     termination: TerminationState,
                     n: int = 1) -> Tuple[int, int]:
    """Count ``n`` requests as disposed (failed or shed) and raise the
    target-reached flag when the count crosses the job target. Every
    disposal site but the final step's success path (which also leaves
    its hot loop on the crossing) goes through here."""
    old, new = counter.add(n)
    if old < num_videos <= new:
        termination.raise_flag(TerminationFlag.TARGET_NUM_VIDEOS_REACHED)
    return old, new


class EdgeTracker:
    """Producer countdown for one queue edge: only the last producer
    to finish sends the exit markers, so markers never overtake a
    slower sibling's items."""

    GUARDED_BY = {"_remaining": "_lock"}

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
