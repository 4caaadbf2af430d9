"""Pluggable routing policies: which downstream queue receives an output.

Counterpart of ``rnb_tpu/selector.py``. A stage group with several
``out_queues`` consults its :class:`QueueSelector` per item; a selector
may inspect the tensors, the non-tensor payload or the TimeCard
(content-aware routing: the Replicate & Batch placement sends rare large
videos to a lane of their own, see ``LargeSmallSelector`` in
``rnb_tpu_torch/models/r2p1d/model.py``). :class:`ReplicaSelector`
routes over a replicated step's lanes.
"""

from __future__ import annotations

from typing import Optional

from rnb_tpu_torch.health import EVICTED, HEALTHY, SUSPECT

#: the selector of a group that names none
DEFAULT_QUEUE_SELECTOR = "rnb_tpu_torch.selector.RoundRobinSelector"


class QueueSelector:
    """Base contract: pick an output-queue index in [0, num_queues)."""

    def __init__(self, num_queues: int):
        self.num_queues = num_queues

    def bind_stage(self, model) -> None:
        """Called once by the executor with the producing stage, before
        the hot loop: a content-aware selector reads its thresholds from
        the stage's configuration here."""

    def select(self, tensors, non_tensors, time_card) -> int:
        raise NotImplementedError


class RoundRobinSelector(QueueSelector):
    """Cycle through the output queues regardless of content."""

    def __init__(self, num_queues: int):
        super().__init__(num_queues)
        self._next = 0

    def select(self, tensors, non_tensors, time_card) -> int:
        choice = self._next
        self._next = (self._next + 1) % self.num_queues
        return choice


class ReplicaSelector(QueueSelector):
    """Least-loaded routing over a replica step's lanes (the reference's
    ``rnb_tpu/selector.py``).

    Replica expansion (:mod:`rnb_tpu_torch.config`) swaps this in for the
    default on the producers of a replicated step. It routes by each
    lane's in-flight depth — items enqueued minus items whose processing
    the lane finished, from the step's shared
    :class:`~rnb_tpu_torch.handoff.InflightDepths` bound by the executor
    (:meth:`bind_depths`) — so a lane wedged on a slow batch stops
    receiving work. The lowest depth wins, ties to the lowest lane, so a
    seeded run routes the same way every time; unbound (a hand-written
    config naming it on an ordinary edge) it is round-robin.

    With the step's :class:`~rnb_tpu_torch.health.LaneHealthBoard`
    (:meth:`bind_health`, root ``health`` key) open and evicted lanes
    leave the candidates, a half-open lane due for its probe gets that
    one dispatch, and the surviving lanes keep their order, so the
    tie-break replays the same whatever lanes are alive.
    """

    def __init__(self, num_queues: int):
        super().__init__(num_queues)
        self._rr = 0
        self._depths = None
        self._queue_indices = None
        self._health = None
        #: the last select() routed with no healthy lane to choose
        self.last_route_forced = False

    def bind_depths(self, depths, queue_indices) -> None:
        """Executor protocol: the step's depth counters and this
        producer's out-queue indices (lane position -> queue index)."""
        if len(queue_indices) != self.num_queues:
            raise ValueError(
                "ReplicaSelector routes over %d queue(s) but was bound to "
                "%d queue indices" % (self.num_queues, len(queue_indices)))
        self._depths = depths
        self._queue_indices = [int(q) for q in queue_indices]

    def bind_health(self, board) -> None:
        """Executor protocol: the step's lane health board."""
        self._health = board

    def select(self, tensors, non_tensors, time_card) -> int:
        self.last_route_forced = False
        if self._depths is None:
            choice = self._rr
            self._rr = (self._rr + 1) % self.num_queues
            return choice
        candidates = self._queue_indices
        if self._health is not None:
            allowed, probe = self._health.route_filter(self._queue_indices)
            if probe is not None:
                # the one half-open recovery dispatch
                self._health.note_route(probe)
                return self._queue_indices.index(probe)
            if allowed:
                candidates = allowed
            else:
                # every lane open or evicted: least-loaded over all,
                # counted as forced
                self.last_route_forced = True
        best_q = least_loaded(self._depths, candidates)
        if self._health is not None:
            self._health.note_route(best_q, forced=self.last_route_forced)
        return self._queue_indices.index(best_q)


def least_loaded(depths, candidates):
    """The lane of ``candidates`` with the lowest in-flight depth, ties
    to the first in their order: the one load rule of the selector, the
    hedges and an evicted lane's drain."""
    return min(candidates, key=depths.depth)


def pick_sibling_lane(depths, board, queue_indices,
                      exclude: Optional[int] = None) -> Optional[int]:
    """The reference's sibling choice for hedges and an evicted lane's
    drain (``_pick_lane``): ``exclude`` (the original's lane) left out,
    healthy or suspect lanes first, any lane not evicted as the
    fallback; the least loaded wins, ties to the lowest queue index.
    Unlike :meth:`ReplicaSelector.select` it claims no half-open probe
    and never forces a route. None when no lane is left."""
    candidates = [q for q in queue_indices if q != exclude]
    if board is not None:
        live = [q for q in candidates
                if board.state(q) in (HEALTHY, SUSPECT)]
        if not live:
            live = [q for q in candidates if board.state(q) != EVICTED]
        candidates = live
    if not candidates:
        return None
    if depths is None:
        return candidates[0]
    return least_loaded(depths, sorted(candidates))
