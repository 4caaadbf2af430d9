"""Pluggable routing policies: which downstream queue receives an output.

Counterpart of ``rnb_tpu/selector.py``. A stage group with several
``out_queues`` consults its :class:`QueueSelector` per item; a selector
may inspect the tensors, the non-tensor payload or the TimeCard
(content-aware routing: the Replicate & Batch placement sends rare large
videos to a lane of their own, see ``LargeSmallSelector`` in
``rnb_tpu_torch/models/r2p1d/model.py``). The reference's
``ReplicaSelector`` waits for replica lanes and is not ported.
"""

from __future__ import annotations

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
