"""The pipeline-stage plugin contract.

Counterpart of ``rnb_tpu/stage.py``. A *stage model* is one step of the
pipeline — the fused decode loader, a (possibly partial) network.
Stage classes are named by string in the JSON configs and loaded
dynamically; the executor builds one per (step, group, device).

Tensors move through the pipeline as batches with an explicit
valid-row count: :class:`PaddedBatch` (rows padded to a bucket) or
:class:`RaggedBatch` (rows in a fixed-capacity pool plus a per-request
segment table).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple


@dataclasses.dataclass
class PadCounter:
    """Padding-waste accounting for one batching stage instance: every
    emission notes its valid rows and the rows it shipped."""

    pad_rows: int = 0
    total_rows: int = 0
    emissions: int = 0

    def note(self, valid: int, shipped: int) -> int:
        """Record one emission; returns its pad-row count."""
        pad = max(0, int(shipped) - int(valid))
        self.pad_rows += pad
        self.total_rows += int(shipped)
        self.emissions += 1
        return pad

    def snapshot(self) -> dict:
        return {"pad_rows": self.pad_rows, "total_rows": self.total_rows,
                "emissions": self.emissions}


@dataclasses.dataclass
class PaddedBatch:
    """A tensor whose leading ``valid`` rows are meaningful; rows
    ``valid:`` are padding up to a row bucket."""

    data: Any          # torch.Tensor, shape = (rows, ...)
    valid: int         # number of meaningful leading rows


@dataclasses.dataclass
class RaggedBatch(PaddedBatch):
    """A :class:`PaddedBatch` whose row axis is a flat row pool at the
    stage's one dispatch shape, plus the per-request segment table:
    request i owns rows ``[offsets[i], offsets[i+1])``."""

    segment_offsets: Tuple[int, ...] = (0, 0)

    def __post_init__(self):
        self.segment_offsets = tuple(int(o)
                                     for o in self.segment_offsets)


def normalize_row_buckets(row_buckets, max_rows: int, what: str
                          ) -> Tuple[int, ...]:
    """Sorted, validated bucket tuple; ``(max_rows,)`` when disabled.
    Buckets are distinct positive row counts ending exactly at the
    stage's max shape."""
    if not row_buckets:
        return (int(max_rows),)
    buckets = sorted(int(b) for b in row_buckets)
    if buckets[0] < 1 or len(set(buckets)) != len(buckets):
        raise ValueError("row_buckets %r must be distinct positive row "
                         "counts" % (row_buckets,))
    if buckets[-1] != max_rows:
        raise ValueError("row_buckets %r must end at %s=%d"
                         % (row_buckets, what, max_rows))
    return tuple(buckets)


class StageModel:
    """Abstract contract every pipeline stage implements.

    * ``__init__(device, **kwargs)`` — build the stage on its
      ``torch.device``, load weights and warm up, so measured requests
      pay no first-call cost. The step's config keys arrive as kwargs.
    * ``output_shape_for(**kwargs)`` — classmethod: max shapes of the
      produced tensors, from the step's kwargs alone; the executor
      checks every produced payload against it.
    * ``__call__(tensors, non_tensors, time_card)`` — one request;
      returns ``(tensors, non_tensors, time_card)``, with a None
      time_card when the stage swallowed the item (a batching loader
      still accumulating).
    """

    #: True for stages that take the ``ragged``/``ragged_pool_rows``
    #: kwargs the launcher injects under the root ``ragged`` key
    SUPPORTS_RAGGED = False

    def __init__(self, device, **kwargs):
        self.device = device

    @classmethod
    def output_shape_for(cls, **model_kwargs) -> Optional[
            Sequence[Tuple[int, ...]]]:
        del model_kwargs
        return None

    def __call__(self, tensors, non_tensors, time_card):
        raise NotImplementedError
