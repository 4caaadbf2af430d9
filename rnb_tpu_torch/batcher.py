"""Dynamic batching stage.

Counterpart of ``rnb_tpu/batcher.py``. Accumulates ``batch`` incoming
requests and fuses them into one larger batch, so a downstream network
stage spreads its launch cost over them — the "Batch" half of Replicate
& Batch. While accumulating, the stage returns a None time_card, which
tells the executor to publish nothing.

The fused output is one :class:`PaddedBatch` holding the concatenated
*valid* rows of the constituents, re-padded with zero rows to a row
bucket or the stage's max shape — or, under ragged dispatch, one
:class:`RaggedBatch` at the pool shape with the per-request segment
table — plus a :class:`TimeCardList`, so one fused inference stamps every
constituent request's card. Parts on the card are fused there
(``torch.cat``), on whatever device they lie; the stage itself may sit
on the host (``devices: [-1]``).

Under the root ``autotune`` key the load-adaptive controller
(:mod:`rnb_tpu_torch.autotune`) drives the accumulate/emit decision and
the pad bucket: ``batch`` becomes a ceiling, and a held batch emits once
growing it can no longer meet the latency budget, or at the controller's
hold deadline (``next_deadline_s`` / ``poll``).

Not yet ported: deadline shedding (``take_shed``).
"""

from __future__ import annotations

import time

import torch

from rnb_tpu_torch import hostprof, trace
from rnb_tpu_torch.autotune import BatchController
from rnb_tpu_torch.ops.ragged import resolve_pool_rows, segment_offsets_of
from rnb_tpu_torch.stage import (PadCounter, PaddedBatch, RaggedBatch,
                                 StageModel, normalize_row_buckets,
                                 note_emission_accounting)
from rnb_tpu_torch.telemetry import TimeCardList, cards_of

MAX_ROWS = 15  # max clips per fused batch, matches the loader's max


class Batcher(StageModel):
    """Accumulate ``batch`` requests, then emit one fused batch.

    ``row_buckets`` pads the fused batch to the smallest bucket holding
    its valid rows instead of the max shape: six fused 1-clip videos go
    out as a 6-row batch, not a 15-row one, and the downstream network
    stage warms the same buckets. A request that no longer fits beside
    the pending ones closes the window early. ``flush()`` emits a
    partial batch at end of stream. ``batch <= 1`` passes every request
    through untouched.
    """

    SUPPORTS_RAGGED = True
    #: the accumulate/emit decision and the pad bucket can be driven by
    #: the load-adaptive controller
    SUPPORTS_AUTOTUNE = True

    def __init__(self, device, batch=1, shapes=None, max_rows=MAX_ROWS,
                 consecutive_frames=8, frame_hw=112, row_buckets=None,
                 ragged=False, ragged_pool_rows=None):
        super().__init__(device)
        self.batch = int(batch)
        # the fuse capacity comes from the stage's declared output shape,
        # not from incoming payloads: an incoming batch's row count is
        # its (small) bucket, while the fused batch may grow to the max
        self._declared_shapes = self.output_shape_for(
            shapes=shapes, max_rows=max_rows,
            consecutive_frames=consecutive_frames, frame_hw=frame_hw)
        self._declared_max = [int(s[0]) for s in self._declared_shapes]
        self.row_buckets = (normalize_row_buckets(
            row_buckets, self._declared_max[0], "stage max rows")
            if row_buckets else None)
        self.ragged = bool(ragged)
        self.pool_rows = (resolve_pool_rows(
            ragged_pool_rows, self._declared_max[0], "stage max rows")
            if self.ragged else None)
        self.padding = PadCounter()
        self.ragged_stats = ({"pool_rows": self.pool_rows, "emissions": 0,
                              "rows": 0, "pad_rows_eliminated": 0,
                              "cache_hit_rows": 0}
                             if self.ragged else None)
        self._tensors = []      # one tuple of PaddedBatch per request
        self._time_cards = []
        #: the controller (``enable_autotune``); None keeps the static
        #: accumulate-to-``batch`` rule
        self.autotune = None
        #: monotonic instant the oldest pending request joined (None
        #: when nothing is pending): the hold deadline's anchor
        self._t_oldest = None

    def enable_autotune(self, settings) -> BatchController:
        """Executor protocol: a BatchController over this stage's own
        bucket set (the shapes the downstream stage warmed). Under ragged
        dispatch every row count is one dispatch of the pool shape, so
        the candidates are 1..pool_rows."""
        if self.ragged:
            self.autotune = BatchController.for_stage(
                settings, tuple(range(1, self.pool_rows + 1)),
                self.pool_rows)
        else:
            self.autotune = BatchController.for_stage(
                settings, self.row_buckets or (self._declared_max[0],),
                self._declared_max[0])
        return self.autotune

    @classmethod
    def output_shape_for(cls, shapes=None, max_rows: int = MAX_ROWS,
                         consecutive_frames: int = 8, frame_hw: int = 112,
                         **_kwargs):
        # the batcher re-packs whatever its upstream emits: a topology
        # whose wire is not RGB frames names its shapes with ``shapes``
        if shapes:
            return tuple(tuple(int(d) for d in s) for s in shapes)
        return ((int(max_rows), int(consecutive_frames), frame_hw,
                 frame_hw, 3),)

    def __call__(self, tensors, non_tensors, time_card):
        if self.batch <= 1:
            return tensors, non_tensors, time_card
        # a single request over the fuse capacity can never be emitted:
        # a topology error, raised with the accumulator intact
        for pos, pb in enumerate(tensors):
            if pb.valid > self._declared_max[pos]:
                raise ValueError(
                    "request carries %d rows, exceeding the stage max "
                    "shape %d; raise the stage max shape"
                    % (pb.valid, self._declared_max[pos]))
        early = None
        if self._tensors and any(
                sum(parts[pos].valid for parts in self._tensors)
                + pb.valid > self._declared_max[pos]
                for pos, pb in enumerate(tensors)):
            early = self._emit_fused()
        self._tensors.append(tensors)
        self._time_cards.append(time_card)
        if self._t_oldest is None:
            self._t_oldest = time.monotonic()
        if self.autotune is not None:
            # rows per client request: an upstream fused emission
            # delivers many requests' rows in one call, and the executor
            # feeds the inter-arrival EWMA per constituent card
            self.autotune.observe_rows(tensors[0].valid
                                       / len(cards_of(time_card)))
        if early is not None:
            return early
        if len(self._time_cards) >= self.batch:
            # the static count stays a ceiling under autotune
            return self._emit_fused()
        if self.autotune is not None:
            rows, waited, dec = self._decide()
            if rows >= dec.target_rows or waited >= dec.hold_s:
                return self._emit_fused()
        return None, None, None

    def _decide(self, peek: bool = False):
        """``(rows_ready, oldest_wait_s, Decision)`` for the pending
        requests: the one place the controller's inputs are derived, so
        the emit check and the polled deadline never diverge. ``peek``
        leaves the decision accounting alone (deadline queries run every
        executor poll)."""
        rows = sum(parts[0].valid for parts in self._tensors)
        waited = time.monotonic() - self._t_oldest
        ask = self.autotune.peek if peek else self.autotune.decide
        return rows, waited, ask(len(self._time_cards), rows, waited)

    def next_deadline_s(self):
        """Seconds until the controller's hold deadline for the oldest
        pending request, or None when nothing is held or autotune is off
        (the static batcher waits for arrivals)."""
        if self.autotune is None or self._t_oldest is None:
            return None
        _, waited, dec = self._decide(peek=True)
        return max(0.0, dec.hold_s - waited)

    def poll(self):
        """Idle tick: under autotune, emit the held batch once the
        controller's target or hold deadline is met; None otherwise."""
        if self.autotune is None or self._t_oldest is None:
            return None
        rows, waited, dec = self._decide()
        if rows >= dec.target_rows or waited >= dec.hold_s:
            return self._emit_fused()
        return None

    def _bucket_for(self, rows: int, max_rows: int) -> int:
        if self.autotune is not None:
            # the controller's candidates: the shapes its decisions
            # reason about; rows past every candidate take the static
            # rule (never padded short)
            bucket = self.autotune.bucket_for(rows)
            if rows <= bucket <= max_rows:
                return bucket
        if self.row_buckets:
            for bucket in self.row_buckets:
                if rows <= bucket <= max_rows:
                    return bucket
        return max_rows

    def _counterfactual_bucket(self, rows: int) -> int:
        """The rows the bucketed pad rule would have shipped: what
        ``pad_rows_eliminated`` is measured against under ragged."""
        if self.row_buckets:
            for bucket in self.row_buckets:
                if rows <= bucket:
                    return bucket
        return self._declared_max[0]

    def _emit_fused(self):
        with hostprof.section("batcher.fuse"):
            out = self._fuse_pending()
        if trace.ACTIVE is not None:
            # the args are built only while a collector is installed
            trace.instant("batcher.emit", args={
                "requests": len(out[2]), "rows": int(out[0][0].valid)})
        return out

    def _fuse_pending(self):
        fused = []
        # the constituent cards, flat (an upstream fusing stage delivers
        # lists), each re-stamped with its first row in the fused batch
        cards = []
        offsets = segment_offsets_of(parts[0].valid
                                     for parts in self._tensors)
        for row0, item in zip(offsets, self._time_cards):
            for tc in cards_of(item):
                tc.row0 += row0
                cards.append(tc)
        for pos, parts in enumerate(zip(*self._tensors)):
            valid = sum(pb.valid for pb in parts)
            bucket = (self._declared_max[pos] if self.ragged else
                      self._bucket_for(valid, self._declared_max[pos]))
            if pos == 0 and self.autotune is not None:
                self.autotune.note_emission(valid if self.ragged
                                            else bucket)
            if pos == 0:
                note_emission_accounting(
                    self.padding, self.ragged_stats, cards, valid, bucket,
                    self._counterfactual_bucket(valid) if self.ragged
                    else 0)
            pb = self._fuse_parts(parts, valid, bucket)
            if self.ragged and pos == 0:
                pb = RaggedBatch(pb.data, valid, offsets)
            fused.append(pb)
        self._tensors = []
        self._time_cards = []
        self._t_oldest = None
        # per-request metadata cannot belong to a fused batch
        return tuple(fused), None, TimeCardList(cards)

    @staticmethod
    def _fuse_parts(parts, valid: int, bucket: int) -> PaddedBatch:
        """The valid rows of ``parts``, concatenated and padded with zero
        rows to ``bucket``, on the device the parts lie on (parts on the
        host and on a card meet on the card)."""
        devices = {pb.data.device for pb in parts}
        target = next((d for d in devices if d.type != "cpu"),
                      parts[0].data.device)
        segments = [pb.data[: pb.valid].to(target) for pb in parts]
        pad = bucket - valid
        if pad > 0:
            segments.append(torch.zeros(
                (pad,) + tuple(parts[0].data.shape[1:]),
                dtype=parts[0].data.dtype, device=target))
        return PaddedBatch(torch.cat(segments, dim=0), valid)

    def flush(self):
        """End of stream: emit whatever partial batch is pending, or
        None."""
        if not self._time_cards:
            return None
        return self._emit_fused()
