"""The stage executor: one thread per (step, group, device instance).

Counterpart of ``rnb_tpu/runner.py``.

An item may carry its payload as host rows
(:class:`~rnb_tpu_torch.health.DirectPayload`: what the network edge's
receiver injects, :mod:`rnb_tpu_torch.netedge`). It holds no ring credit;
the executor uploads its rows through a pinned buffer on its own stream
(:class:`~rnb_tpu_torch.staging.PinnedUpload`), so they reach the card in
stream order before the stage's forward replays.

**Fault containment** (:mod:`rnb_tpu_torch.faults`): an error escaping
a stage's model call is classified. A transient one is retried up to the
step's ``max_retries``, ``retry_backoff_ms`` apart (the retry calls the
stage again on the same payload: a runner replays its captured graph on
the same input); a permanent one, or an exhausted budget, stamps the
request's card ``failed``, dead-letters it in the job's
:class:`~rnb_tpu_torch.control.FaultStats` and counts it toward the run
target, and the stream goes on; anything unclassified, or any error
with ``fault_containment: false``, stops the run with
``INTERNAL_ERROR`` as before. Stages that batch internally (the fusing
loader) contain their own decode failures and hand them over through
``take_failed()``/``take_retries()``. Under ``overload_policy: "shed"``
a full downstream queue drops the new item with a counted shed instead
of stopping the run with ``FRAME_QUEUE_FULL``. A
:class:`~rnb_tpu_torch.faults.FaultPlan` stalls a stage before the
inference span and raises or sleeps per model-call attempt. Under the
root ``deadline`` key an item whose every request's deadline passed is
shed at the queue take, before publishing, and where a stage held it
(``take_shed()``); a forked segment card is never shed. Every disposal
path returns what the item held: the consumer gave the producer's ring
credit back at the take, a shed before publishing never took one, and
a dropped card's feature-page pin is released. With no fault plan, no
deadline and nothing failing, each of these is one ``None`` test in the
hot loop.

The hot loop takes an item from the stage's input queue, runs the
stage, waits for its device work (the honest ``inference{i}_finish``
stamp, as the reference's ``stream.synchronize()``), checks the
produced payload against the stage's declared shapes, and publishes it
downstream — or, on the
final step, counts the completions and registers their TimeCards. A
step with ``async_dispatch`` (``sync_outputs`` False, the reference's
rule) skips that wait: its ``inference{i}_finish`` is then the host's
clock when the stage call returned, that is when its kernels were
queued on the stage's stream, and the device work is waited for later
by whoever reads it — the next stage's stream, ordered behind it, or on
the final step the outputs sink's copy to the host, if there is one. A
replica lane serves on a stream of its own, so there the order is made
on the card: a lane behind an async step makes its stream wait for the
card's default stream, where that step queued its work, before it calls
its stage. An async replica step that feeds another step is refused by
the config (its lane streams would need joining into the consumer's).
Accumulating stages (the fusing loader, the batcher) get idle polls so
a held batch emits on its hold timeout, and are flushed at end of
stream. A group with several out queues asks its queue selector where
each item goes. A first stage with ``submit()``/``complete()`` and a
``prefetch_depth`` has the decode of its next requests started while
the head request's device work runs.

A step with ``num_segments`` k splits each item's valid rows into k
segments (:func:`split_segments`) and publishes them to the one out
queue the selector picked, each with its own forked TimeCard and its
own ring credit; an aggregating stage downstream merges them back.

**Replica lanes** (a step's ``replicas`` key, :mod:`rnb_tpu_torch.config`):
each lane's executor reads its own lane queue on a CUDA stream of its
own, and the producers route over the lanes with ``ReplicaSelector`` by
the step's shared in-flight depths
(:class:`~rnb_tpu_torch.handoff.InflightDepths`), raised at each enqueue
and settled at the lane's next loop top, once the popped item's
processing is over. Under the root ``handoff`` key each take goes
through the consumer's :class:`~rnb_tpu_torch.handoff.EdgeHandoff`.
Under the root ``health`` key each lane beats its step's
:class:`~rnb_tpu_torch.health.LaneHealthBoard` every iteration and feeds
it dead letters and settlements; a ``replica_crash``/``replica_stall`` fault kills the lane:
its in-service dispatch is dead-lettered, the lane evicted, and its
queued items moved onto healthy siblings (``redispatched`` stamps),
while every sibling lingers past its own end of stream until the whole
step drained. A step's ``hedge_ms`` gives its producers a
:class:`~rnb_tpu_torch.health.HedgeGovernor`: a dispatch outstanding past
the threshold is re-issued on a healthy sibling as a
:class:`~rnb_tpu_torch.health.DirectPayload` with a clone of its cards,
the first resolution wins and the other copy is discarded by request id.
A hedge copy carries no ring credit: the original's comes back at its
take, as every item's does (no producer writes into a payload it
published, :mod:`rnb_tpu_torch.handoff`). Under the
root ``placement`` key each executor reports its dispatch busy seconds
(:class:`~rnb_tpu_torch.placement.CostRecord`).

The hot loop carries the tracing layer's spans
(:mod:`rnb_tpu_torch.trace`: ``exec{i}.queue_get``, ``hold_wait``,
``model_call``, ``device_sync``, ``publish``) and the host profiler's
sections (:mod:`rnb_tpu_torch.hostprof`), each one ``None`` or bool
test when off. With the live-metrics plane on, the stage's cache and
staging pool become poll sources before the start barrier and the
final step feeds its completions to the SLO layer
(:mod:`rnb_tpu_torch.metrics`). A stage with ``SUPPORTS_AUTOTUNE`` gets
the job's controller (:mod:`rnb_tpu_torch.autotune`) unless its step
opts out; the executor feeds it the client's enqueue stamps and, for
stages that do not report their own service, each arrival-triggered
dispatch's ``inference{i}_start`` -> ``_finish`` span. With the device
observability plane on (:mod:`rnb_tpu_torch.devobs`), the stage's
compute profile and byte owners register before the start barrier and
each stage-call dispatch feeds the step's compute meter its valid rows
and busy span.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from rnb_tpu_torch import devobs, hostprof, metrics, trace
from rnb_tpu_torch.control import (NUM_EXIT_MARKERS, EdgeTracker,
                                   FaultStats, InferenceCounter,
                                   RingCredits, TerminationFlag,
                                   TerminationState, dispose_requests,
                                   send_exit_markers)
from rnb_tpu_torch.devices import DeviceSpec
from rnb_tpu_torch.faults import (FATAL, TRANSIENT, LaneDeathError,
                                  classify_error, fault_reason)
from rnb_tpu_torch.handoff import EdgeHandoff
from rnb_tpu_torch.health import (LOSER, WINNER, DirectPayload,
                                  deadline_site)
from rnb_tpu_torch.health import expired as deadline_expired
from rnb_tpu_torch.ops.ragged import check_segment_offsets
from rnb_tpu_torch.placement import CostRecord
from rnb_tpu_torch.selector import DEFAULT_QUEUE_SELECTOR, pick_sibling_lane
from rnb_tpu_torch.stage import PaddedBatch, RaggedBatch
from rnb_tpu_torch.staging import PinnedUpload
from rnb_tpu_torch.telemetry import (TimeCardList, TimeCardSummary,
                                     cards_of, logname)
from rnb_tpu_torch.utils.class_utils import load_class

NUM_SUMMARY_SKIPS = 10  # steady-state summaries skip warm records
QUEUE_POLL_S = 0.05
#: floor for deadline-driven poll timeouts
MIN_POLL_S = 0.001


def poll_timeout(model):
    """(timeout, holding): the input-queue poll timeout — the stage's
    own next deadline (hold expiry / harvest tick), clamped to
    [MIN_POLL_S, QUEUE_POLL_S], the coarse default for stages without
    one — and whether the stage holds work (it has a deadline), which
    names the wait a hold and not starvation."""
    next_deadline = getattr(model, "next_deadline_s", None)
    deadline = next_deadline() if next_deadline is not None else None
    if deadline is None:
        return QUEUE_POLL_S, False
    return min(QUEUE_POLL_S, max(MIN_POLL_S, deadline)), True


def split_segments(payload, num_segments: int):
    """Split each batch's valid rows into ``num_segments`` segment
    batches of ``ceil(rows / num_segments)`` rows: the quotient of the
    valid rows everywhere, the remainder spread from the front (11 rows
    in 3 -> 4, 4, 3); a segment may be empty. Segment ``i`` is the view
    ``data[start:start + seg_rows]``, so its pad rows are the next
    segment's valid rows; only where that runs off the end of the
    batch are zero rows appended (the reference's rule, bitwise)."""
    if num_segments <= 1:
        return [payload]
    segments = []
    for seg_idx in range(num_segments):
        seg_payload = []
        for pb in payload:
            q, r = divmod(int(pb.valid), num_segments)
            start = q * seg_idx + min(seg_idx, r)
            end = q * (seg_idx + 1) + min(seg_idx + 1, r)
            seg_max = math.ceil(int(pb.data.shape[0]) / num_segments)
            chunk = pb.data[start:start + seg_max]
            pad = seg_max - int(chunk.shape[0])
            if pad > 0:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (pad,) + tuple(chunk.shape[1:]))])
            seg_payload.append(PaddedBatch(chunk, end - start))
        segments.append(tuple(seg_payload))
    return segments


@dataclass
class RunnerContext:
    """Everything one stage-executor thread needs."""

    in_queue: "queue.Queue"
    out_queues: Optional[List["queue.Queue"]]
    job_id: str
    device: DeviceSpec
    group_idx: int
    instance_idx: int
    counter: InferenceCounter
    num_videos: int
    termination: TerminationState
    step_idx: int
    sta_bar: threading.Barrier
    fin_bar: threading.Barrier
    model_class_path: str
    model_kwargs: Dict[str, Any] = field(default_factory=dict)
    #: wait for the stage's device work before ``inference{i}_finish``
    #: (False under the step's ``async_dispatch``)
    sync_outputs: bool = True
    #: the step upstream dispatches asynchronously: a lane stream must
    #: wait for the card's default stream before reading its payloads
    upstream_async: bool = False
    #: class path of the selector that routes over ``out_queues``
    queue_selector_path: str = DEFAULT_QUEUE_SELECTOR
    #: this producer's ring credits (None on the final step)
    credits: Optional[RingCredits] = None
    out_trackers: Optional[List[EdgeTracker]] = None
    print_progress: bool = False
    log_base: str = "logs"
    #: final-step instances append their TimeCardSummary here
    summary_sink: Optional[List] = None
    #: batching stages append their PadCounter snapshot / ragged stats
    pad_sink: Optional[List] = None
    ragged_sink: Optional[List] = None
    staging_sink: Optional[List] = None
    #: loaders append their pixel path and decode backends here
    ingest_sink: Optional[List] = None
    #: loaders with a clip cache append its counter snapshot here
    cache_sink: Optional[List] = None
    #: every stage appends ``(step_idx, warmup_s, sigs-or-None)`` here:
    #: its construction time (weights, warm-ups, graph captures) and
    #: the snapshot of its signature tracker (rnb_tpu_torch.compilestats)
    #: — the ``Compiles:`` and ``Warmup:`` log-meta lines
    compile_sink: Optional[List] = None
    #: stages with captured forwards append ``(step_idx, graph_stats)``
    #: here — the ``Graphs:`` log-meta line
    graph_sink: Optional[List] = None
    #: stages with a declared ``shard`` key append ``(step_idx,
    #: shard_stats)`` here once drained — the ``Shard:`` and ``Shard
    #: steps:`` log-meta lines
    shard_sink: Optional[List] = None
    #: when set, every stage appends ``(step_idx, model)`` here once it
    #: is built (the smoke checks each runner's graphs after the run)
    stage_sink: Optional[List] = None
    #: the job's page allocator, handed to every SUPPORTS_PAGER stage
    #: before the start barrier (None without the root ``pager`` key)
    pager: Any = None
    #: when set, the final step stores each request's output here:
    #: request id -> (video path, float32 numpy rows — or the non-tensor
    #: payload of a stage that emits no tensor —, cache stamps)
    outputs_sink: Optional[Dict[int, tuple]] = None
    #: segments each published item is split into (config num_segments)
    num_segments: int = 1
    #: the job's rnb_tpu_torch.trace.Tracer on traced runs: stages with
    #: ``enable_trace`` get it before the start barrier, and the final
    #: step's summary writes the ``# phases`` trailer
    tracer: Any = None
    #: the job's AutotuneSettings when this step takes part (root
    #: ``autotune`` key, and the step did not opt out)
    autotune: Any = None
    #: controller-owning stages append their final snapshot here
    autotune_sink: Optional[List] = None
    #: critpath runs: the final step's summary writes ``# critpath``
    critpath: bool = False
    #: False keeps the strict semantics: even a classified error aborts
    containment: bool = True
    #: "abort" (a full queue stops the run) or "shed" (drop the new item)
    overload_policy: str = "abort"
    #: the retry budget for transient errors of this step's model call
    max_retries: int = 0
    retry_backoff_ms: float = 10.0
    #: the injection schedule (rnb_tpu_torch.faults.FaultPlan), or None
    fault_plan: Any = None
    #: the job-wide dead-letter / shed / retry ledger
    fault_stats: Optional[FaultStats] = None
    #: deadline propagation (root ``deadline`` key): the settings and the
    #: job's expiry ledger (both None: the checks are inert)
    deadline: Any = None
    deadline_stats: Any = None
    #: the edge contract (root ``handoff`` key): the job's HandoffSettings
    #: on consumer steps, the edge's label and the sink of its snapshot
    handoff_settings: Any = None
    handoff_edge: str = ""
    handoff_sink: Optional[List] = None
    #: measured-cost placement (root ``placement`` key): each executor
    #: appends its CostRecord here at teardown
    placement_sink: Optional[List] = None
    #: the next step's lane depths when it is replica-expanded, and this
    #: producer's out-queue indices (lane addresses)
    out_depths: Any = None
    out_queue_indices: Optional[List[int]] = None
    #: this lane's side of its step's depths, and its queue index
    in_depths: Any = None
    in_queue_idx: Optional[int] = None
    #: this lane's step's health board, the next step's (for this
    #: producer's selector), and every lane queue of this step (the
    #: evicted lane's drain moves its items onto them)
    health_board: Any = None
    out_health_board: Any = None
    sibling_queues: Optional[Dict[int, "queue.Queue"]] = None
    #: hedge governors: the next step's (this producer tracks and fires)
    #: and this step's (this lane claims resolutions)
    out_hedges: Any = None
    in_hedges: Any = None


def validate_payload(declared, payload, where: str) -> None:
    """Assert a produced payload matches the stage's declared
    ``output_shape_for``: same tensor count, same trailing dims, row
    axis no larger than declared; a ragged payload's segment table must
    partition its valid rows."""
    payload = tuple(payload) if payload else ()
    if declared is None:
        if payload:
            raise ValueError("%s declares no tensor outputs but produced "
                             "%d tensor(s)" % (where, len(payload)))
        return
    declared = tuple(map(tuple, declared))
    if len(payload) != len(declared):
        raise ValueError("%s declares %d output tensor(s) %r but produced "
                         "%d" % (where, len(declared), declared,
                                 len(payload)))
    for idx, (pb, want) in enumerate(zip(payload, declared)):
        got = tuple(int(d) for d in pb.data.shape)
        if (len(got) != len(want) or got[1:] != want[1:]
                or got[0] > want[0]):
            raise ValueError(
                "%s output %d has shape %r but declares %r (row axis may "
                "be smaller under bucketing, never larger; trailing dims "
                "must match exactly)" % (where, idx, got, want))
        if isinstance(pb, RaggedBatch):
            try:
                check_segment_offsets(pb.segment_offsets, pb.valid)
            except ValueError as e:
                raise ValueError("%s output %d: %s" % (where, idx, e))


def _sync(payload) -> None:
    """Wait for the device work that produced ``payload``."""
    for pb in payload:
        if pb.data.is_cuda:
            torch.cuda.current_stream(pb.data.device).synchronize()


def _order_behind_default(payload) -> None:
    """A consumer behind an async step: its stream waits for the card's
    default stream, where the producer queued its work."""
    for pb in payload:
        if pb.data.is_cuda:
            current = torch.cuda.current_stream(pb.data.device)
            default = torch.cuda.default_stream(pb.data.device)
            if current != default:
                current.wait_stream(default)


#: the cache stamps the outputs sink records per request
OUTPUT_STAMPS = ("cache_hit", "cache_coalesced", "feature_hit")


def _store_outputs(sink: Dict[int, tuple], payload, non_tensors,
                   time_card) -> None:
    """Copy each request's output rows to the host sink, with its cache
    stamps. A request's rows are ``[row0, row0 + num_clips)`` of the
    emission, as the last batching stage stamped them: a coalesced
    follower shares its leader's rows, so an emission may hold more
    cards than row segments. A stage that emits no tensor stores its
    non-tensor payload (the single step's class id, or a mesh stage's
    class ids, one a card)."""
    cards = cards_of(time_card)
    if not payload:
        if isinstance(non_tensors, torch.Tensor):
            # card i's is entry i; a padded video's, past the cards, is
            # dropped
            values = non_tensors.tolist()
        else:
            values = [non_tensors] * len(cards)
        for tc, value in zip(cards, values):
            sink[tc.id] = (tc.video, value,
                           {k: getattr(tc, k) for k in OUTPUT_STAMPS})
        return
    pb = payload[0]
    end = max(tc.row0 + int(tc.num_clips) for tc in cards)
    rows = pb.data[:end].to(torch.float32).cpu().numpy()
    for tc in cards:
        sink[tc.id] = (tc.video, rows[tc.row0:tc.row0 + int(tc.num_clips)],
                       {k: getattr(tc, k) for k in OUTPUT_STAMPS})


def _publish(ctx: RunnerContext, out_queue, payload, non_tensors,
             time_card, lane: Optional[int] = None) -> bool:
    """Hand one item to the next step on ``out_queue``: as it is, or as
    ``num_segments`` segments, each with its own forked card and its own
    ring credit. The segments are views of the stage's output: each
    consumer keeps the tensor alive by its reference and orders the
    caching allocator's reuse of it after its own stream
    (``record_stream``), so no segment is copied. A full queue stops the
    run under the ``"abort"`` policy (an overflow counted on the edge);
    under ``"shed"`` the item passed the shed check, so it waits for
    room (bounded backpressure). False when the job died.

    ``lane`` is the replica lane's queue index on a replica-expanded
    edge: a successful put opens the item's in-flight window there, and
    on a hedged edge the dispatch is tracked first."""
    k = ctx.num_segments
    segments = (split_segments(payload, k) if payload and k > 1
                else [payload] * k)
    for seg_idx, seg_payload in enumerate(segments):
        if seg_payload and not ctx.credits.acquire(ctx.termination):
            return False
        card = time_card.fork(seg_idx) if k > 1 else time_card
        credits = ctx.credits if seg_payload else None
        if ctx.out_hedges is not None:
            # tracked before the put: the clone never races the
            # consumer's stamps
            ctx.out_hedges.track(card, lane, seg_payload, non_tensors)
        item = (seg_payload, non_tensors, card, credits)
        if ctx.overload_policy == "shed":
            while True:
                try:
                    out_queue.put(item, timeout=QUEUE_POLL_S)
                    break
                except queue.Full:
                    if ctx.termination.terminated:
                        return False
        else:
            try:
                out_queue.put_nowait(item)
            except queue.Full:
                if ctx.fault_stats is not None:
                    ctx.fault_stats.record_overflow(
                        "step%d->step%d" % (ctx.step_idx, ctx.step_idx + 1))
                ctx.termination.raise_flag(TerminationFlag.FRAME_QUEUE_FULL)
                return False
        if ctx.out_depths is not None:
            ctx.out_depths.inc(lane)
            if ctx.out_health_board is not None:
                ctx.out_health_board.note_enqueue(lane)
    return True


def _release_pins(cards) -> None:
    """A dropped card's feature-page pin goes with it (the runner would
    have released it after its gather)."""
    for tc in cards:
        plan = getattr(tc, "feature_plan", None)
        if plan is not None:
            tc.feature_plan = None
            plan.release()


def _hedge_lost(ctx: RunnerContext, time_card) -> bool:
    """The exactly-once resolution of a hedged dispatch at its replica
    step (the reference's rule): the first disposal or completion of
    either copy claims the request ids; the other copy's is the loser,
    discarded with its service counted as waste, and the caller drops
    the item without touching a counter. A copy that already won
    (``hedge_resolved``) owns the outcome and claims no second time."""
    if ctx.in_hedges is None:
        return False
    cards = cards_of(time_card)
    if any(getattr(tc, "hedge_resolved", False) for tc in cards):
        return False
    verdict = ctx.in_hedges.claim(time_card)
    if verdict == LOSER:
        _release_pins(cards)
        ctx.in_hedges.discard(time_card)
        return True
    if verdict == WINNER:
        for tc in cards:
            tc.hedge_resolved = True
    return False


def _contain_failure(ctx: RunnerContext, time_card, reason: str,
                     summary) -> None:
    """Dead-letter one item's request(s): stamp the cards failed, record
    them in the job's ledger and count them toward the run target (a
    failed request never produces the completion the target waits for).
    A lane's dead letters feed its health board."""
    if _hedge_lost(ctx, time_card):
        return
    cards = cards_of(time_card)
    _release_pins(cards)
    for tc in cards:
        if tc.status == "ok":
            tc.mark_failed(reason)
    if ctx.fault_stats is not None:
        ctx.fault_stats.record_failure([tc.id for tc in cards],
                                       ctx.step_idx, reason)
    if ctx.health_board is not None:
        ctx.health_board.note_failure(ctx.in_queue_idx)
    if summary is not None:
        summary.note_failure(reason, len(cards))
    dispose_requests(ctx.counter, ctx.num_videos, ctx.termination,
                     len(cards))


def _shed(ctx: RunnerContext, time_card, site: str, summary,
          expired: bool = False) -> None:
    """Drop one item at ``site``: stamped, counted in the fault ledger
    (and, for an ``expired`` deadline, in the deadline ledger, which
    ``parse_utils`` cross-foots with it) and disposed toward the target.
    A hedge loser is discarded instead."""
    if _hedge_lost(ctx, time_card):
        return
    cards = cards_of(time_card)
    _release_pins(cards)
    for tc in cards:
        tc.mark_shed(site)
    if ctx.fault_stats is not None:
        ctx.fault_stats.record_shed(site, len(cards))
    if expired and ctx.deadline_stats is not None:
        ctx.deadline_stats.record(site, len(cards))
    if summary is not None:
        summary.note_shed(len(cards))
    dispose_requests(ctx.counter, ctx.num_videos, ctx.termination,
                     len(cards))


def _shed_deadline(ctx: RunnerContext, time_card, where: str,
                   summary) -> None:
    """Shed an item whose every request's deadline passed, at the
    boundary ``where`` (e.g. ``step1_take``)."""
    _shed(ctx, time_card, deadline_site(where), summary, expired=True)


def _sheddable_expired(ctx: RunnerContext, time_card) -> bool:
    """The deadline check of a boundary: expired and legal to shed (a
    forked segment card never is: dropping one segment would strand its
    siblings in the aggregator)."""
    return (ctx.deadline is not None
            and getattr(time_card, "sub_id", None) is None
            and deadline_expired(time_card))


def _overloaded(ctx: RunnerContext, out_queue, time_card) -> bool:
    """Under ``overload_policy: "shed"``: would this item (all its
    segments) overfill ``out_queue``? A forked card never sheds."""
    return (ctx.overload_policy == "shed" and out_queue.maxsize > 0
            and getattr(time_card, "sub_id", None) is None
            and out_queue.qsize() + ctx.num_segments > out_queue.maxsize)


def _fire_hedges(ctx: RunnerContext) -> None:
    """The producer's hedge tick: every dispatch outstanding past the
    governor's threshold is re-issued on the best healthy sibling lane,
    as a :class:`DirectPayload` of the same tensors with a clone of its
    cards and no ring credit. A full sibling queue
    defers the hedge to a later tick (a hedge never adds
    backpressure)."""
    gov = ctx.out_hedges
    for entry in gov.poll():
        lane = pick_sibling_lane(ctx.out_depths, ctx.out_health_board,
                                 ctx.out_queue_indices, exclude=entry.lane)
        if lane is None:
            continue
        # committed before the put: begin_fire re-checks that the
        # dispatch is unresolved, so no copy of a claimed request goes out
        if not gov.begin_fire(entry):
            continue
        item = (DirectPayload(entry.payload), entry.non_tensors, entry.card,
                None)
        try:
            ctx.out_queues[ctx.out_queue_indices.index(lane)].put_nowait(
                item)
        except queue.Full:
            gov.cancel_fire(entry)
            continue
        if ctx.out_depths is not None:
            ctx.out_depths.inc(lane)
        if ctx.out_health_board is not None:
            ctx.out_health_board.note_enqueue(lane)


def _linger_for_hedges(ctx: RunnerContext) -> None:
    """The producer's end of stream on a hedged edge: keep ticking the
    governor until every tracked dispatch settled (or the job ended), so
    no tail dispatch that needs a hedge is orphaned and no hedge lands
    behind the exit markers, which are sent after this."""
    gov = ctx.out_hedges
    while not ctx.termination.terminated and gov.num_outstanding():
        _fire_hedges(ctx)
        time.sleep(QUEUE_POLL_S / 5.0)


def _die_lane(ctx: RunnerContext, exc: LaneDeathError) -> None:
    """This replica lane's executor is dead (an injected replica_crash or
    replica_stall; its in-service dispatch was dead-lettered by the
    caller). Once the lane's last instance died the lane is evicted, so
    the selector stops feeding it, and its queued items are moved onto
    healthy siblings until its end of stream: none is stranded."""
    board = ctx.health_board
    if board is None or board.instance_died(ctx.in_queue_idx) > 0:
        # no board (the launcher refuses lane faults without one), or a
        # live instance still serves this lane's queue
        return
    board.evict(ctx.in_queue_idx, "replica-%s" % exc.fate)
    targets = {q: sq for q, sq in (ctx.sibling_queues or {}).items()
               if q != ctx.in_queue_idx}
    if not targets:
        return
    try:
        _pump_dead_lane(ctx, targets,
                        trace.name("exec%d.redispatch", ctx.step_idx))
    finally:
        # the dead lane's stream is over: release the siblings' linger
        board.note_drained(ctx.in_queue_idx)


def _pump_dead_lane(ctx: RunnerContext, targets, tr_redispatch) -> None:
    """Move every item queued on the dead lane to a healthy sibling,
    with its credit (it was never taken), a ``redispatched`` stamp and
    the in-flight windows of both lanes reconciled."""
    while not ctx.termination.terminated:
        try:
            item = ctx.in_queue.get(timeout=QUEUE_POLL_S)
        except queue.Empty:
            continue
        if item is None:
            return  # end of stream: nothing more can strand here
        lane = pick_sibling_lane(ctx.in_depths, ctx.health_board,
                                 sorted(targets))
        if lane is None:
            lane = sorted(targets)[0]
        with trace.span(tr_redispatch):
            for tc in cards_of(item[2]):
                tc.redispatched = getattr(tc, "redispatched", 0) + 1
            while not ctx.termination.terminated:
                try:
                    targets[lane].put(item, timeout=QUEUE_POLL_S)
                    break
                except queue.Full:
                    continue
            else:
                return
        if ctx.in_depths is not None:
            ctx.in_depths.dec(ctx.in_queue_idx)
            ctx.in_depths.inc(lane)
        ctx.health_board.note_settle(ctx.in_queue_idx)
        ctx.health_board.note_enqueue(lane)
        ctx.health_board.note_redispatch(ctx.in_queue_idx)


class _LaneDied(Exception):
    """Raised out of a stage call whose lane was killed: the in-service
    dispatch is already dead-lettered."""

    def __init__(self, cause: LaneDeathError):
        super().__init__(str(cause))
        self.cause = cause


def _stage_hooks(model):
    """A stage's containment hooks ``(take_retries, take_failed,
    take_shed)``, or None when it has none (resolved once)."""
    hooks = tuple(getattr(model, name, None) for name in (
        "take_retries", "take_failed", "take_shed"))
    return hooks if any(h is not None for h in hooks) else None


def _drain_stage_failures(ctx: RunnerContext, hooks, summary) -> None:
    """Turn what a stage contained internally into the job's accounting:
    its retries, its failures (dead-lettered here, or the run aborted
    with ``fault_containment: false``) and its deadline sheds."""
    take_retries, take_failed, take_shed = hooks
    if take_retries is not None:
        n = take_retries()
        if n:
            if ctx.fault_stats is not None:
                ctx.fault_stats.record_retries(n)
            if summary is not None:
                summary.note_retries(n)
    if take_failed is not None:
        for tc, reason in take_failed():
            if not ctx.containment:
                raise RuntimeError(
                    "request %s failed in-stage (%s) with "
                    "fault_containment disabled"
                    % (getattr(tc, "id", "?"), reason))
            _contain_failure(ctx, tc, reason, summary)
    if take_shed is not None:
        for tc, where in take_shed():
            _shed_deadline(ctx, tc, "step%d_%s" % (ctx.step_idx, where),
                           summary)


def _call_stage(ctx: RunnerContext, model, payload, non_tensors, time_card,
                handle, summary, key_start: str, tr_model_call: str,
                busy: Optional[list] = None):
    """One dispatch of the stage under the fault plan and the retry
    budget: the plan's stall before the inference span, then per attempt
    its latency or error and the call (``complete`` of a prefetched
    decode on the first attempt, the stage itself on a retry). Returns
    the stage's result, or None when the item was dead-lettered. A
    replica lane's faults are addressed by its queue index; a lane
    death dead-letters the dispatch and raises :class:`_LaneDied`.
    ``busy[0]`` accumulates the dispatch's busy seconds (the backoff
    sleeps excluded), the placement planner's cost."""
    rids = None
    if ctx.fault_plan is not None:
        # a fault matching any constituent hits the whole dispatch
        rids = [tc.id for tc in cards_of(time_card)]
        stall = ctx.fault_plan.stall_ms(ctx.step_idx, rids,
                                        lane=ctx.in_queue_idx)
        if stall > 0:
            time.sleep(stall / 1000.0)
    time_card.record(key_start)
    attempt = 0
    t_busy = time.monotonic() if busy is not None else None
    try:
        while True:
            try:
                with hostprof.section(tr_model_call), \
                        trace.span(tr_model_call, _rid(time_card)):
                    if ctx.fault_plan is not None:
                        ctx.fault_plan.fire(ctx.step_idx, rids, attempt,
                                            lane=ctx.in_queue_idx)
                    if handle is not None:
                        return model.complete(handle, non_tensors, time_card)
                    return model(payload, non_tensors, time_card)
            except Exception as exc:
                if handle is not None:
                    # a retry decodes again on the synchronous path: the
                    # prefetched decode is retired, its rows released
                    model.discard(handle, non_tensors)
                    handle = None
                if isinstance(exc, LaneDeathError) and ctx.containment \
                        and ctx.in_depths is not None:
                    # a lane death, not a request fault (on a step
                    # without lanes it is fatal, as in the reference)
                    _contain_failure(ctx, time_card, fault_reason(exc),
                                     summary)
                    raise _LaneDied(exc)
                if _retry_or_contain(ctx, exc, attempt, time_card, summary):
                    attempt += 1
                    if ctx.retry_backoff_ms > 0:
                        # backoff is idle, not service
                        if t_busy is not None:
                            busy[0] += time.monotonic() - t_busy
                        time.sleep(ctx.retry_backoff_ms / 1000.0)
                        if t_busy is not None:
                            t_busy = time.monotonic()
                    continue
                return None
    finally:
        if t_busy is not None:
            busy[0] += time.monotonic() - t_busy


def _retry_or_contain(ctx: RunnerContext, exc: Exception, attempt: int,
                      time_card, summary) -> bool:
    """Classify an error escaping a stage call: True to retry it (the
    retry counted), False once the item is dead-lettered; a fatal error,
    strict mode and a segment past its retries re-raise it."""
    kind = classify_error(exc)
    if kind is FATAL or not ctx.containment:
        raise exc
    retry = kind is TRANSIENT and attempt < ctx.max_retries
    if not retry and getattr(time_card, "sub_id", None) is not None:
        # a segment stays fail-fast past its retries: one dead-lettered
        # segment would strand its siblings
        raise exc
    if retry:
        if ctx.fault_stats is not None:
            ctx.fault_stats.record_retries(1)
        if summary is not None:
            summary.note_retries(1)
        return True
    reason = fault_reason(exc)
    if kind is TRANSIENT:
        reason = "retries-exhausted:" + reason
    _contain_failure(ctx, time_card, reason, summary)
    return False


def _note_compute(meter, time_card, key_start: str,
                  key_finish: str) -> None:
    """Feed one dispatch to the step's devobs compute meter: its valid
    rows are the constituents' ``num_clips``, with coalesced followers
    and feature hits counted 0 (neither ran the forward), and its busy
    span runs from the last constituent's ``inference{i}_start`` (an
    earlier one's includes its batch-fill hold) to the finish."""
    cards = cards_of(time_card)
    t_fin = cards[0].timings[key_finish]
    t_sta = max(tc.timings.get(key_start, t_fin) for tc in cards)
    rows = sum(int(getattr(tc, "num_clips", 0)) for tc in cards
               if not getattr(tc, "cache_coalesced", False)
               and not getattr(tc, "feature_hit", False))
    meter.note(rows, t_fin - t_sta)


def _rid(time_card) -> Optional[int]:
    """The request id a span correlates with (None for a fused list)."""
    return None if isinstance(time_card, TimeCardList) else time_card.id


def runner(ctx: RunnerContext) -> None:
    """Thread entry: build the stage, run the hot loop, drain."""
    summary = TimeCardSummary() if ctx.out_queues is None else None
    if summary is not None and ctx.tracer is not None:
        summary.track_phases = True
        summary.phase_num_skips = NUM_SUMMARY_SKIPS
    if summary is not None and ctx.critpath:
        summary.track_critpath = True
        summary.critpath_num_skips = NUM_SUMMARY_SKIPS
    model = None
    controller = None
    declared = None
    handoff = None
    warmup_s = 0.0
    try:
        if ctx.in_depths is not None \
                and ctx.device.resolve().type == "cuda":
            # a replica lane warms up, captures and serves on a stream of
            # its own (the current stream is the thread's)
            torch.cuda.set_stream(torch.cuda.Stream(ctx.device.resolve()))
        model_class = load_class(ctx.model_class_path)
        # the stage builds its weights, warms up and captures its graphs
        # in its constructor, before the start barrier: the Warmup: line
        t_construct = time.monotonic()
        model = model_class(ctx.device, **ctx.model_kwargs)
        warmup_s = time.monotonic() - t_construct
        if ctx.stage_sink is not None:
            ctx.stage_sink.append((ctx.step_idx, model))
        declared = model_class.output_shape_for(**ctx.model_kwargs)
        if ctx.pager is not None and getattr(model, "SUPPORTS_PAGER",
                                             False):
            # arenas are allocated before the start barrier
            model.enable_pager(ctx.pager)
        if ctx.tracer is not None and hasattr(model, "enable_trace"):
            # refinement stamps and the stage's counter sources
            model.enable_trace(ctx.tracer, ctx.step_idx)
        if hasattr(model, "bind_shard_step"):
            # the merge collective's section and span name the step, on
            # traced and untraced runs alike
            model.bind_shard_step(ctx.step_idx)
        if ctx.autotune is not None and getattr(model, "SUPPORTS_AUTOTUNE",
                                                False):
            # over the stage's own warmed buckets
            controller = model.enable_autotune(ctx.autotune)
        if ctx.health_board is not None:
            # the lane's instance census, before the barrier: the last
            # instance to die drains the lane
            ctx.health_board.register_instance(ctx.in_queue_idx)
        if ctx.handoff_settings is not None and ctx.step_idx > 0:
            # this consumer's side of the edge contract
            handoff = EdgeHandoff(
                ctx.handoff_settings, ctx.device, ctx.handoff_edge,
                model=model,
                external_owner=(ctx.pager.owns if ctx.pager is not None
                                else None))
        # the stage's cache and staging pool (and the handoff edge)
        # become poll sources of the live-metrics registry before the
        # barrier (no-op when off)
        metrics.register_stage(model, handoff)
        # its compute profile becomes the step's meter and its byte
        # owners ledger sources, before the barrier so every sample
        # covers them (no-op when devobs is off)
        devobs.register_stage(model, ctx.step_idx, ctx.device, handoff)
    except Exception:
        traceback.print_exc()
        ctx.termination.raise_flag(TerminationFlag.INTERNAL_ERROR)
        model = None

    selector = None
    try:
        if model is not None and ctx.out_queues is not None:
            selector = load_class(ctx.queue_selector_path)(
                len(ctx.out_queues))
            selector.bind_stage(model)
            if ctx.out_depths is not None and hasattr(selector,
                                                      "bind_depths"):
                # least-loaded routing over the next step's lanes, gated
                # by their health board
                selector.bind_depths(ctx.out_depths, ctx.out_queue_indices)
                if ctx.out_health_board is not None \
                        and hasattr(selector, "bind_health"):
                    selector.bind_health(ctx.out_health_board)
    except Exception:
        traceback.print_exc()
        ctx.termination.raise_flag(TerminationFlag.INTERNAL_ERROR)
        model = None

    try:
        ctx.sta_bar.wait()
    except threading.BrokenBarrierError:
        pass
    # the measured window opens here: a signature the stage first sees
    # from now on is a mid-run compile (steady_new in Compiles:)
    compile_tracker = getattr(model, "compiles", None)
    if compile_tracker is not None:
        compile_tracker.freeze()

    # prefetch: a first stage with submit()/complete() has the host work
    # (decode) of its next requests started while the head request's
    # device work runs; depth 0 keeps the plain loop
    prefetch_depth = 0
    if (model is not None and ctx.step_idx == 0
            and hasattr(model, "submit") and hasattr(model, "complete")):
        prefetch_depth = int(getattr(model, "prefetch_depth", 0) or 0)
    pending: deque = deque()  # (handle, non_tensors, time_card)
    idle_poll = getattr(model, "poll", None)
    take_ready = getattr(model, "take_ready", None)
    # an async stage's drain (the mesh runner's), None once it ran
    finalize = getattr(model, "finalize", None)
    # what a stage contains internally, drained at each loop top
    hooks = _stage_hooks(model)
    if hooks is not None and hooks[1] is not None and ctx.containment:
        # the step's retry budget; strict mode leaves the stage's (0, 0),
        # so a failure it parks is drained into an abort
        model.fault_retry_budget = (ctx.max_retries, ctx.retry_backoff_ms)
    # the executor feeds the controller's service estimator unless the
    # stage reports its own
    service_feed = controller is not None and not getattr(
        model, "AUTOTUNE_SELF_SERVICE", False)
    where = "step %d %s" % (ctx.step_idx, ctx.model_class_path)
    key_start = "inference%d_start" % ctx.step_idx
    key_finish = "inference%d_finish" % ctx.step_idx
    key_runner = "runner%d_start" % ctx.step_idx
    # span and section names built once (the host profiler's sections
    # share the spans' names but for publish and bookkeeping, as in the
    # reference): the disabled hooks then cost one None or bool test
    tr_queue_get = trace.name("exec%d.queue_get", ctx.step_idx)
    tr_hold_wait = trace.name("exec%d.hold_wait", ctx.step_idx)
    tr_swallow = trace.name("exec%d.swallow", ctx.step_idx)
    tr_model_call = trace.name("exec%d.model_call", ctx.step_idx)
    tr_device_sync = trace.name("exec%d.device_sync", ctx.step_idx)
    tr_publish = trace.name("exec%d.publish", ctx.step_idx)
    # the devobs compute meter, resolved once: None when devobs is off
    # or the stage declares no compute profile
    devobs_meter = devobs.meter_for(ctx.step_idx)
    sec_publish = "exec%d.route+enqueue" % ctx.step_idx
    sec_bookkeeping = "exec%d.bookkeeping" % ctx.step_idx
    where_take = "step%d_take" % ctx.step_idx
    where_publish = "step%d_publish" % ctx.step_idx
    tr_handoff = trace.name("exec%d.handoff", ctx.step_idx)
    saw_marker = False
    uploader = None  # built at the first DirectPayload item of host rows
    # placement: this executor's busy seconds (the dispatch spans) and
    # dispatches
    busy = [0.0] if ctx.placement_sink is not None else None
    dispatches = 0
    # items popped whose processing is over at the next loop top: their
    # lane depth to settle
    depth_owed = 0
    # a health-enabled lane past its own end of stream lingers until
    # every sibling lane drained (an evicted lane may still move work
    # here), with one last timed sweep after it saw them all drained
    marker_noted = False
    final_sweep = False
    try:
        while model is not None and not ctx.termination.terminated:
            if ctx.health_board is not None:
                # the liveness beat: a wedged executor stops beating
                ctx.health_board.beat(ctx.in_queue_idx)
            if ctx.out_hedges is not None:
                _fire_hedges(ctx)
            if depth_owed:
                if ctx.in_depths is not None:
                    ctx.in_depths.dec(ctx.in_queue_idx, depth_owed)
                if ctx.health_board is not None:
                    ctx.health_board.note_settle(ctx.in_queue_idx,
                                                 depth_owed)
                depth_owed = 0
            if hooks is not None:
                _drain_stage_failures(ctx, hooks, summary)
            # set where an arrival was dispatched by the stage call: only
            # such a dispatch's start -> finish span is service (a polled
            # or flushed emission's last start predates it by the hold)
            arrival = False
            result = take_ready() if take_ready is not None else None
            if result is None and prefetch_depth > 0:
                while not saw_marker and len(pending) < prefetch_depth + 1:
                    try:
                        with hostprof.section(tr_queue_get), \
                                trace.span(tr_queue_get):
                            item = ctx.in_queue.get(block=not pending,
                                                    timeout=QUEUE_POLL_S)
                    except queue.Empty:
                        break
                    if item is None:
                        saw_marker = True
                        break
                    _payload, non_tensors, time_card, _credits = item
                    time_card.add_device(ctx.device.label)
                    time_card.record(key_runner)
                    if _sheddable_expired(ctx, time_card):
                        # shed before its decode is even submitted
                        _shed_deadline(ctx, time_card, where_take, summary)
                        continue
                    try:
                        with hostprof.section(tr_model_call), \
                                trace.span(tr_model_call, time_card.id):
                            handle = model.submit(non_tensors, time_card)
                    except Exception as exc:
                        # a submit-time decode error (a corrupt header)
                        # fails this request only
                        if classify_error(exc) is FATAL \
                                or not ctx.containment:
                            raise
                        _contain_failure(ctx, time_card, fault_reason(exc),
                                         summary)
                        continue
                    pending.append((handle, non_tensors, time_card))
                if pending:
                    handle, non_tensors, time_card = pending.popleft()
                    result = _call_stage(ctx, model, None, non_tensors,
                                         time_card, handle, summary,
                                         key_start, tr_model_call)
                    if result is None:
                        continue  # dead-lettered
                elif not saw_marker:
                    continue
            if result is None and saw_marker:
                result = model.flush() if hasattr(model, "flush") else None
                if result is None or result[2] is None:
                    break
            elif result is None:
                timeout, holding = poll_timeout(model)
                try:
                    with hostprof.section(tr_hold_wait if holding
                                          else tr_queue_get), \
                            trace.span(tr_hold_wait if holding
                                       else tr_queue_get):
                        item = ctx.in_queue.get(timeout=timeout)
                except queue.Empty:
                    if marker_noted and ctx.health_board.all_drained():
                        # a drain's last put happens before its drained
                        # note: one more timed sweep proves the queue
                        # empty
                        if final_sweep:
                            break
                        final_sweep = True
                        continue
                    if idle_poll is None:
                        continue
                    result = idle_poll()
                    if result is None or result[2] is None:
                        continue
                    item = False
                if item is None:
                    if ctx.health_board is None:
                        saw_marker = True
                        continue
                    # linger: a sibling evicted after this lane's end of
                    # stream moves its queue here
                    if not marker_noted:
                        ctx.health_board.note_drained(ctx.in_queue_idx)
                        marker_noted = True
                    if ctx.health_board.all_drained():
                        if final_sweep:
                            saw_marker = True
                            continue
                        final_sweep = True
                    continue
                if item is not False:
                    payload, non_tensors, time_card, credits = item
                    if credits is not None:
                        credits.release()
                    if ctx.in_depths is not None:
                        # settled at the next loop top: a depth covers
                        # in-service time
                        depth_owed += 1
                    time_card.add_device(ctx.device.label)
                    time_card.record(key_runner)
                    if _sheddable_expired(ctx, time_card):
                        # the credit went back above: nothing upstream
                        # waits on a shed item
                        _shed_deadline(ctx, time_card, where_take, summary)
                        continue
                    if controller is not None:
                        # arrival-rate estimator: the client's wall-clock
                        # enqueue stamps (no clock read here)
                        for tc in cards_of(time_card):
                            t_enq = tc.timings.get("enqueue_filename")
                            if t_enq is not None:
                                controller.observe_enqueue(t_enq)
                    if isinstance(payload, DirectPayload):
                        payload = payload.payload
                        if payload and payload[0].data.device.type == "cpu":
                            # host rows off the network edge: to the card
                            # on this thread's stream, ahead of the
                            # forward (a hedge copy's tensors are already
                            # on a device)
                            if uploader is None:
                                uploader = PinnedUpload(ctx.device.resolve())
                            payload = tuple(
                                dataclasses.replace(pb, data=uploader.upload(
                                    pb.data)) for pb in payload)
                    if handoff is not None and payload:
                        with hostprof.section(tr_handoff), \
                                trace.span(tr_handoff):
                            payload = handoff.take(payload)
                    if ctx.upstream_async and payload:
                        _order_behind_default(payload)
                    try:
                        result = _call_stage(ctx, model, payload,
                                             non_tensors, time_card, None,
                                             summary, key_start,
                                             tr_model_call, busy)
                    except _LaneDied as death:
                        # evict the lane and move its queue onto the
                        # siblings; no stage call runs here again
                        _die_lane(ctx, death.cause)
                        break
                    if result is None:
                        continue  # dead-lettered
                    arrival = True
                    if result[2] is None:
                        trace.instant(tr_swallow, rid=_rid(time_card))
            tensors_out, non_tensors_out, time_card = result
            if time_card is None:
                continue  # the stage swallowed the item
            validate_payload(declared, tensors_out, where)
            if tensors_out and ctx.sync_outputs:
                t_sync = time.monotonic() if busy is not None else None
                with hostprof.section(tr_device_sync), \
                        trace.span(tr_device_sync, _rid(time_card)):
                    _sync(tensors_out)
                if t_sync is not None:
                    busy[0] += time.monotonic() - t_sync
            time_card.record(key_finish)
            dispatches += 1
            if ctx.in_hedges is not None and _hedge_lost(ctx, time_card):
                # the other copy resolved this hedged dispatch first: its
                # result stands, this one is discarded
                continue
            if devobs_meter is not None:
                # a metered stage (a network step) emits only from its
                # own calls: no take_ready, poll or flush emission
                _note_compute(devobs_meter, time_card, key_start,
                              key_finish)
            if service_feed and arrival and tensors_out:
                # per shipped row bucket: the LAST-swallowed
                # constituent's start -> the finish (earlier ones' starts
                # include their accumulate hold)
                cards = cards_of(time_card)
                t_fin = cards[0].timings[key_finish]
                t_sta = max(tc.timings.get(key_start, t_fin) for tc in cards)
                out_pb = tensors_out[0]
                controller.observe_service(
                    out_pb.valid if isinstance(out_pb, RaggedBatch)
                    else int(out_pb.data.shape[0]), max(0.0, t_fin - t_sta))
            if ctx.out_queues is not None:
                if _sheddable_expired(ctx, time_card):
                    # too late already: dropped before it holds a credit
                    _shed_deadline(ctx, time_card, where_publish, summary)
                    continue
                with hostprof.section(sec_publish), \
                        trace.span(tr_publish, _rid(time_card)):
                    out_idx = selector.select(tensors_out, non_tensors_out,
                                              time_card)
                    out_queue = ctx.out_queues[out_idx]
                    # a replica edge's lane, by its queue index
                    lane = (ctx.out_queue_indices[out_idx]
                            if ctx.out_depths is not None else None)
                    if _overloaded(ctx, out_queue, time_card):
                        _shed(ctx, time_card,
                              "step%d_out_queue" % ctx.step_idx
                              + ("" if lane is None else ".lane%d" % lane),
                              summary)
                        continue
                    published = _publish(ctx, out_queue, tensors_out,
                                         non_tensors_out, time_card, lane)
                if not published:
                    break
                continue
            # final step: count completions, detect the target
            with hostprof.section(sec_bookkeeping):
                if ctx.outputs_sink is not None:
                    _store_outputs(ctx.outputs_sink, tensors_out,
                                   non_tensors_out, time_card)
                n = (len(time_card) if isinstance(time_card, TimeCardList)
                     else 1)
                old, new = ctx.counter.add(n)
                cards = cards_of(time_card)
                for tc in cards:
                    summary.register(tc)
                # the SLO layer's feed: a merged segment card is one
                # completion (one None test when metrics are off)
                metrics.completions(cards)
            if new >= ctx.num_videos:
                if old < ctx.num_videos:
                    if finalize is not None:
                        # an async stage (the mesh runner) counted its
                        # completions at dispatch: its device work is
                        # drained before the run is called complete, so
                        # a fault there fails it (INTERNAL_ERROR below)
                        finalize()
                        finalize = None
                    ctx.termination.raise_flag(
                        TerminationFlag.TARGET_NUM_VIDEOS_REACHED)
                break
        if hooks is not None:
            # the final flush may have contained failures or parked sheds
            _drain_stage_failures(ctx, hooks, summary)
    except Exception:
        traceback.print_exc()
        ctx.termination.raise_flag(TerminationFlag.INTERNAL_ERROR)
    finally:
        # retire prefetched decodes whose results will never be used
        for handle, non_tensors, _tc in pending:
            try:
                model.discard(handle, non_tensors)
            except Exception:
                traceback.print_exc()
        if model is not None and hasattr(model, "discard_pending"):
            try:
                model.discard_pending()
            except Exception:
                traceback.print_exc()
        if ctx.out_hedges is not None:
            # a hedge fired after the exit markers would strand behind them
            try:
                _linger_for_hedges(ctx)
            except Exception:
                traceback.print_exc()
        if ctx.out_queues is not None:
            for q_idx, out_queue in enumerate(ctx.out_queues):
                tracker = (ctx.out_trackers[q_idx]
                           if ctx.out_trackers is not None else None)
                if tracker is None or tracker.producer_finished():
                    markers = (tracker.num_markers if tracker is not None
                               else NUM_EXIT_MARKERS)
                    send_exit_markers(out_queue, markers, ctx.termination)
        if finalize is not None:
            # an async stage that did not end the run drains its device
            # work before the finish barrier all the same, so the
            # measured window covers every dispatch
            try:
                finalize()
            except Exception:
                traceback.print_exc()
                ctx.termination.raise_flag(TerminationFlag.INTERNAL_ERROR)
        for sink, attr in ((ctx.pad_sink, "padding"),
                           (ctx.ragged_sink, "ragged_stats"),
                           (ctx.staging_sink, "staging"),
                           (ctx.ingest_sink, "ingest_stats"),
                           (ctx.cache_sink, "cache")):
            value = getattr(model, attr, None)
            if sink is not None and value is not None:
                sink.append(value.snapshot() if hasattr(value, "snapshot")
                            else dict(value))
        if model is not None and ctx.compile_sink is not None:
            ctx.compile_sink.append(
                (ctx.step_idx, warmup_s, compile_tracker.snapshot()
                 if compile_tracker is not None else None))
        if controller is not None and ctx.autotune_sink is not None:
            # the stage is drained: the counters are final
            ctx.autotune_sink.append(controller.snapshot())
        graph_stats = getattr(model, "graph_stats", None)
        if graph_stats is not None and ctx.graph_sink is not None:
            ctx.graph_sink.append((ctx.step_idx, dict(graph_stats)))
        shard_stats = getattr(model, "shard_stats", None)
        if shard_stats is not None and ctx.shard_sink is not None:
            # the stage is drained: the merge counters are final
            ctx.shard_sink.append((ctx.step_idx, dict(shard_stats)))
        # the in-service item of an abort or a reached target
        if depth_owed and ctx.in_depths is not None:
            ctx.in_depths.dec(ctx.in_queue_idx, depth_owed)
        if depth_owed and ctx.health_board is not None:
            ctx.health_board.note_settle(ctx.in_queue_idx, depth_owed)
        if handoff is not None and ctx.handoff_sink is not None:
            ctx.handoff_sink.append(handoff.snapshot())
        if model is not None and ctx.placement_sink is not None:
            # the planner's measured cost; a sharded step adds its
            # degree, collective slice and memory floor
            if shard_stats is not None:
                ctx.placement_sink.append(CostRecord(
                    ctx.step_idx, busy[0], dispatches,
                    shard_degree=int(shard_stats["degree"]),
                    collective_s=float(shard_stats["collective_ms"]) / 1e3,
                    min_degree=max(1, int(shard_stats["min_degree"]))))
            else:
                ctx.placement_sink.append(CostRecord(ctx.step_idx, busy[0],
                                                     dispatches))
        try:
            ctx.fin_bar.wait()
        except threading.BrokenBarrierError:
            pass
        if summary is not None:
            if ctx.summary_sink is not None:
                ctx.summary_sink.append(summary)
            with open(logname(ctx.job_id, ctx.device.label, ctx.group_idx,
                              ctx.instance_idx, base=ctx.log_base),
                      "w") as f:
                summary.save_full_report(f)
            if ctx.print_progress:
                summary.print_summary(NUM_SUMMARY_SKIPS)
