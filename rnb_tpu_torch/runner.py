"""The stage executor: one thread per (step, group, device instance).

Counterpart of ``rnb_tpu/runner.py``, without the replica lanes, health
board and hedging of the JAX package (not yet ported).

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
final step, counts the completions and registers their TimeCards.
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
from rnb_tpu_torch.faults import (FATAL, TRANSIENT, classify_error,
                                  fault_reason)
from rnb_tpu_torch.health import DirectPayload, deadline_site
from rnb_tpu_torch.health import expired as deadline_expired
from rnb_tpu_torch.ops.ragged import check_segment_offsets
from rnb_tpu_torch.selector import DEFAULT_QUEUE_SELECTOR
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


#: the cache stamps the outputs sink records per request
OUTPUT_STAMPS = ("cache_hit", "cache_coalesced", "feature_hit")


def _store_outputs(sink: Dict[int, tuple], payload, non_tensors,
                   time_card) -> None:
    """Copy each request's output rows to the host sink, with its cache
    stamps. A request's rows are ``[row0, row0 + num_clips)`` of the
    emission, as the last batching stage stamped them: a coalesced
    follower shares its leader's rows, so an emission may hold more
    cards than row segments. A stage that emits no tensor stores its
    non-tensor payload (the single step's class id)."""
    cards = cards_of(time_card)
    if not payload:
        for tc in cards:
            sink[tc.id] = (tc.video, non_tensors,
                           {k: getattr(tc, k) for k in OUTPUT_STAMPS})
        return
    pb = payload[0]
    end = max(tc.row0 + int(tc.num_clips) for tc in cards)
    rows = pb.data[:end].to(torch.float32).cpu().numpy()
    for tc in cards:
        sink[tc.id] = (tc.video, rows[tc.row0:tc.row0 + int(tc.num_clips)],
                       {k: getattr(tc, k) for k in OUTPUT_STAMPS})


def _publish(ctx: RunnerContext, out_queue, payload, non_tensors,
             time_card) -> bool:
    """Hand one item to the next step on ``out_queue``: as it is, or as
    ``num_segments`` segments, each with its own forked card and its own
    ring credit. The segments are views of the stage's output: each
    consumer keeps the tensor alive by its reference and orders the
    caching allocator's reuse of it after its own stream
    (``record_stream``), so no segment is copied. A full queue stops the
    run under the ``"abort"`` policy (an overflow counted on the edge);
    under ``"shed"`` the item passed the shed check, so it waits for
    room (bounded backpressure). False when the job died."""
    k = ctx.num_segments
    segments = (split_segments(payload, k) if payload and k > 1
                else [payload] * k)
    for seg_idx, seg_payload in enumerate(segments):
        if seg_payload and not ctx.credits.acquire(ctx.termination):
            return False
        card = time_card.fork(seg_idx) if k > 1 else time_card
        item = (seg_payload, non_tensors, card,
                ctx.credits if seg_payload else None)
        if ctx.overload_policy == "shed":
            while True:
                try:
                    out_queue.put(item, timeout=QUEUE_POLL_S)
                    break
                except queue.Full:
                    if ctx.termination.terminated:
                        return False
            continue
        try:
            out_queue.put_nowait(item)
        except queue.Full:
            if ctx.fault_stats is not None:
                ctx.fault_stats.record_overflow(
                    "step%d->step%d" % (ctx.step_idx, ctx.step_idx + 1))
            ctx.termination.raise_flag(TerminationFlag.FRAME_QUEUE_FULL)
            return False
    return True


def _release_pins(cards) -> None:
    """A dropped card's feature-page pin goes with it (the runner would
    have released it after its gather)."""
    for tc in cards:
        plan = getattr(tc, "feature_plan", None)
        if plan is not None:
            tc.feature_plan = None
            plan.release()


def _contain_failure(ctx: RunnerContext, time_card, reason: str,
                     summary) -> None:
    """Dead-letter one item's request(s): stamp the cards failed, record
    them in the job's ledger and count them toward the run target (a
    failed request never produces the completion the target waits for)."""
    cards = cards_of(time_card)
    _release_pins(cards)
    for tc in cards:
        if tc.status == "ok":
            tc.mark_failed(reason)
    if ctx.fault_stats is not None:
        ctx.fault_stats.record_failure([tc.id for tc in cards],
                                       ctx.step_idx, reason)
    if summary is not None:
        summary.note_failure(reason, len(cards))
    dispose_requests(ctx.counter, ctx.num_videos, ctx.termination,
                     len(cards))


def _shed(ctx: RunnerContext, time_card, site: str, summary,
          expired: bool = False) -> None:
    """Drop one item at ``site``: stamped, counted in the fault ledger
    (and, for an ``expired`` deadline, in the deadline ledger, which
    ``parse_utils`` cross-foots with it) and disposed toward the target."""
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
                handle, summary, key_start: str, tr_model_call: str):
    """One dispatch of the stage under the fault plan and the retry
    budget: the plan's stall before the inference span, then per attempt
    its latency or error and the call (``complete`` of a prefetched
    decode on the first attempt, the stage itself on a retry). Returns
    the stage's result, or None when the item was dead-lettered."""
    rids = None
    if ctx.fault_plan is not None:
        # a fault matching any constituent hits the whole dispatch
        rids = [tc.id for tc in cards_of(time_card)]
        stall = ctx.fault_plan.stall_ms(ctx.step_idx, rids)
        if stall > 0:
            time.sleep(stall / 1000.0)
    time_card.record(key_start)
    attempt = 0
    while True:
        try:
            with hostprof.section(tr_model_call), \
                    trace.span(tr_model_call, _rid(time_card)):
                if ctx.fault_plan is not None:
                    ctx.fault_plan.fire(ctx.step_idx, rids, attempt)
                if handle is not None:
                    return model.complete(handle, non_tensors, time_card)
                return model(payload, non_tensors, time_card)
        except Exception as exc:
            if handle is not None:
                # a retry decodes again on the synchronous path: the
                # prefetched decode is retired, its rows released
                model.discard(handle, non_tensors)
                handle = None
            kind = classify_error(exc)
            if kind is FATAL or not ctx.containment:
                raise
            retry = kind is TRANSIENT and attempt < ctx.max_retries
            if not retry and getattr(time_card, "sub_id", None) is not None:
                # a segment stays fail-fast past its retries: one
                # dead-lettered segment would strand its siblings
                raise
            if retry:
                attempt += 1
                if ctx.fault_stats is not None:
                    ctx.fault_stats.record_retries(1)
                if summary is not None:
                    summary.note_retries(1)
                if ctx.retry_backoff_ms > 0:
                    time.sleep(ctx.retry_backoff_ms / 1000.0)
                continue
            reason = fault_reason(exc)
            if kind is TRANSIENT:
                reason = "retries-exhausted:" + reason
            _contain_failure(ctx, time_card, reason, summary)
            return None


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
    warmup_s = 0.0
    try:
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
        # the stage's cache and staging pool become poll sources of the
        # live-metrics registry before the barrier (no-op when off)
        metrics.register_stage(model)
        # its compute profile becomes the step's meter and its byte
        # owners ledger sources, before the barrier so every sample
        # covers them (no-op when devobs is off)
        devobs.register_stage(model, ctx.step_idx, ctx.device)
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
    saw_marker = False
    uploader = None  # built at the first DirectPayload item
    try:
        while model is not None and not ctx.termination.terminated:
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
                    if idle_poll is None:
                        continue
                    result = idle_poll()
                    if result is None or result[2] is None:
                        continue
                    item = False
                if item is None:
                    saw_marker = True
                    continue
                if item is not False:
                    payload, non_tensors, time_card, credits = item
                    if credits is not None:
                        credits.release()
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
                        # host rows off the network edge: to the card on
                        # this thread's stream, ahead of the forward
                        if uploader is None:
                            uploader = PinnedUpload(ctx.device.resolve())
                        payload = tuple(
                            dataclasses.replace(pb, data=uploader.upload(
                                pb.data)) for pb in payload.payload)
                    result = _call_stage(ctx, model, payload, non_tensors,
                                         time_card, None, summary,
                                         key_start, tr_model_call)
                    if result is None:
                        continue  # dead-lettered
                    arrival = True
                    if result[2] is None:
                        trace.instant(tr_swallow, rid=_rid(time_card))
            tensors_out, non_tensors_out, time_card = result
            if time_card is None:
                continue  # the stage swallowed the item
            validate_payload(declared, tensors_out, where)
            if tensors_out:
                with hostprof.section(tr_device_sync), \
                        trace.span(tr_device_sync, _rid(time_card)):
                    _sync(tensors_out)
            time_card.record(key_finish)
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
                    out_queue = ctx.out_queues[selector.select(
                        tensors_out, non_tensors_out, time_card)]
                    if _overloaded(ctx, out_queue, time_card):
                        _shed(ctx, time_card,
                              "step%d_out_queue" % ctx.step_idx, summary)
                        continue
                    published = _publish(ctx, out_queue, tensors_out,
                                         non_tensors_out, time_card)
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
        if ctx.out_queues is not None:
            for q_idx, out_queue in enumerate(ctx.out_queues):
                tracker = (ctx.out_trackers[q_idx]
                           if ctx.out_trackers is not None else None)
                if tracker is None or tracker.producer_finished():
                    markers = (tracker.num_markers if tracker is not None
                               else NUM_EXIT_MARKERS)
                    send_exit_markers(out_queue, markers, ctx.termination)
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
