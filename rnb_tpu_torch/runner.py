"""The stage executor: one thread per (step, group, device instance).

Counterpart of ``rnb_tpu/runner.py``, without the containment, health,
hedging, tracing and metrics layers of the JAX package (not yet
ported): an error escaping a stage stops the run with
``INTERNAL_ERROR`` — a decode error fails the run loudly.

The hot loop takes an item from the stage's input queue, runs the
stage, waits for its device work (the honest ``inference{i}_finish``
stamp, as the reference's ``stream.synchronize()``), checks the
produced payload against the stage's declared shapes, and publishes it
downstream — or, on the
final step, counts the completions and registers their TimeCards.
Accumulating stages (the fusing loader) get idle polls so a held batch
emits on its hold timeout, and are flushed at end of stream.
"""

from __future__ import annotations

import queue
import threading
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from rnb_tpu_torch.control import (NUM_EXIT_MARKERS, EdgeTracker,
                                   InferenceCounter, RingCredits,
                                   TerminationFlag, TerminationState,
                                   send_exit_markers)
from rnb_tpu_torch.devices import DeviceSpec
from rnb_tpu_torch.ops.ragged import check_segment_offsets
from rnb_tpu_torch.stage import RaggedBatch
from rnb_tpu_torch.telemetry import (TimeCardList, TimeCardSummary,
                                     cards_of, logname)
from rnb_tpu_torch.utils.class_utils import load_class

NUM_SUMMARY_SKIPS = 10  # steady-state summaries skip warm records
QUEUE_POLL_S = 0.05
#: floor for deadline-driven poll timeouts
MIN_POLL_S = 0.001


def poll_timeout(model) -> float:
    """The input-queue poll timeout: the stage's own next deadline
    (hold expiry / harvest tick), clamped to [MIN_POLL_S,
    QUEUE_POLL_S]; the coarse default for stages without one."""
    next_deadline = getattr(model, "next_deadline_s", None)
    deadline = next_deadline() if next_deadline is not None else None
    if deadline is None:
        return QUEUE_POLL_S
    return min(QUEUE_POLL_S, max(MIN_POLL_S, deadline))


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
    #: when set, the final step stores each request's output rows here:
    #: request id -> (video path, float32 numpy rows)
    outputs_sink: Optional[Dict[int, tuple]] = None


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


def _store_outputs(sink: Dict[int, tuple], payload, time_card) -> None:
    """Copy each request's output rows to the host sink. A fused
    emission packs its requests' rows in card order."""
    pb = payload[0]
    cards = cards_of(time_card)
    if isinstance(pb, RaggedBatch):
        offsets = pb.segment_offsets
    else:
        offsets = [0]
        for tc in cards:
            offsets.append(offsets[-1] + int(tc.num_clips))
    rows = pb.data[:offsets[-1]].to(torch.float32).cpu().numpy()
    for i, tc in enumerate(cards):
        sink[tc.id] = (tc.video, rows[offsets[i]:offsets[i + 1]])


def _publish(ctx: RunnerContext, payload, non_tensors, time_card,
             out_counter: int) -> bool:
    """Hand one item to the next step (round robin over out queues,
    one ring credit per payload). False when the job died waiting."""
    if payload and not ctx.credits.acquire(ctx.termination):
        return False
    out_queue = ctx.out_queues[out_counter % len(ctx.out_queues)]
    try:
        out_queue.put_nowait((payload, non_tensors, time_card,
                              ctx.credits if payload else None))
    except queue.Full:
        ctx.termination.raise_flag(TerminationFlag.FRAME_QUEUE_FULL)
        return False
    return True


def runner(ctx: RunnerContext) -> None:
    """Thread entry: build the stage, run the hot loop, drain."""
    summary = TimeCardSummary() if ctx.out_queues is None else None
    model = None
    declared = None
    try:
        model_class = load_class(ctx.model_class_path)
        model = model_class(ctx.device, **ctx.model_kwargs)
        declared = model_class.output_shape_for(**ctx.model_kwargs)
    except Exception:
        traceback.print_exc()
        ctx.termination.raise_flag(TerminationFlag.INTERNAL_ERROR)
        model = None

    try:
        ctx.sta_bar.wait()
    except threading.BrokenBarrierError:
        pass

    idle_poll = getattr(model, "poll", None)
    take_ready = getattr(model, "take_ready", None)
    where = "step %d %s" % (ctx.step_idx, ctx.model_class_path)
    key_start = "inference%d_start" % ctx.step_idx
    key_finish = "inference%d_finish" % ctx.step_idx
    key_runner = "runner%d_start" % ctx.step_idx
    saw_marker = False
    out_counter = 0
    try:
        while model is not None and not ctx.termination.terminated:
            result = take_ready() if take_ready is not None else None
            if result is None and saw_marker:
                result = model.flush() if hasattr(model, "flush") else None
                if result is None or result[2] is None:
                    break
            elif result is None:
                try:
                    item = ctx.in_queue.get(timeout=poll_timeout(model))
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
                    time_card.record(key_start)
                    result = model(payload, non_tensors, time_card)
            tensors_out, non_tensors_out, time_card = result
            if time_card is None:
                continue  # the stage swallowed the item
            validate_payload(declared, tensors_out, where)
            if tensors_out:
                _sync(tensors_out)
            time_card.record(key_finish)
            if ctx.out_queues is not None:
                if not _publish(ctx, tensors_out, non_tensors_out,
                                time_card, out_counter):
                    break
                out_counter += 1
                continue
            # final step: count completions, detect the target
            if ctx.outputs_sink is not None:
                _store_outputs(ctx.outputs_sink, tensors_out, time_card)
            n = len(time_card) if isinstance(time_card, TimeCardList) else 1
            old, new = ctx.counter.add(n)
            for tc in cards_of(time_card):
                summary.register(tc)
            if new >= ctx.num_videos:
                if old < ctx.num_videos:
                    ctx.termination.raise_flag(
                        TerminationFlag.TARGET_NUM_VIDEOS_REACHED)
                break
    except Exception:
        traceback.print_exc()
        ctx.termination.raise_flag(TerminationFlag.INTERNAL_ERROR)
    finally:
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
                           (ctx.staging_sink, "staging")):
            value = getattr(model, attr, None)
            if sink is not None and value is not None:
                sink.append(value.snapshot() if hasattr(value, "snapshot")
                            else dict(value))
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
