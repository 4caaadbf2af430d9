"""Request-scoped tracing: per-request event timelines and their tables.

Counterpart of ``rnb_tpu/telemetry.py``. Every request carries a
:class:`TimeCard`; each stage stamps named events on it
(``runner{i}_start``, ``inference{i}_start``, ``inference{i}_finish``)
and appends its device label to the card's trail. A fused dispatch
stamps all of its requests at once through :class:`TimeCardList`. The
final step's :class:`TimeCardSummary` writes the per-instance timing
table in the JAX package's text format: one header line of event keys
and ``device{step}`` columns, one row per request, then trailers.

Besides the event stamps, the loader stamps a card's content: its clip
rows (``num_clips``), the first row of its request's rows in the
emission (``row0``; a coalesced follower shares its leader's rows), and
the cache outcome: ``cache_hit`` (True/False on a cache-enabled loader,
None otherwise), ``cache_coalesced`` (the request shared another's
in-flight decode) and ``feature_hit`` (answered from feature pages; the
forward never ran for it). Two transient carriers take live pager state
from the loader to the consuming stage, which pops them:
``feature_plan`` (a feature hit's pinned gather plan) and
``feature_insert`` (the (content key, row0, rows) insert the runner
performs after its forward returned).

A step with ``num_segments`` k publishes each item as k segments, each
with its own card forked from the item's (:meth:`TimeCard.fork`); the
aggregating step merges the k cards back into one
(:meth:`TimeCard.merge`): stamps recorded before the fork appear once,
stamps after it once per segment with a ``-{sub_id}`` suffix.

The module also declares the names the tracing layer emits
(:data:`TRACE_EVENT_REGISTRY`), every timing stamp
(:data:`STAMP_REGISTRY`; those only a traced run records are
:data:`TRACE_STAMP_REGISTRY`), the card carriers a fork must not copy
(:data:`TRANSIENT_STAMPS`), the timing tables' trailers
(:data:`TABLE_TRAILER_REGISTRY`), the live-metric series the metrics
plane may hold (:data:`METRIC_REGISTRY`; the registry raises on any
other name) and the log-meta lines (:data:`META_LINE_REGISTRY`).
rnb-lint's schema family (:mod:`rnb_tpu_torch.analysis.schema`)
cross-checks them against the sites that write and the reader.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict, namedtuple
from typing import IO, List, Optional, Sequence


def logroot(job_id: str, base: str = "logs") -> str:
    """Directory holding every artifact of one benchmark job."""
    path = os.path.join(base, str(job_id))
    os.makedirs(path, exist_ok=True)
    return path


def logmeta(job_id: str, base: str = "logs") -> str:
    """Path of the job metadata file (args, wall time, termination)."""
    return os.path.join(logroot(job_id, base), "log-meta.txt")


def logname(job_id: str, device_label: str, group_idx: int,
            instance_idx: int, base: str = "logs") -> str:
    """Path of one final-step instance's timing table."""
    safe = str(device_label).replace(":", "").replace("/", "-")
    return os.path.join(
        logroot(job_id, base),
        "%s-group%d-%d.txt" % (safe, group_idx, instance_idx))


def latency_percentiles(latencies_ms: Sequence[float],
                        percentiles=(50.0, 99.0)):
    """{percentile: value_ms} over a latency sample; {} when empty."""
    import numpy as np
    if not latencies_ms:
        return {}
    return {p: float(np.percentile(latencies_ms, p)) for p in percentiles}


#: the per-request content stamps a fork carries to every segment and
#: a merge keeps once: the loader's clip rows, video path and first
#: row, the cache outcome, and the pad rows its emission shipped (set
#: on the card by the batching stages). The transient carriers
#: ``feature_plan`` / ``feature_insert`` hold live page pins and insert
#: obligations a fork would double-own, so they are not among them.
CONTENT_STAMPS = ("num_clips", "video", "row0", "cache_hit",
                  "cache_coalesced", "feature_hit", "pad_rows",
                  # the absolute wall-clock deadline the client stamps
                  # under the root ``deadline`` key (absent otherwise)
                  "deadline_s",
                  # times the request was drained off an evicted replica
                  # lane onto a sibling (rnb_tpu_torch.health)
                  "redispatched",
                  # True on the clone card of a hedged re-dispatch: the
                  # claim site attributes the win to it or the original
                  "hedge_copy",
                  # set once a copy claimed the win: a later disposal of
                  # the same copy must not claim again
                  "hedge_resolved")


class TimeCard:
    """An ordered event -> timestamp record riding along with one
    request, plus the trail of devices it visited."""

    def __init__(self, id: int):
        self.timings: "OrderedDict[str, float]" = OrderedDict()
        self.id = id
        #: the segment a fork belongs to, and how many stamps its parent
        #: held at the fork (None on a card that is not a fork)
        self.sub_id: Optional[int] = None
        self.num_parent_timings: Optional[int] = None
        #: one entry per pipeline step traversed: a tuple of labels
        #: (a singleton until a merge joins segments that ran on
        #: different devices)
        self.devices: List[tuple] = []
        #: clip rows the loader sampled for this request
        self.num_clips = 0
        #: the request's video path, stamped by the loader
        self.video: Optional[str] = None
        #: first row of this request's rows in its emission
        self.row0 = 0
        #: the cache outcome: None without a clip cache
        self.cache_hit: Optional[bool] = None
        self.cache_coalesced = False
        self.feature_hit = False
        self.feature_plan = None
        self.feature_insert = None
        #: the request's outcome: "ok" until the containment layer
        #: stamps it "failed" (dead-lettered) or "shed"
        self.status = "ok"
        self.failure_reason: Optional[str] = None

    def mark_failed(self, reason: str) -> None:
        """Stamp this request dead-lettered."""
        self.status = "failed"
        self.failure_reason = str(reason)

    def mark_shed(self, site: str) -> None:
        """Stamp this request shed (overload or an expired deadline)."""
        self.status = "shed"
        self.failure_reason = str(site)

    def record(self, key: str, at: Optional[float] = None) -> None:
        """Stamp ``key`` with the wall clock (or a given instant)."""
        self.timings[key] = time.time() if at is None else at

    def add_device(self, device_label: str) -> None:
        self.devices.append((device_label,))

    def fork(self, sub_id: int) -> "TimeCard":
        """Clone this card for one parallel segment: the same id, a copy
        of the stamps, the content stamps and the device trail, and the
        fork point, so :meth:`merge` knows which stamps are shared. A
        fork cannot be forked again: merge first."""
        if self.sub_id is not None:
            raise RuntimeError(
                "cannot fork TimeCard(id=%s) twice: it is already a fork "
                "with sub_id=%s; merge first" % (self.id, self.sub_id))
        child = TimeCard(self.id)
        child.timings = OrderedDict(self.timings)
        child.sub_id = sub_id
        child.num_parent_timings = len(self.timings)
        for attr in CONTENT_STAMPS:
            if hasattr(self, attr):
                setattr(child, attr, getattr(self, attr))
        child.devices = list(self.devices)
        child.status = self.status
        child.failure_reason = self.failure_reason
        return child

    @staticmethod
    def merge(time_cards: Sequence["TimeCard"]) -> "TimeCard":
        """Join sibling forks into one card. They must carry the same
        stamp keys and the same fork point, with distinct sub_ids.
        Stamps before the fork are kept once; stamps after it once per
        sibling with a ``-{sub_id}`` suffix, in sub_id order. Device
        trails are zipped step by step: a step every sibling ran on one
        device collapses to that device, else the tuple is kept."""
        if not time_cards:
            raise ValueError("merge() needs at least one TimeCard")
        first = time_cards[0]
        keys = list(first.timings.keys())
        fork_point = first.num_parent_timings
        seen_sub_ids = set()
        for tc in time_cards:
            if tc.sub_id is None:
                raise RuntimeError(
                    "cannot merge TimeCard(id=%s): not a fork (sub_id is "
                    "None); only sibling forks can be merged" % tc.id)
            if tc.sub_id in seen_sub_ids:
                raise RuntimeError(
                    "cannot merge TimeCards with duplicate sub_id=%s"
                    % tc.sub_id)
            seen_sub_ids.add(tc.sub_id)
        for tc in time_cards[1:]:
            if list(tc.timings.keys()) != keys:
                raise RuntimeError(
                    "cannot merge TimeCards with different timing keys: "
                    "%s != %s" % (keys, list(tc.timings.keys())))
            if tc.num_parent_timings != fork_point:
                raise RuntimeError(
                    "cannot merge TimeCards forked at different points: "
                    "%s != %s" % (fork_point, tc.num_parent_timings))
        ordered = sorted(time_cards, key=lambda tc: tc.sub_id)
        merged = TimeCard(first.id)
        for key_idx, key in enumerate(keys):
            if fork_point is not None and key_idx < fork_point:
                merged.timings[key] = ordered[0].timings[key]
            else:
                for tc in ordered:
                    merged.timings["%s-%s" % (key, tc.sub_id)] = \
                        tc.timings[key]
        for step_devices in zip(*[tc.devices for tc in ordered]):
            flat = tuple(d for tpl in step_devices for d in tpl)
            merged.devices.append((flat[0],) if len(set(flat)) == 1
                                  else flat)
        for attr in CONTENT_STAMPS:
            if hasattr(ordered[0], attr):
                setattr(merged, attr, getattr(ordered[0], attr))
        for tc in ordered:
            # one failed segment fails the merged request
            if tc.status != "ok":
                merged.status = tc.status
                merged.failure_reason = tc.failure_reason
                break
        return merged


class TimeCardList:
    """The cards of one fused dispatch: one event, one instant, stamped
    on every constituent request."""

    def __init__(self, time_cards: List[TimeCard]):
        self.time_cards = time_cards

    def record(self, key: str, at: Optional[float] = None) -> None:
        at = time.time() if at is None else at
        for tc in self.time_cards:
            tc.record(key, at=at)

    def add_device(self, device_label: str) -> None:
        for tc in self.time_cards:
            tc.add_device(device_label)

    def fork(self, sub_id: int) -> "TimeCard":
        raise NotImplementedError("TimeCardLists cannot be forked")

    def __len__(self) -> int:
        return len(self.time_cards)


def cards_of(time_card) -> List[TimeCard]:
    """The individual cards behind one item (a fused list or a card)."""
    if isinstance(time_card, TimeCardList):
        return list(time_card.time_cards)
    return [time_card]


class TimeCardSummary:
    """Columnar accumulator over one final-step instance's completed
    requests; every card must carry the same event-key sequence."""

    def __init__(self):
        self.summary: "OrderedDict[str, List[float]]" = OrderedDict()
        self.keys: List[str] = []
        self.devices_per_inference: List[List[tuple]] = []
        self.clip_counts: List[int] = []
        self.num_pad_rows = 0
        self.num_pad_tracked = 0
        #: registered cards with a cache_hit stamp, the hits among
        #: them, and the coalesced followers (the `# cache` trailer)
        self.num_cache_hits = 0
        self.num_cache_coalesced = 0
        self.num_cache_tracked = 0
        #: the ``# phases`` trailer, on traced runs only (the executor
        #: opts the summary in), over records after the skip
        self.track_phases = False
        self.phase_num_skips = 0
        #: the ``# critpath`` trailer, on critpath runs only (root
        #: ``critpath`` key), over records after the skip
        self.track_critpath = False
        self.critpath_num_skips = 0
        #: requests this instance dead-lettered, shed and retried (the
        #: ``# faults`` trailer); latencies stay over successes only
        self.num_failed = 0
        self.num_shed = 0
        self.num_retries = 0
        self.failure_reasons: "OrderedDict[str, int]" = OrderedDict()
        #: per record: did the hedge clone win it, and how often was it
        #: drained off an evicted lane (the critical-path aggregation's
        #: hedged and redispatched counts)
        self.hedge_flags: List[bool] = []
        self.redispatch_counts: List[int] = []

    def note_failure(self, reason: str, n: int = 1) -> None:
        """Count a dead-lettered request (it has no timing row)."""
        self.num_failed += n
        self.failure_reasons[reason] = \
            self.failure_reasons.get(reason, 0) + n

    def note_shed(self, n: int = 1) -> None:
        self.num_shed += n

    def note_retries(self, n: int = 1) -> None:
        self.num_retries += n

    def register(self, time_card: TimeCard) -> None:
        if not self.summary:
            self.keys = list(time_card.timings.keys())
            for key in self.keys:
                self.summary[key] = []
        if self.keys != list(time_card.timings.keys()):
            raise AssertionError(
                "TimeCard key sequence changed mid-run: %s != %s"
                % (self.keys, list(time_card.timings.keys())))
        for key, ts in time_card.timings.items():
            self.summary[key].append(ts)
        self.devices_per_inference.append(time_card.devices)
        # clips count device work: a coalesced follower's rows were
        # computed once, on its leader's card, so it adds none
        coalesced = getattr(time_card, "cache_coalesced", False)
        self.clip_counts.append(0 if coalesced
                                else int(time_card.num_clips))
        hit = getattr(time_card, "cache_hit", None)
        if hit is not None:
            self.num_cache_tracked += 1
            self.num_cache_hits += int(bool(hit))
        self.num_cache_coalesced += int(bool(coalesced))
        pad = getattr(time_card, "pad_rows", None)
        if pad is not None:
            self.num_pad_tracked += 1
            self.num_pad_rows += int(pad)
        self.hedge_flags.append(bool(getattr(time_card, "hedge_copy",
                                             False)))
        self.redispatch_counts.append(int(getattr(time_card, "redispatched",
                                                  0)))

    def total_clips(self) -> int:
        return sum(self.clip_counts)

    def num_records(self) -> int:
        return len(self.summary[self.keys[0]]) if self.keys else 0

    def mean_gaps_ms(self, num_skips: int = 0):
        """[(prev_key, next_key, mean_ms)] over records after
        ``num_skips``."""
        import numpy as np
        out = []
        for prv, nxt in zip(self.keys[:-1], self.keys[1:]):
            if len(self.summary[prv]) <= num_skips:
                return out
            gap = np.mean(
                (np.asarray(self.summary[nxt][num_skips:])
                 - np.asarray(self.summary[prv][num_skips:])) * 1000.0)
            out.append((prv, nxt, float(gap)))
        return out

    def latencies_ms(self, num_skips: int = 0) -> List[float]:
        """Per-record end-to-end latency (first event -> last) in ms."""
        import numpy as np
        if len(self.keys) < 2:
            return []
        first = np.asarray(self.summary[self.keys[0]][num_skips:])
        last = np.asarray(self.summary[self.keys[-1]][num_skips:])
        return ((last - first) * 1000.0).tolist()

    def print_summary(self, num_skips: int) -> None:
        gaps = self.mean_gaps_ms(num_skips)
        if not gaps and self.keys:
            print("Not enough log entries (%d records) to print summary!"
                  % self.num_records())
        for prv, nxt, ms in gaps:
            print("Average time between %s and %s: %f ms" % (prv, nxt, ms))
        if self.num_failed or self.num_shed or self.num_retries:
            print("Contained faults: %d failed, %d shed, %d retries (%s)"
                  % (self.num_failed, self.num_shed, self.num_retries,
                     ", ".join("%s=%d" % kv
                               for kv in self.failure_reasons.items())
                     or "no failures"))

    def faults_line(self) -> Optional[str]:
        """The ``# faults`` trailer, or None when every request of the
        instance succeeded (the reference's format)."""
        if not (self.num_failed or self.num_shed or self.num_retries):
            return None
        parts = ["# faults num_failed=%d num_shed=%d num_retries=%d"
                 % (self.num_failed, self.num_shed, self.num_retries)]
        parts.extend("reason:%s=%d" % kv
                     for kv in self.failure_reasons.items())
        return " ".join(parts)

    def padding_line(self) -> Optional[str]:
        if not self.num_pad_tracked:
            return None
        return ("# padding pad_rows=%d num_tracked=%d"
                % (self.num_pad_rows, self.num_pad_tracked))

    def cache_line(self) -> Optional[str]:
        """The ``# cache`` trailer, or None on a cacheless run; written
        even at zero hits (a zero hit rate is a result)."""
        if not self.num_cache_tracked:
            return None
        return ("# cache num_hits=%d num_coalesced=%d num_tracked=%d"
                % (self.num_cache_hits, self.num_cache_coalesced,
                   self.num_cache_tracked))

    def steady_rows(self, num_skips: int = 0):
        """``(timings, hedged, redispatched)`` of each record after
        ``num_skips``, in registration order: the critical-path
        aggregation's input (its stamp mapping and the claim ledger's
        content stamps)."""
        if len(self.keys) < 2:
            return
        columns = [self.summary[key][num_skips:] for key in self.keys]
        hedges = self.hedge_flags[num_skips:]
        redisps = self.redispatch_counts[num_skips:]
        for idx, row in enumerate(zip(*columns)):
            yield (dict(zip(self.keys, row)),
                   hedges[idx] if idx < len(hedges) else False,
                   redisps[idx] if idx < len(redisps) else 0)

    def critpath_line(self) -> Optional[str]:
        """The ``# critpath`` trailer (microseconds blocked per
        ``<class><step>`` segment), or None off critpath runs or without
        a decomposable record."""
        if not self.track_critpath:
            return None
        from rnb_tpu_torch.critpath import trailer_totals
        n, totals = trailer_totals(
            timings for timings, _hedged, _redisp
            in self.steady_rows(self.critpath_num_skips))
        if not n:
            return None
        return " ".join(["# critpath n=%d" % n] + [
            "%s_us=%d" % (key, totals[key]) for key in sorted(totals)])

    def phase_samples(self, num_skips: int = 0):
        """{phase: [per-request ms]} over records after ``num_skips``:
        :func:`rnb_tpu_torch.trace.attribute_phases` of each row, whose
        phases sum to the row's end-to-end latency."""
        from rnb_tpu_torch.trace import attribute_phases
        samples: "OrderedDict[str, List[float]]" = OrderedDict()
        if len(self.keys) < 2:
            return samples
        columns = [self.summary[key][num_skips:] for key in self.keys]
        for row in zip(*columns):
            for phase, ms in attribute_phases(
                    dict(zip(self.keys, row))).items():
                samples.setdefault(phase, []).append(ms)
        return samples

    def phases_line(self) -> Optional[str]:
        """The ``# phases`` trailer (microsecond means and p99s), or None
        off traced runs or without records."""
        if not self.track_phases:
            return None
        from rnb_tpu_torch.trace import phase_stats, sorted_phases
        stats = phase_stats(self.phase_samples(self.phase_num_skips))
        if not stats:
            return None
        parts = ["# phases n=%d" % max(s["count"] for s in stats.values())]
        for phase in sorted_phases(stats):
            parts.append("%s_mean_us=%d"
                         % (phase, round(stats[phase]["mean_ms"] * 1000)))
            parts.append("%s_p99_us=%d"
                         % (phase, round(stats[phase]["p99_ms"] * 1000)))
        return " ".join(parts)

    def save_full_report(self, fp: IO[str]) -> None:
        # a merge keeps a step's devices as a tuple where the segments
        # ran on different ones: each step gets the widest record's
        # columns, narrower rows padded with '-', so the table stays
        # rectangular
        num_steps = max((len(d) for d in self.devices_per_inference),
                        default=0)
        widths = [0] * num_steps
        for devices_per_step in self.devices_per_inference:
            for step_idx, step_devices in enumerate(devices_per_step):
                widths[step_idx] = max(widths[step_idx], len(step_devices))
        fp.write(" ".join(self.keys))
        for step_idx, width in enumerate(widths):
            if width > 1:
                for sub_id in range(width):
                    fp.write(" device%d-%d" % (step_idx, sub_id))
            else:
                fp.write(" device%d" % step_idx)
        fp.write("\n")
        for row, devices_per_step in zip(zip(*self.summary.values()),
                                         self.devices_per_inference):
            fp.write(" ".join(map(str, row)))
            for step_idx, width in enumerate(widths):
                step_devices = (devices_per_step[step_idx]
                                if step_idx < len(devices_per_step) else ())
                for col in range(width):
                    fp.write(" %s" % (step_devices[col]
                                      if col < len(step_devices) else "-"))
            fp.write("\n")
        for trailer in (self.faults_line(), self.cache_line(),
                        self.padding_line(), self.phases_line(),
                        self.critpath_line()):
            if trailer is not None:
                fp.write(trailer + "\n")


#: one declared telemetry name: ``pattern`` uses ``{step}`` for the
#: pipeline-step or queue index
StampSpec = namedtuple("StampSpec", ("pattern", "producer", "description"))

#: the stamps a traced run adds to the loaders' cards (root ``trace``
#: key): they split a loader's ``inference{step}`` span into decode,
#: hold, transfer and drain for the phase attribution
TRACE_STAMP_REGISTRY = (
    StampSpec("decode{step}_done", "rnb_tpu_torch/models/r2p1d/model.py",
              "this request's clip decode completed (a hit records a "
              "zero-length decode phase)"),
    StampSpec("transfer{step}_start", "rnb_tpu_torch/models/r2p1d/model.py",
              "the emission holding this request closed and its "
              "host->device transfer began"),
    StampSpec("transfer{step}_done", "rnb_tpu_torch/models/r2p1d/model.py",
              "host->device transfer confirmed; the gap to "
              "inference{step}_finish is the device step and publish"),
)

#: every TimeCard timing-stamp pattern any code path may record: the
#: executor's and the client's on every run, and the traced run's
#: refinement stamps (the reference's registry)
STAMP_REGISTRY = (
    StampSpec("enqueue_filename", "rnb_tpu_torch/client.py",
              "client created the request and enqueued its video path"),
    StampSpec("runner{step}_start", "rnb_tpu_torch/runner.py",
              "stage executor popped the request off its input queue"),
    StampSpec("inference{step}_start", "rnb_tpu_torch/runner.py",
              "stage model call began"),
    StampSpec("inference{step}_finish", "rnb_tpu_torch/runner.py",
              "stage model call returned (device work waited for unless "
              "the step is async)"),
) + TRACE_STAMP_REGISTRY

#: card-riding carriers that are deliberately not content stamps: each
#: holds single-owner live state (a feature hit's pinned gather plan,
#: the insert the runner owes after its forward) that a fork would
#: double-own, so :meth:`TimeCard.fork` never copies them
TRANSIENT_STAMPS = ("feature_plan", "feature_insert")

#: every ``# <kind> ...`` trailer a per-instance timing table may carry
#: (:meth:`TimeCardSummary.save_full_report`)
TABLE_TRAILER_REGISTRY = (
    StampSpec("faults", "rnb_tpu_torch/telemetry.py",
              "per-instance failed/shed/retry counts and reasons"),
    StampSpec("cache", "rnb_tpu_torch/telemetry.py",
              "per-instance completed-request cache attribution"),
    StampSpec("phases", "rnb_tpu_torch/telemetry.py",
              "per-instance per-phase latency attribution (traced runs "
              "only)"),
    StampSpec("padding", "rnb_tpu_torch/telemetry.py",
              "per-instance pad rows shipped with completed requests"),
    StampSpec("critpath", "rnb_tpu_torch/telemetry.py",
              "per-instance blocking-chain totals (critpath runs only)"),
)

#: every span, instant and counter name the port's tracing layer
#: (rnb_tpu_torch.trace) may write into ``logs/<job>/trace.json``
TRACE_EVENT_REGISTRY = (
    StampSpec("client.enqueue", "rnb_tpu_torch/client.py",
              "instant: the client created and enqueued one request"),
    StampSpec("client.enqueued", "rnb_tpu_torch/client.py",
              "counter: requests the client has emitted"),
    StampSpec("client.shed", "rnb_tpu_torch/client.py",
              "instant: the client shed a request at the full filename "
              "queue (overload_policy shed)"),
    StampSpec("exec{step}.queue_get", "rnb_tpu_torch/runner.py",
              "span: executor blocked on its input queue"),
    StampSpec("exec{step}.hold_wait", "rnb_tpu_torch/runner.py",
              "span: executor idle while its stage holds work (a batch "
              "filling)"),
    StampSpec("exec{step}.swallow", "rnb_tpu_torch/runner.py",
              "instant: one request admitted into the stage"),
    StampSpec("exec{step}.model_call", "rnb_tpu_torch/runner.py",
              "span: the stage call for one dispatch"),
    StampSpec("exec{step}.device_sync", "rnb_tpu_torch/runner.py",
              "span: waiting for the stage's device work"),
    StampSpec("exec{step}.publish", "rnb_tpu_torch/runner.py",
              "span: route, segment split and downstream enqueue"),
    StampSpec("exec{step}.collective", "rnb_tpu_torch/models/r2p1d/model.py",
              "span: a sharded head stage's merge gather of its logits' "
              "column blocks, host-timed after the forward was waited for "
              "(declared shard_degree > 1 only; nested inside the step's "
              "model_call span)"),
    StampSpec("exec{step}.handoff", "rnb_tpu_torch/runner.py",
              "span: the edge contract's payload take — adopt or re-home "
              "the upstream tensors onto this consumer (handoff-enabled "
              "runs only)"),
    StampSpec("exec{step}.redispatch", "rnb_tpu_torch/runner.py",
              "span: an evicted replica lane's executor re-enqueues one "
              "queued item onto a healthy sibling lane"),
    StampSpec("health.lane_state", "rnb_tpu_torch/health.py",
              "instant: a lane's health state transition (args: lane, "
              "from, to, why): a replica lane's or the network edge's"),
    StampSpec("loader.decode_submit", "rnb_tpu_torch/models/r2p1d/model.py",
              "instant: one request's decode submitted"),
    StampSpec("loader.decode_ready", "rnb_tpu_torch/models/r2p1d/model.py",
              "instant: one request's decode observed complete"),
    StampSpec("loader.emit", "rnb_tpu_torch/models/r2p1d/model.py",
              "span: fused-batch take, assembly and handoff"),
    StampSpec("loader.transfer", "rnb_tpu_torch/models/r2p1d/model.py",
              "span: host->device copy and its confirmation"),
    StampSpec("loader.s{step}.inflight",
              "rnb_tpu_torch/models/r2p1d/model.py",
              "counter (sampled): decodes in flight plus decoded but "
              "unemitted requests in the fusing loader"),
    StampSpec("staging.s{step}.free", "rnb_tpu_torch/models/r2p1d/model.py",
              "counter (sampled): free staging slots of a loader"),
    StampSpec("staging.acquire_wait", "rnb_tpu_torch/staging.py",
              "span: blocked acquiring a staging slot"),
    StampSpec("transfer.job", "rnb_tpu_torch/staging.py",
              "span: one job on the transfer worker thread"),
    StampSpec("batcher.emit", "rnb_tpu_torch/batcher.py",
              "instant: the Batcher fused and emitted one batch (args: "
              "requests, rows)"),
    StampSpec("autotune.decision", "rnb_tpu_torch/autotune.py",
              "instant: one BatchController decision (args: verdict, "
              "target_rows, hold_ms)"),
    StampSpec("queue.filename.depth", "rnb_tpu_torch/benchmark.py",
              "counter (sampled): client filename queue depth"),
    StampSpec("queue.e{step}.depth", "rnb_tpu_torch/benchmark.py",
              "counter (sampled): inter-stage queue depth, by edge "
              "ordinal"),
)


#: the log-meta lines of the fault ledger (``Faults:`` on every run, the
#: others when they have entries), of the deadline layer and of the
#: metrics, critpath and autotune planes (each only when its root config
#: key is on)
META_LINE_REGISTRY = (
    StampSpec("Faults:", "rnb_tpu_torch/benchmark.py",
              "job-wide num_failed/num_shed/num_retries counters"),
    StampSpec("Failure reasons:", "rnb_tpu_torch/benchmark.py",
              "JSON per-reason dead-letter counts"),
    StampSpec("Shed sites:", "rnb_tpu_torch/benchmark.py",
              "JSON per-site shed counts"),
    StampSpec("Queue overflows:", "rnb_tpu_torch/benchmark.py",
              "JSON per-edge abort-policy queue-overflow counts"),
    StampSpec("Deadline:", "rnb_tpu_torch/benchmark.py",
              "deadline-propagation counters: configured budget_ms and "
              "requests shed as deadline_expired (per-site sheds sum to "
              "the total)"),
    StampSpec("Deadline sites:", "rnb_tpu_torch/benchmark.py",
              "JSON per-check-site deadline_expired shed counts"),
    StampSpec("Metrics:", "rnb_tpu_torch/benchmark.py",
              "live-metrics plane counters: interval snapshots appended "
              "to metrics.jsonl, distinct series, flight dumps written and "
              "triggers observed"),
    StampSpec("Slo:", "rnb_tpu_torch/benchmark.py",
              "SLO ledger: completions tracked / within their budget / "
              "missed, and the run's peak burn rate in milli-units (1000 = "
              "consuming the error budget exactly)"),
    StampSpec("Critpath:", "rnb_tpu_torch/benchmark.py",
              "critical-path counters (rnb_tpu_torch.critpath): requests "
              "whose blocking chain was recovered, chain segments, worst "
              "partition residual (us), hedge-won and redispatched "
              "completions, and the binding stage's throughput bound "
              "(bound_step / bound_vps_milli)"),
    StampSpec("Critpath stages:", "rnb_tpu_torch/benchmark.py",
              "JSON per-stage blocking attribution: lanes, blocked totals "
              "and means per class, occupied ms and the stage's bound"),
    StampSpec("Autotune:", "rnb_tpu_torch/benchmark.py",
              "BatchController counters (rnb_tpu_torch.autotune): "
              "decisions, immediate / held verdicts, emissions and the "
              "held deadlines' min / max / sum in microseconds"),
    StampSpec("Autotune buckets:", "rnb_tpu_torch/benchmark.py",
              "JSON {row bucket: emissions} of the controlled stages"),
    StampSpec("Compute:", "rnb_tpu_torch/benchmark.py",
              "device-compute plane counters (rnb_tpu_torch.devobs): "
              "flops-bearing stages, dispatches, valid rows, total "
              "achieved FLOPs, measured window, job tflops/mfu "
              "(tflops_milli / mfu_e4; mfu_e4=-1 when the device peak is "
              "unknown) and capture windows taken (devobs-enabled runs "
              "only; --check cross-foots flops against per-row counts x "
              "rows, recomputes tflops_milli and bounds the mfu)"),
    StampSpec("Compute stages:", "rnb_tpu_torch/benchmark.py",
              "JSON per-stage roofline detail: rows, dispatches, "
              "flops_per_row, busy_us, achieved tflops_busy, mfu_busy vs "
              "the device peak, and ai_flops_per_byte (null: PyTorch has "
              "no cost model to give bytes per row) "
              "(devobs-enabled runs only)"),
    StampSpec("Memory:", "rnb_tpu_torch/benchmark.py",
              "device footprint ledger totals (rnb_tpu_torch.memledger): "
              "declared owners, devices, resident/peak bytes, watermark "
              "threshold and crossings, torch.cuda.memory_allocated bytes "
              "and the reconciliation verdict (devobs-enabled runs only; "
              "--check asserts owner rows sum to the total and peak >= "
              "final)"),
    StampSpec("Shard:", "rnb_tpu_torch/benchmark.py",
              "intra-stage shard counters: declared-degree steps, max "
              "degree, merge gathers, their summed host-timed "
              "microseconds, valid rows crossing sharded stages "
              "(declared-shard runs only; parse_utils foots the totals and "
              "nests collective_us inside the model_call spans)"),
    StampSpec("Shard steps:", "rnb_tpu_torch/benchmark.py",
              "JSON per-step shard detail: degree/axis, merge-gather "
              "counters, projected vs budget per-member MiB, smallest "
              "feasible degree (declared-shard runs only)"),
    StampSpec("Memory owners:", "rnb_tpu_torch/benchmark.py",
              "JSON per-owner footprint detail {owner: {bytes, "
              "peak_bytes}}; owners are declared in "
              "memledger.MEM_OWNER_REGISTRY (devobs-enabled runs only)"),
    StampSpec("Whatif:", "rnb_tpu_torch/benchmark.py",
              "calibrated queueing-model counters (rnb_tpu_torch.whatif): "
              "stages calibrated from the metrics plane, whether "
              "calibration succeeded, the model's self-predicted "
              "throughput in milli-vps and its bottleneck step "
              "(whatif-enabled runs only; parse_utils recomputes the "
              "prediction from metrics.jsonl + the config copy and holds "
              "it to +-1 milli-vps)"),
    StampSpec("Operator:", "rnb_tpu_torch/benchmark.py",
              "operator-plane request ledger (rnb_tpu_torch.statusz): GET "
              "scrapes served, POST actions accepted, POST actions denied "
              "by the allow_actions gate, request errors (operator-enabled "
              "runs only; parse_utils holds the line to operator.json both "
              "ways)"),
    StampSpec("Health:", "rnb_tpu_torch/benchmark.py",
              "lane health counters (rnb_tpu_torch.health): lanes, state "
              "transitions, opens, evictions, half-open probes, "
              "redispatched items, routes to an open or evicted lane "
              "(health-enabled replica runs and netedge runs; parse_utils "
              "replays every lane's path and holds routes_after_open to "
              "0)"),
    StampSpec("Health lanes:", "rnb_tpu_torch/benchmark.py",
              "JSON per-lane detail: state, transition path, "
              "redispatched_from, routes_after_open"),
    StampSpec("Handoff:", "rnb_tpu_torch/benchmark.py",
              "edge-contract counters (rnb_tpu_torch.handoff): edge takes "
              "split d2d / host with the bytes each moved (handoff-enabled "
              "runs only; d2d+host == edges, host_bytes 0 on a device "
              "config)"),
    StampSpec("Handoff edges:", "rnb_tpu_torch/benchmark.py",
              "JSON per-edge-label handoff counters"),
    StampSpec("Placement:", "rnb_tpu_torch/benchmark.py",
              "JSON measured-cost plan (rnb_tpu_torch.placement): per-step "
              "service, rate and predicted occupancy of the executed plan, "
              "and the recommendation over the device budget"),
    StampSpec("Hedge:", "rnb_tpu_torch/benchmark.py",
              "hedged re-dispatch counters: fired, won by the hedge copy, "
              "lost (the original resolved first) and the losers' wasted "
              "service in ms (hedge_ms runs only; won + lost == fired)"),
    StampSpec("Net:", "rnb_tpu_torch/benchmark.py",
              "network ingest edge counters (rnb_tpu_torch.netedge): "
              "frames sent/acked, resends + resent_pending at teardown, "
              "heartbeats seen, reconnects, remote vs local-fallback "
              "dispatches, dedup drops vs duplicate arrivals, wire and "
              "DATA row bytes, window strands, the opened-before-timeout "
              "flag (netedge runs only; parse_utils holds frames_sent == "
              "frames_acked + resent_pending and dedup_drops == "
              "dup_arrivals)"),
    StampSpec("Net errors:", "rnb_tpu_torch/benchmark.py",
              "per-class network fault counts (refused/reset/timeout/"
              "partial_frame/corrupt); parse_utils re-sums them to "
              "total"),
    StampSpec("Stacks:", "rnb_tpu_torch/benchmark.py",
              "wall-clock stack sampler counters "
              "(rnb_tpu_torch.stacksampler): sampling ticks, distinct "
              "thread roles, distinct folded stacks, total per-thread "
              "samples (operator runs with sample_hz > 0 only; parse_utils "
              "re-sums stacks.folded to total and holds ticks to sample_hz "
              "x wall within tolerance)"),
    StampSpec("Args:", "rnb_tpu_torch/benchmark.py",
              "JSON launch arguments (config, mean interval, videos, "
              "queue size, seed, platform)"),
    StampSpec("Termination flag:", "rnb_tpu_torch/benchmark.py",
              "how the run ended (0: the target was reached)"),
    StampSpec("Device:", "rnb_tpu_torch/benchmark.py",
              "JSON name and platform of the device the run served on"),
    StampSpec("Pixel path:", "rnb_tpu_torch/benchmark.py",
              "the wire format a loader ships (rgb, yuv420, dct)"),
    StampSpec("Decode backend:", "rnb_tpu_torch/benchmark.py",
              "the decoders a loader used (native, numpy, synth, ...)"),
    StampSpec("Completed:", "rnb_tpu_torch/benchmark.py",
              "requests and clip rows the final step completed"),
    StampSpec("Padding:", "rnb_tpu_torch/benchmark.py",
              "pad rows over shipped rows of every batching stage"),
    StampSpec("Ragged:", "rnb_tpu_torch/benchmark.py",
              "ragged pool dispatch counters (ragged runs only)"),
    StampSpec("Cache:", "rnb_tpu_torch/benchmark.py",
              "clip cache counters (cache_mb runs only)"),
    StampSpec("Staging:", "rnb_tpu_torch/benchmark.py",
              "one loader's staging pool counters"),
    StampSpec("Pages:", "rnb_tpu_torch/benchmark.py",
              "page allocator ledger (pager runs only)"),
    StampSpec("Pages arenas:", "rnb_tpu_torch/benchmark.py",
              "JSON pages and bytes of each arena (pager runs only)"),
    StampSpec("Compiles:", "rnb_tpu_torch/benchmark.py",
              "JSON entry signatures per step, warm-up and steady"),
    StampSpec("Warmup:", "rnb_tpu_torch/benchmark.py",
              "JSON construction seconds per step"),
    StampSpec("Graphs:", "rnb_tpu_torch/benchmark.py",
              "JSON captured CUDA graphs, capture seconds and replays per "
              "step (the card only)"),
    StampSpec("Trace:", "rnb_tpu_torch/benchmark.py",
              "trace events exported and dropped (traced runs only)"),
    StampSpec("Phases:", "rnb_tpu_torch/benchmark.py",
              "JSON per-phase latency attribution (traced runs only)"),
    StampSpec("Locks:", "rnb_tpu_torch/benchmark.py",
              "lock-order witness counters (witness-armed runs only)"),
    StampSpec("Lock edges:", "rnb_tpu_torch/benchmark.py",
              "JSON observed lock-order edges and violations; parse_utils "
              "holds every edge to rnb-lint's static lock-order graph"),
    StampSpec("Kernels:", "rnb_tpu_torch/benchmark.py",
              "JSON launches of each hand-written kernel in the window"),
    StampSpec("Profile:", "rnb_tpu_torch/benchmark.py",
              "profiled kernel time over the window (--profile runs "
              "only)"),
)


#: one declared live-metric series: ``kind`` is counter, gauge, rate or
#: histogram; ``source`` says where its samples come from: ``site`` (a
#: ``metrics.counter/gauge/observe/mark`` call), ``bridge`` (the
#: same-named trace span or instant, through the SpanBridge), ``poll``
#: (a subsystem's ``snapshot()`` read each flusher tick) or ``derived``
#: (computed inside the registry)
MetricSpec = namedtuple("MetricSpec",
                        ("pattern", "kind", "source", "description"))

#: every live-metric series the port may write into
#: ``logs/<job>/metrics.jsonl`` and ``metrics.prom`` — the names and
#: kinds of the reference's registry, for the signals the port has
METRIC_REGISTRY = (
    MetricSpec("client.arrivals", "rate", "site",
               "windowed request arrival rate at the client"),
    MetricSpec("client.requests", "counter", "site",
               "requests the client has created"),
    MetricSpec("client.shed", "counter", "site",
               "requests the client shed at the full filename queue"),
    MetricSpec("exec{step}.queue_get", "histogram", "bridge",
               "executor input-queue starvation wait (ms)"),
    MetricSpec("exec{step}.hold_wait", "histogram", "bridge",
               "executor batch-fill hold wait (ms)"),
    MetricSpec("exec{step}.model_call", "histogram", "bridge",
               "stage call service time (ms)"),
    MetricSpec("exec{step}.device_sync", "histogram", "bridge",
               "wait for the stage's device work (ms)"),
    MetricSpec("exec{step}.publish", "histogram", "bridge",
               "route, segment split and downstream enqueue (ms)"),
    MetricSpec("exec{step}.collective", "histogram", "bridge",
               "sharded-stage merge gather of the logits (ms)"),
    MetricSpec("loader.emit", "histogram", "bridge",
               "fused-batch take, assembly and handoff (ms)"),
    MetricSpec("loader.transfer", "histogram", "bridge",
               "host->device copy and its confirmation (ms)"),
    MetricSpec("staging.acquire_wait", "histogram", "bridge",
               "staging-slot exhaustion wait (ms)"),
    MetricSpec("batcher.emit", "counter", "bridge",
               "Batcher fused emissions"),
    MetricSpec("autotune.decision", "counter", "bridge",
               "BatchController decisions"),
    MetricSpec("health.lane_state", "counter", "bridge",
               "lane health state transitions"),
    MetricSpec("hedge.fired", "counter", "poll",
               "hedged re-dispatches fired (HedgeGovernor ledger)"),
    MetricSpec("hedge.won", "counter", "poll", "hedges the clone copy won"),
    MetricSpec("hedge.lost", "counter", "poll",
               "hedges the original copy won"),
    MetricSpec("health.transitions", "counter", "poll",
               "lane state-machine hops (LaneHealthBoard)"),
    MetricSpec("health.opens", "counter", "poll", "lane circuit opens"),
    MetricSpec("health.evictions", "counter", "poll",
               "permanently dead lanes"),
    MetricSpec("health.probes", "counter", "poll",
               "half-open recovery probes"),
    MetricSpec("health.redispatches", "counter", "poll",
               "items drained off evicted lanes"),
    MetricSpec("net.frames_sent", "counter", "poll",
               "REQ frames shipped across the ingest edge"),
    MetricSpec("net.frames_acked", "counter", "poll",
               "REQ frames the peer acknowledged (unique seqs)"),
    MetricSpec("net.resends", "counter", "poll",
               "REQ frames re-shipped after a reconnect or a lost ack"),
    MetricSpec("net.beats", "counter", "poll",
               "peer heartbeat frames received"),
    MetricSpec("net.reconnects", "counter", "poll",
               "successful re-dials after a connection died"),
    MetricSpec("net.remote", "counter", "poll",
               "requests dispatched across the wire"),
    MetricSpec("net.local", "counter", "poll",
               "requests routed to the in-process fallback"),
    MetricSpec("net.dedup_drops", "counter", "poll",
               "duplicate DATA/DISPOSE frames the receiver dropped"),
    MetricSpec("net.dup_arrivals", "counter", "poll",
               "frames that arrived for an already-settled seq"),
    MetricSpec("net.wire_bytes", "counter", "poll",
               "bytes sent and received on the wire"),
    MetricSpec("net.frame_bytes", "counter", "poll",
               "DATA row bytes received (valid rows only)"),
    MetricSpec("net.err_total", "counter", "poll",
               "classified network faults (all classes)"),
    MetricSpec("net.peer_depth", "gauge", "poll",
               "the peer's in-flight depth, on every frame it sends"),
    MetricSpec("faults.num_failed", "counter", "poll",
               "dead-lettered requests (FaultStats ledger)"),
    MetricSpec("faults.num_shed", "counter", "poll",
               "shed requests (FaultStats ledger)"),
    MetricSpec("faults.num_retries", "counter", "poll",
               "transient retry attempts (FaultStats ledger)"),
    MetricSpec("faults.sheds", "rate", "site",
               "windowed shed rate (the shed-spike flight trigger)"),
    MetricSpec("deadline.expired", "counter", "poll",
               "requests shed as deadline_expired (DeadlineStats "
               "ledger)"),
    MetricSpec("queue.filename.depth", "gauge", "site",
               "client filename queue depth (saturation-armed)"),
    MetricSpec("queue.e{step}.depth", "gauge", "site",
               "inter-stage queue depth by edge ordinal "
               "(saturation-armed)"),
    MetricSpec("autotune.arrival_hz", "gauge", "site",
               "controller arrival-rate EWMA at the last decision"),
    MetricSpec("autotune.target_rows", "gauge", "site",
               "controller target row count at the last decision"),
    MetricSpec("cache.hits", "counter", "poll", "clip-cache lookup hits"),
    MetricSpec("cache.misses", "counter", "poll",
               "clip-cache lookup misses"),
    MetricSpec("cache.inserts", "counter", "poll", "clip-cache inserts"),
    MetricSpec("cache.evictions", "counter", "poll",
               "clip-cache LRU evictions"),
    MetricSpec("cache.coalesced", "counter", "poll",
               "requests that shared an in-flight decode"),
    MetricSpec("cache.oversize", "counter", "poll",
               "entries skipped as larger than the whole budget"),
    MetricSpec("cache.bytes_resident", "gauge", "poll",
               "resident cache bytes"),
    MetricSpec("cache.entries", "gauge", "poll", "resident cache entries"),
    MetricSpec("staging.acquires", "counter", "poll",
               "staging-slot acquires"),
    MetricSpec("staging.acquire_waits", "counter", "poll",
               "staging-slot exhaustion waits"),
    MetricSpec("staging.staged_batches", "counter", "poll",
               "emissions decoded in place"),
    MetricSpec("staging.copied_batches", "counter", "poll",
               "emissions with a row copied in on the host"),
    MetricSpec("staging.slots", "gauge", "poll", "allocated staging slots"),
    MetricSpec("handoff.d2d_edges", "counter", "poll",
               "device-resident edge takes"),
    MetricSpec("handoff.host_edges", "counter", "poll",
               "host-round-trip edge takes"),
    MetricSpec("handoff.d2d_bytes", "counter", "poll",
               "bytes re-homed on the device"),
    MetricSpec("handoff.host_bytes", "counter", "poll",
               "bytes moved through host memory"),
    MetricSpec("pages.allocs", "counter", "poll",
               "pages popped off arena free lists"),
    MetricSpec("pages.frees", "counter", "poll",
               "pages returned to arena free lists"),
    MetricSpec("pages.alloc_fails", "counter", "poll",
               "page allocations refused for lack of free pages"),
    MetricSpec("pages.gathers", "counter", "poll",
               "clip-arena gather kernels launched"),
    MetricSpec("pages.gather_rows", "counter", "poll",
               "rows overlaid from clip pages onto emission pools"),
    MetricSpec("pages.feature_lookups", "counter", "poll",
               "feature-page probes at admission"),
    MetricSpec("pages.feature_hits", "counter", "poll",
               "feature-page hits (decode, transfer and forward skipped)"),
    MetricSpec("pages.feature_inserts", "counter", "poll",
               "feature entries written after a forward"),
    MetricSpec("pages.feature_evictions", "counter", "poll",
               "feature entries evicted to fit an insert"),
    MetricSpec("pages.feature_gathers", "counter", "poll",
               "feature-arena gather kernels launched"),
    MetricSpec("pages.feature_gather_rows", "counter", "poll",
               "output rows gathered from feature pages"),
    MetricSpec("pages.feature_bytes_saved", "counter", "poll",
               "wire bytes feature hits did not ship"),
    MetricSpec("pages.live", "gauge", "poll",
               "pages off the free lists across arenas"),
    MetricSpec("pages.limbo", "gauge", "poll",
               "evicted pages still pinned"),
    MetricSpec("pages.bytes", "gauge", "poll", "total arena slab bytes"),
    MetricSpec("compute.s{step}.rows", "counter", "poll",
               "valid rows a flops-bearing stage dispatched"),
    MetricSpec("compute.s{step}.dispatches", "counter", "poll",
               "model-call dispatches the compute meter observed"),
    MetricSpec("compute.s{step}.tflops", "gauge", "poll",
               "achieved TFLOP/s over the stage's busy time "
               "(declared per-row FLOPs x rows / busy seconds)"),
    MetricSpec("compute.s{step}.mfu", "gauge", "poll",
               "busy-time MFU vs the device peak (absent when the "
               "device has no known peak — never guessed)"),
    MetricSpec("memory.total_bytes", "gauge", "poll",
               "footprint ledger total across declared owners"),
    MetricSpec("memory.peak_bytes", "gauge", "poll",
               "ledger high-water mark (monotone)"),
    MetricSpec("memory.params_bytes", "gauge", "poll",
               "device-resident network parameter bytes (deduped "
               "across replicas sharing one copy)"),
    MetricSpec("memory.cache_bytes", "gauge", "poll",
               "clip-cache resident bytes as a ledger owner"),
    MetricSpec("memory.staging_bytes", "gauge", "poll",
               "staging-slot slab bytes as a ledger owner (pinned host "
               "memory)"),
    MetricSpec("memory.ragged_pool_bytes", "gauge", "poll",
               "ragged pool dispatch-shape bytes as a ledger owner"),
    MetricSpec("memory.page_pool_bytes", "gauge", "poll",
               "page-allocator arena slab + shared-pool bytes "
               "(memledger page_pool owner, rnb_tpu_torch.pager)"),
    MetricSpec("memory.handoff_bytes", "gauge", "poll",
               "bytes resident from the latest edge adoptions"),
    MetricSpec("slo.good", "rate", "derived",
               "windowed within-budget completions"),
    MetricSpec("slo.miss", "rate", "site",
               "windowed SLO violations: late completions and shed or "
               "dead-lettered requests"),
    MetricSpec("slo.tracked", "counter", "derived",
               "completions the SLO layer observed"),
    MetricSpec("slo.within", "counter", "derived",
               "completions inside their budget"),
    MetricSpec("slo.missed", "counter", "derived",
               "completions outside their budget"),
    MetricSpec("slo.goodput_vps", "gauge", "derived",
               "windowed within-budget goodput (completions/s)"),
    MetricSpec("slo.burn_rate", "gauge", "derived",
               "windowed miss fraction / error budget"),
)
