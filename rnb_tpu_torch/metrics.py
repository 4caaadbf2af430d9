"""Live metrics plane: streaming time-series telemetry, SLO burn-rate
accounting, and an anomaly-triggered flight recorder.

Counterpart of ``rnb_tpu/metrics.py``, the port's own copy. Root config
key ``metrics: {enabled, interval_ms, flight_recorder}``; three pieces:

* **A time-series registry** (:class:`MetricsRegistry`): monotone
  counters, gauges, sliding-window rates and fixed-log2-bucket latency
  histograms, at most :data:`MAX_SERIES` series (an overflow is
  counted, never grown). A background flusher appends one snapshot per
  interval to ``logs/<job>/metrics.jsonl`` and rewrites a
  Prometheus-style exposition, ``metrics.prom``. Metric names are
  declared in ``rnb_tpu_torch.telemetry.METRIC_REGISTRY``; an
  undeclared name raises at its first use.
* **Bridging, not re-measuring**: a :class:`SpanBridge` takes the place
  of the tracer in ``rnb_tpu_torch.trace.ACTIVE`` (forwarding every
  event to the real tracer when tracing is on too), so the executors'
  spans feed latency histograms and instants feed counters with no new
  hot-path instrumentation. Stage-owned subsystems (the clip cache, the
  staging pool), the fault and deadline ledgers and the page allocator
  register *poll sources* the flusher reads each tick; queue depths are
  gauge sources. The final
  snapshot's counters must equal the log-meta ledgers exactly
  (``python3 -m rnb_tpu_torch.parse_utils`` holds them to it).
* **SLO layer + flight recorder**: completions at the final step feed
  windowed within-budget goodput and a burn-rate gauge (miss fraction
  over the window divided by the error budget ``1 - SLO_TARGET``),
  surfaced live and as the ``Slo:`` log-meta line. The flight recorder
  keeps a bounded ring of recent trace events even when full tracing is
  off; when a trigger fires — SLO burn over its threshold, a shed
  spike, queue saturation, or a forced dump — the ring is written as a
  Perfetto-loadable ``flight-<n>.json`` (valid per
  :func:`rnb_tpu_torch.trace.validate_trace`) with the metric window
  around the trigger and its busiest spans
  (:func:`rnb_tpu_torch.critpath.rank_ring_events`) embedded.

Polls run on the flusher thread and read host counters only, under each
subsystem's own lock; none reads a device tensor or waits on the card.
A poll that raises is skipped, never fatal to the flusher.

Cost discipline: as in :mod:`rnb_tpu_torch.trace`, the disabled path of
every module-level hook is one module-global ``None`` test and no
allocation. With the ``metrics`` root key absent nothing is installed,
no log-meta line is added and no file is written.
"""

from __future__ import annotations

import collections
import json
import math
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from rnb_tpu_torch import hostprof
from rnb_tpu_torch import trace as trace_mod

#: the active per-job registry, installed/cleared by
#: rnb_tpu_torch.benchmark around the measured run (module-global like
#: trace.ACTIVE: jobs run one at a time per process)
ACTIVE: Optional["MetricsRegistry"] = None

#: default snapshot interval — small enough that a short chaos run
#: still produces several snapshots, large enough that the flusher is
#: invisible next to the pipeline's own work
DEFAULT_INTERVAL_MS = 250.0
#: flight-recorder ring capacity (events) and dump budget
DEFAULT_RING_EVENTS = 4096
DEFAULT_MAX_DUMPS = 4
#: SLO burn-rate threshold that trips the flight recorder (burn 1.0 =
#: consuming the error budget exactly; > threshold = burning it down)
DEFAULT_BURN_THRESHOLD = 2.0
#: shed-spike trigger: windowed sheds/second at or above this fires
DEFAULT_SHED_SPIKE_PER_S = 2.0
#: queue-saturation trigger: depth/capacity at or above this fires
DEFAULT_QUEUE_SATURATION = 0.9
#: per-trigger-kind dump cooldown so one sustained incident cannot
#: burn the whole dump budget on near-identical rings
DEFAULT_COOLDOWN_S = 5.0

#: availability objective behind the burn-rate gauge: the error budget
#: is ``1 - SLO_TARGET`` of requests allowed to miss their deadline
SLO_TARGET = 0.99

#: sliding window (seconds) behind every windowed rate and the SLO
#: burn computation
RATE_WINDOW_S = 10.0

#: fixed log2 latency histogram: bucket i covers
#: (2^(i + LOG2_MIN_MS - 1), 2^(i + LOG2_MIN_MS)] milliseconds, with
#: the first bucket absorbing everything below and the last everything
#: above — 18 buckets from 0.125 ms to ~16 s, one fixed shape so
#: snapshots diff and exposition scrapes never reshape
HIST_LOG2_MIN = -3
HIST_NUM_BUCKETS = 18

#: hard cap on distinct series (name + implicit label) the registry
#: will hold — a label-cardinality explosion must degrade to a counted
#: overflow, never to unbounded memory
MAX_SERIES = 512

#: env var forcing one flight dump at teardown (to check a dump's
#: validity without staging an incident)
FORCE_DUMP_ENV = "RNB_FLIGHT_FORCE"

#: trigger kinds the port's flight recorder fires
TRIGGER_CIRCUIT_OPEN = "circuit_open"
TRIGGER_SLO_BURN = "slo_burn"
TRIGGER_SHED_SPIKE = "shed_spike"
TRIGGER_QUEUE_SATURATION = "queue_saturation"
TRIGGER_FORCED = "forced"
TRIGGER_MEMORY_WATERMARK = "memory_watermark"


def name(pattern: str, *args) -> str:
    """Format a registered metric-name pattern once, ahead of a hot
    loop (``metrics.name("queue.e%d.depth", i)``) — the contract of
    :func:`rnb_tpu_torch.trace.name`."""
    return pattern % args if args else pattern


def counter(metric_name: str, n: int = 1) -> None:
    """Increment a monotone counter. Disabled path: one None test."""
    m = ACTIVE
    if m is None:
        return
    m.inc_counter(metric_name, n)


def gauge(metric_name: str, value) -> None:
    """Set a gauge to its latest value."""
    m = ACTIVE
    if m is None:
        return
    m.set_gauge(metric_name, value)


def observe(metric_name: str, ms: float) -> None:
    """Record one latency observation (milliseconds) into the metric's
    fixed-log2-bucket histogram."""
    m = ACTIVE
    if m is None:
        return
    m.observe_ms(metric_name, ms)


def mark(metric_name: str, n: int = 1) -> None:
    """Record ``n`` events on a sliding-window rate series."""
    m = ACTIVE
    if m is None:
        return
    m.mark_rate(metric_name, n)


def trigger(reason: str, detail: Optional[dict] = None) -> None:
    """Arm a flight-recorder dump (serviced by the flusher on its next
    tick — never file IO on the caller's thread). Disabled path: one
    None test."""
    m = ACTIVE
    if m is None:
        return
    m.request_dump(reason, detail)


def completions(cards, finish_s: Optional[float] = None) -> None:
    """Final-step completion feed for the live SLO layer: one call per
    registered completion batch (rnb_tpu_torch.runner bookkeeping; a
    merged segment card is one completion). Each
    card's within-deadline verdict comes from its own ``deadline_s``
    stamp when present, else from the job's SLO budget applied to its
    end-to-end latency."""
    m = ACTIVE
    if m is None:
        return
    m.note_completions(cards, finish_s)


def register_stage(model, handoff=None) -> None:
    """Stage-side bridge registration (called by the executor after
    stage construction, before the start barrier): stage-owned
    subsystems — the clip cache, the staging pool, the consumer's
    handoff edge — become poll sources of the active registry. No-op
    when metrics are off or the stage owns none. Each snapshot reads
    host counters; none waits on the card."""
    m = ACTIVE
    if m is None:
        return
    cache = getattr(model, "cache", None)
    if cache is not None and hasattr(cache, "snapshot"):
        m.add_poll(snapshot_poll(
            "cache", cache.snapshot,
            counters=("hits", "misses", "inserts", "evictions",
                      "coalesced", "oversize"),
            gauges=("bytes_resident", "entries")))
    staging = getattr(model, "staging", None)
    if staging is not None and hasattr(staging, "snapshot"):
        m.add_poll(snapshot_poll(
            "staging", staging.snapshot,
            counters=("acquires", "acquire_waits", "staged_batches",
                      "copied_batches"),
            gauges=("slots",)))
    if handoff is not None:
        m.add_poll(snapshot_poll(
            "handoff", handoff.snapshot,
            counters=("d2d_edges", "host_edges", "d2d_bytes",
                      "host_bytes")))


def snapshot_poll(prefix: str, snapshot_fn: Callable[[], dict],
                  counters: Tuple[str, ...] = (),
                  gauges: Tuple[str, ...] = ()) -> Callable:
    """Adapt a subsystem's ``snapshot()`` dict into a registry poll
    source: each named key becomes ``<prefix>.<key>``. Counter values
    from several sources under one name are SUMMED per tick (each
    source's own counter is monotone, so the sum stays monotone —
    the property ``parse_utils --check`` asserts across snapshots)."""
    def poll():
        snap = snapshot_fn()
        out = []
        for key in counters:
            out.append(("counter", prefix + "." + key,
                        int(snap.get(key, 0))))
        for key in gauges:
            out.append(("gauge", prefix + "." + key,
                        float(snap.get(key, 0))))
        return out
    return poll


class MetricsSettings:
    """Validated per-job knobs (root config key ``metrics``)."""

    __slots__ = ("enabled", "interval_ms", "flight_enabled",
                 "ring_events", "max_dumps", "burn_threshold",
                 "shed_spike_per_s", "queue_saturation", "cooldown_s")

    def __init__(self, enabled: bool = True,
                 interval_ms: float = DEFAULT_INTERVAL_MS,
                 flight_recorder=None):
        self.enabled = bool(enabled)
        self.interval_ms = float(interval_ms)
        fr = flight_recorder
        if fr is None or fr is True:
            fr = {}
        if fr is False:
            fr = {"enabled": False}
        self.flight_enabled = bool(fr.get("enabled", True))
        self.ring_events = int(fr.get("ring_events",
                                      DEFAULT_RING_EVENTS))
        self.max_dumps = int(fr.get("max_dumps", DEFAULT_MAX_DUMPS))
        self.burn_threshold = float(fr.get("burn_threshold",
                                           DEFAULT_BURN_THRESHOLD))
        self.shed_spike_per_s = float(fr.get("shed_spike_per_s",
                                             DEFAULT_SHED_SPIKE_PER_S))
        self.queue_saturation = float(fr.get("queue_saturation",
                                             DEFAULT_QUEUE_SATURATION))
        self.cooldown_s = float(fr.get("cooldown_s",
                                       DEFAULT_COOLDOWN_S))

    @staticmethod
    def from_config(raw: Optional[dict]) -> Optional["MetricsSettings"]:
        """Settings from the validated config dict, or None when the
        key is absent or ``enabled`` is false (metrics fully off: no
        registry, no flusher, no new meta lines, byte-stable logs)."""
        if raw is None:
            return None
        settings = MetricsSettings(
            enabled=raw.get("enabled", True),
            interval_ms=raw.get("interval_ms", DEFAULT_INTERVAL_MS),
            flight_recorder=raw.get("flight_recorder"))
        return settings if settings.enabled else None


# -- series kinds ------------------------------------------------------

def hist_bucket(ms: float) -> int:
    """The fixed-log2 bucket index of one millisecond observation:
    bucket b covers (2^(b-1+LOG2_MIN), 2^(b+LOG2_MIN)] so a value
    exactly on a bound lands in the bucket whose ``le`` covers it."""
    if ms <= 0.0:
        return 0
    idx = int(math.ceil(math.log2(ms))) - HIST_LOG2_MIN
    return max(0, min(HIST_NUM_BUCKETS - 1, idx))


def hist_upper_bounds() -> List[float]:
    """The exposed ``le`` upper bound (ms) of each bucket; the last is
    +inf (everything above the fixed range)."""
    bounds = [2.0 ** (HIST_LOG2_MIN + i)
              for i in range(HIST_NUM_BUCKETS - 1)]
    return bounds + [float("inf")]


class _Hist:
    __slots__ = ("buckets", "count", "sum_ms")

    def __init__(self):
        self.buckets = [0] * HIST_NUM_BUCKETS
        self.count = 0
        self.sum_ms = 0.0

    def add(self, ms: float) -> None:
        self.buckets[hist_bucket(ms)] += 1
        self.count += 1
        self.sum_ms += ms


class _Rate:
    """Sliding-window event counter with bounded memory: events
    aggregate into per-second cells, cells outside the window are
    pruned on every touch — at most ``RATE_WINDOW_S + 1`` cells live
    regardless of event volume."""

    __slots__ = ("cells", "total")

    def __init__(self):
        self.cells: "collections.OrderedDict[int, int]" = \
            collections.OrderedDict()
        self.total = 0  # lifetime marks (monotone, for footing)

    def add(self, n: int, now: float) -> None:
        sec = int(now)
        self.cells[sec] = self.cells.get(sec, 0) + n
        self.total += n
        self._prune(now)

    def _prune(self, now: float) -> None:
        horizon = int(now - RATE_WINDOW_S)
        while self.cells:
            oldest = next(iter(self.cells))
            if oldest >= horizon:
                break
            del self.cells[oldest]

    def per_second(self, now: float) -> float:
        self._prune(now)
        return sum(self.cells.values()) / RATE_WINDOW_S


class _PendingDump:
    __slots__ = ("reason", "detail", "t")

    def __init__(self, reason: str, detail: Optional[dict], t: float):
        self.reason = reason
        self.detail = detail
        self.t = t


class SpanBridge:
    """The trace-hook collector metrics installs (``trace.ACTIVE``):
    every existing span/instant site feeds the registry's bridged
    histograms/counters AND the flight ring, with the real per-job
    :class:`rnb_tpu_torch.trace.Tracer` (when full tracing is also on)
    forwarded to unchanged. Duck-types the Tracer surface the module
    hooks use (``span``/``add_event``), so no trace call site changes.
    """

    __slots__ = ("registry", "forward", "ring", "ring_evicted")

    def __init__(self, registry: "MetricsRegistry",
                 forward=None, ring_events: int = 0):
        self.registry = registry
        self.forward = forward
        self.ring = (collections.deque(maxlen=int(ring_events))
                     if ring_events > 0 else None)
        #: events the bounded ring has evicted — a flight dump must
        #: report its truncation (metrics are checked, not trusted),
        #: so this lands in the dump's dropped_events count
        self.ring_evicted = 0

    def span(self, event_name: str, rid: Optional[int] = None):
        return trace_mod._Span(self, event_name, rid)

    def add_event(self, event_name: str, ph: str, t0: float,
                  dur: float, rid: Optional[int],
                  args: Optional[dict]) -> None:
        if self.forward is not None:
            self.forward.add_event(event_name, ph, t0, dur, rid, args)
        self.registry.bridge_event(event_name, ph, dur)
        ring = self.ring
        if ring is not None:
            if len(ring) == ring.maxlen:
                self.ring_evicted += 1
            ring.append((event_name, ph, t0, dur,
                         threading.current_thread().name, rid, args))

    def ring_events(self) -> list:
        return list(self.ring) if self.ring is not None else []


class MetricsRegistry:
    """Bounded, thread-safe live-metrics state + background flusher.

    One instance per job (rnb_tpu_torch.benchmark owns install/clear). All
    mutators take one lock; the flusher thread snapshots under the
    same lock and does file IO outside it.
    """

    GUARDED_BY = {
        "_counters": "_lock",
        "_gauges": "_lock",
        "_rates": "_lock",
        "_hists": "_lock",
        "_polled_counters": "_lock",
        "_overflowed": "_lock",
        "_pending_dumps": "_lock",
        "_fired_triggers": "_lock",
        "_last_dump_t": "_lock",
        "slo_tracked": "_lock",
        "slo_within": "_lock",
        "slo_missed": "_lock",
        "burn_max": "_lock",
        "num_triggers": "_lock",
        "seq": "_lock",
    }

    UNGUARDED_OK = {
        "_name_kind": "declared-kind memo; racing writers insert "
                      "identical values (the patterns are static)",
        "num_dumps": "written only by the flusher's dump path; other "
                     "threads' bare int reads gate a budget heuristic",
        "_jsonl": "flusher-thread confined after start(); start/stop "
                  "are the controller's lifecycle edges",
        "_flusher": "controller-thread lifecycle (start/stop)",
    }

    def __init__(self, settings: Optional[MetricsSettings] = None,
                 job_dir: Optional[str] = None, job_id: str = "",
                 slo_budget_ms: Optional[float] = None,
                 slo_target: float = SLO_TARGET):
        from rnb_tpu_torch.telemetry import METRIC_REGISTRY
        self.settings = settings or MetricsSettings()
        self.job_dir = job_dir
        self.job_id = job_id
        self.slo_budget_ms = slo_budget_ms
        self.slo_target = float(slo_target)
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._rates: Dict[str, _Rate] = {}
        self._hists: Dict[str, _Hist] = {}
        #: polled-counter values by name (recomputed each tick as the
        #: sum over sources, so restarts of the flusher never double)
        self._polled_counters: Dict[str, int] = {}
        self._polls: List[Callable] = []
        self._gauge_sources: List[Tuple[str, Callable[[], float],
                                        Optional[float]]] = []
        #: name -> declared kind, compiled from the registry patterns
        self._declared: List[Tuple[re.Pattern, str]] = [
            (re.compile("^" + re.escape(spec.pattern)
                        .replace(re.escape("{step}"), r"\d+") + "$"),
             spec.kind)
            for spec in METRIC_REGISTRY]
        self._name_kind: Dict[str, str] = {}
        self._overflowed = 0
        # -- snapshots / flusher --------------------------------------
        self.seq = 0
        self._recent: "collections.deque" = collections.deque(maxlen=8)
        self._jsonl = None
        self._flusher: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # -- SLO layer ------------------------------------------------
        self.slo_tracked = 0
        self.slo_within = 0
        self.slo_missed = 0
        self.burn_max = 0.0
        # -- flight recorder ------------------------------------------
        self.bridge: Optional[SpanBridge] = None
        self._pending_dumps: List[_PendingDump] = []
        self.num_dumps = 0
        self.num_triggers = 0
        self._last_dump_t: Dict[str, float] = {}
        #: observers of EVERY trigger firing (not just ones that win a
        #: dump slot) — the devobs plane arms a bounded device-capture
        #: window here, so one anomaly leaves both a flight dump and a
        #: device trace. Called OUTSIDE the registry lock.
        self.trigger_hooks: List[Callable[[str, dict], None]] = []
        self._fired_triggers: List[Tuple[str, dict]] = []

    # -- declaration enforcement --------------------------------------

    def _kind_of(self, metric_name: str) -> str:
        kind = self._name_kind.get(metric_name)
        if kind is None:
            for pattern, declared_kind in self._declared:
                if pattern.match(metric_name):
                    kind = declared_kind
                    break
            self._name_kind[metric_name] = kind or "undeclared"
        if kind is None or kind == "undeclared":
            # a name the registry does not declare fails loudly at the
            # first use, not as silent drift in the exported series
            raise ValueError(
                "metric %r is not declared in "
                "telemetry.METRIC_REGISTRY — declare it (and its "
                "kind) or fix the call site" % metric_name)
        return kind

    def _admit_locked(self, store: dict, metric_name: str) -> bool:
        # series-cardinality bound: beyond MAX_SERIES total series the
        # registry counts the overflow instead of growing — a label
        # explosion degrades the telemetry, never the host
        if metric_name in store:
            return True
        total = (len(self._counters) + len(self._gauges)
                 + len(self._rates) + len(self._hists))
        if total >= MAX_SERIES:
            self._overflowed += 1
            return False
        return True

    # -- mutators ------------------------------------------------------

    def inc_counter(self, metric_name: str, n: int = 1) -> None:
        self._kind_of(metric_name)
        with self._lock:
            if self._admit_locked(self._counters, metric_name):
                self._counters[metric_name] = \
                    self._counters.get(metric_name, 0) + int(n)

    def set_gauge(self, metric_name: str, value) -> None:
        self._kind_of(metric_name)
        with self._lock:
            if self._admit_locked(self._gauges, metric_name):
                self._gauges[metric_name] = float(value)

    def observe_ms(self, metric_name: str, ms: float) -> None:
        self._kind_of(metric_name)
        with self._lock:
            if self._admit_locked(self._hists, metric_name):
                hist = self._hists.get(metric_name)
                if hist is None:
                    hist = self._hists[metric_name] = _Hist()
                hist.add(float(ms))

    def mark_rate(self, metric_name: str, n: int = 1,
                  now: Optional[float] = None) -> None:
        self._kind_of(metric_name)
        now = time.time() if now is None else now
        with self._lock:
            if self._admit_locked(self._rates, metric_name):
                rate = self._rates.get(metric_name)
                if rate is None:
                    rate = self._rates[metric_name] = _Rate()
                rate.add(int(n), now)

    # -- bridges -------------------------------------------------------

    def bridge_event(self, event_name: str, ph: str,
                     dur: float) -> None:
        """One trace event observed by the :class:`SpanBridge`: spans
        land in the same-named latency histogram, instants in the
        same-named counter — IF the metric registry declares the name
        (the trace vocabulary is wider than the bridged subset, so
        undeclared trace events are simply not metrics)."""
        kind = self._name_kind.get(event_name)
        if kind is None:
            for pattern, declared_kind in self._declared:
                if pattern.match(event_name):
                    kind = declared_kind
                    break
            # the trace vocabulary is wider than the bridged subset:
            # undeclared trace events are cached as such and skipped
            # (the same sentinel _kind_of raises on for real call
            # sites, so the cache cannot launder an undeclared name)
            self._name_kind[event_name] = kind or "undeclared"
        if kind == "histogram" and ph == "X":
            with self._lock:
                if self._admit_locked(self._hists, event_name):
                    hist = self._hists.get(event_name)
                    if hist is None:
                        hist = self._hists[event_name] = _Hist()
                    hist.add(max(0.0, dur) * 1000.0)
        elif kind == "counter" and ph == "i":
            with self._lock:
                if self._admit_locked(self._counters, event_name):
                    self._counters[event_name] = \
                        self._counters.get(event_name, 0) + 1

    def add_poll(self, fn: Callable) -> None:
        """Register a poll source (``fn() -> [(kind, name, value)]``)
        the flusher reads each tick. Counter values under one name sum
        across sources; gauges likewise (occupancy-style values whose
        per-instance sum is the job-wide truth)."""
        with self._lock:
            self._polls.append(fn)

    def add_gauge_source(self, metric_name: str,
                         fn: Callable[[], float],
                         capacity: Optional[float] = None) -> None:
        """Register a live occupancy probe (queue depth, slot count)
        sampled at every flush tick; ``capacity`` arms the
        queue-saturation flight trigger at depth/capacity >=
        the configured threshold."""
        self._kind_of(metric_name)
        with self._lock:
            self._gauge_sources.append((metric_name, fn, capacity))

    def note_completions(self, cards,
                         finish_s: Optional[float] = None) -> None:
        """SLO feed: a batch of requests completed at the final step.
        Within-deadline comes from each card's ``deadline_s`` stamp
        when present (the deadline layer's own contract), else from
        the job budget applied to the card's end-to-end span; with no
        budget at all every completion counts within (the goodput
        series still streams, burn stays 0)."""
        now = time.time() if finish_s is None else finish_s
        tracked = within = 0
        for tc in getattr(cards, "time_cards", None) or \
                ([cards] if not isinstance(cards, (list, tuple))
                 else cards):
            timings = getattr(tc, "timings", None)
            if not timings:
                continue
            tracked += 1
            finish = max(timings.values())
            deadline_s = getattr(tc, "deadline_s", None)
            if deadline_s is not None:
                ok = finish <= deadline_s
            elif self.slo_budget_ms is not None:
                e2e_ms = (finish - min(timings.values())) * 1000.0
                ok = e2e_ms <= self.slo_budget_ms
            else:
                ok = True
            if ok:
                within += 1
        missed = tracked - within
        with self._lock:
            self.slo_tracked += tracked
            self.slo_within += within
            self.slo_missed += missed
            if self._admit_locked(self._rates, "slo.good"):
                rate = self._rates.get("slo.good")
                if rate is None:
                    rate = self._rates["slo.good"] = _Rate()
                if within:
                    rate.add(within, now)
            if missed and self._admit_locked(self._rates, "slo.miss"):
                rate = self._rates.get("slo.miss")
                if rate is None:
                    rate = self._rates["slo.miss"] = _Rate()
                rate.add(missed, now)

    # -- flight recorder ----------------------------------------------

    def request_dump(self, reason: str,
                     detail: Optional[dict] = None) -> None:
        """Arm a dump; the flusher services it (file IO never happens
        on the triggering thread)."""
        with self._lock:
            self._trigger_locked(reason, detail or {}, time.time())
        self._dispatch_trigger_hooks()

    def _service_dumps_locked(self) -> List[_PendingDump]:
        due, self._pending_dumps = self._pending_dumps, []
        return due

    def _write_dump(self, pending: _PendingDump,
                    snapshots: List[dict]) -> Optional[str]:
        if self.job_dir is None or self.bridge is None:
            return None
        events = self.bridge.ring_events()
        path = os.path.join(self.job_dir,
                            "flight-%d.json" % self.num_dumps)
        # ranked blocking attribution over the dump's ring window
        # (rnb_tpu_torch.critpath): the dump names its suspect spans up
        # front, no separate analysis pass over the events needed
        try:
            from rnb_tpu_torch.critpath import rank_ring_events
            suspects = rank_ring_events(events)
        except Exception:
            suspects = []  # an annotation must not lose the dump
        trace_mod.export_events(
            # dropped_events = what the bounded ring evicted: a
            # truncated window must read as truncated, never complete
            events, self.bridge.ring_evicted, path, self.job_id,
            extra={"flight_trigger": pending.reason,
                   "flight_detail": pending.detail or {},
                   "flight_t_epoch_s": pending.t,
                   "metric_window": snapshots,
                   "critpath": suspects})
        self.num_dumps += 1
        return path

    # -- snapshots / flusher ------------------------------------------

    def snapshot(self, now: Optional[float] = None) -> dict:
        """One interval snapshot: poll every source, derive the SLO
        gauges, evaluate flusher-side flight triggers, and return the
        JSON-ready record. Pure state + probe reads; the caller owns
        file IO."""
        now = time.time() if now is None else now
        polled: Dict[str, int] = {}
        polled_gauges: Dict[str, float] = {}
        with self._lock:
            polls = list(self._polls)
            gauge_sources = list(self._gauge_sources)
        for fn in polls:
            try:
                items = fn()
            except Exception:
                continue  # a dying source must not kill the flusher
            for kind, metric_name, value in items:
                if kind == "counter":
                    polled[metric_name] = \
                        polled.get(metric_name, 0) + int(value)
                else:
                    polled_gauges[metric_name] = \
                        polled_gauges.get(metric_name, 0.0) \
                        + float(value)
        saturated = None
        for metric_name, fn, capacity in gauge_sources:
            try:
                value = float(fn())
            except Exception:
                continue
            polled_gauges[metric_name] = value
            if capacity and value / capacity \
                    >= self.settings.queue_saturation:
                saturated = {"queue": metric_name, "depth": value,
                             "capacity": capacity}
        with self._lock:
            self._polled_counters = polled
            for metric_name, value in polled_gauges.items():
                self._gauges[metric_name] = value
            # SLO derivation over the sliding window
            good = self._rates.get("slo.good")
            miss = self._rates.get("slo.miss")
            sheds = self._rates.get("faults.sheds")
            goodput = good.per_second(now) if good is not None else 0.0
            # slo.miss already counts sheds and dead letters (the fault
            # ledger marks it per disposal), so burn reads it alone; the
            # faults.sheds rate exists for the shed-spike trigger
            bad_ps = miss.per_second(now) if miss is not None else 0.0
            shed_ps = sheds.per_second(now) if sheds is not None else 0.0
            events_ps = goodput + bad_ps
            budget = max(1e-9, 1.0 - self.slo_target)
            burn = ((bad_ps / events_ps) / budget
                    if events_ps > 0 else 0.0)
            self.burn_max = max(self.burn_max, burn)
            self._gauges["slo.goodput_vps"] = goodput
            self._gauges["slo.burn_rate"] = burn
            counters = dict(self._counters)
            for metric_name, value in self._polled_counters.items():
                counters[metric_name] = value
            # the SLO ledger rides the counters section too (monotone
            # by construction), so the final snapshot's footing
            # against the Slo: line is checkable like every other
            counters["slo.tracked"] = self.slo_tracked
            counters["slo.within"] = self.slo_within
            counters["slo.missed"] = self.slo_missed
            self.seq += 1
            record = {
                "seq": self.seq,
                "t": now,
                "counters": counters,
                "gauges": dict(self._gauges),
                "rates": {metric_name: rate.per_second(now)
                          for metric_name, rate
                          in self._rates.items()},
                "histograms": {
                    metric_name: {"count": hist.count,
                                  "sum_ms": hist.sum_ms,
                                  "buckets": list(hist.buckets)}
                    for metric_name, hist in self._hists.items()},
                "series_overflowed": self._overflowed,
            }
            self._recent.append(record)
            if burn >= self.settings.burn_threshold:
                self._trigger_locked(TRIGGER_SLO_BURN,
                                     {"burn_rate": burn}, now)
            if shed_ps >= self.settings.shed_spike_per_s:
                self._trigger_locked(TRIGGER_SHED_SPIKE,
                                     {"sheds_per_s": shed_ps}, now)
            if saturated is not None:
                self._trigger_locked(TRIGGER_QUEUE_SATURATION,
                                     saturated, now)
        self._dispatch_trigger_hooks()
        return record

    def _dispatch_trigger_hooks(self) -> None:
        """Deliver trigger firings to the registered observers outside
        the registry lock (a hook arming a devobs capture must never
        nest under it)."""
        with self._lock:
            fired, self._fired_triggers = self._fired_triggers, []
        for reason, detail in fired:
            for hook in list(self.trigger_hooks):
                try:
                    hook(reason, detail)
                except Exception:
                    continue  # an observer must not break the plane

    def _trigger_locked(self, reason: str, detail: dict,
                        now: float) -> None:
        # every firing reaches the hooks first — even with the flight
        # recorder disarmed (no ring) a devobs capture still arms on
        # the anomaly; the ring gate below guards only the dump
        # machinery and its trigger counter
        self._fired_triggers.append((reason, dict(detail)))
        if self.bridge is None or self.bridge.ring is None:
            return
        self.num_triggers += 1
        if self.num_dumps + len(self._pending_dumps) \
                >= self.settings.max_dumps:
            return
        last = self._last_dump_t.get(reason)
        if last is not None and now - last < self.settings.cooldown_s:
            return
        self._last_dump_t[reason] = now
        self._pending_dumps.append(_PendingDump(reason, detail, now))

    def tick(self, now: Optional[float] = None) -> dict:
        """One flusher iteration: snapshot, append to metrics.jsonl,
        refresh the Prometheus exposition file, service pending flight
        dumps. Public so tests (and the final flush) drive it without
        the thread."""
        record = self.snapshot(now)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record, sort_keys=True) + "\n")
            self._jsonl.flush()
        if self.job_dir is not None:
            # live exposition on every flush interval (not just
            # teardown), written atomically so a file-based scraper
            # can never read a torn exposition
            try:
                self._write_exposition(
                    os.path.join(self.job_dir, "metrics.prom"))
            except OSError:
                pass  # a full disk must not kill the flusher
        with self._lock:
            due = self._service_dumps_locked()
            snapshots = list(self._recent)
        for pending in due:
            try:
                self._write_dump(pending, snapshots)
            except Exception:
                continue  # a failing dump must not kill the flusher
        return record

    def start(self) -> None:
        if self.job_dir is not None and self._jsonl is None:
            self._jsonl = open(os.path.join(self.job_dir,
                                            "metrics.jsonl"), "w")
        if self._flusher is None:
            self._flusher = threading.Thread(target=self._flush_loop,
                                             name="metrics-flusher",
                                             daemon=True)
            self._flusher.start()

    def _flush_loop(self) -> None:
        period = max(0.01, self.settings.interval_ms / 1000.0)
        while not self._stop.wait(timeout=period):
            try:
                # the flusher's share of host time (RNB_HOST_PROFILE)
                with hostprof.section("metrics.flush"):
                    self.tick()
            except Exception:
                continue  # the flusher must outlive any bad probe

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the flusher, service the forced-dump env hook, take
        the FINAL snapshot (the one parse_utils cross-foots against the
        log-meta ledgers — the caller must only stop after every
        pipeline thread joined so the polled counters are stable),
        and write the Prometheus-style exposition file."""
        self._stop.set()
        if self._flusher is not None:
            self._flusher.join(timeout=timeout)
            self._flusher = None
        if os.environ.get(FORCE_DUMP_ENV):
            self.request_dump(TRIGGER_FORCED, {"env": FORCE_DUMP_ENV})
        # the final tick appends the footing snapshot AND refreshes
        # the exposition file (tick writes it every interval now)
        self.tick()
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

    def render_exposition(self) -> str:
        """Prometheus text exposition of the CURRENT state; one fixed
        naming rule: ``rnb_`` prefix, dots -> underscores."""
        def prom(metric_name: str) -> str:
            return "rnb_" + re.sub(r"[^a-zA-Z0-9_]", "_", metric_name)

        bounds = hist_upper_bounds()
        with self._lock:
            counters = dict(self._counters)
            counters.update(self._polled_counters)
            gauges = dict(self._gauges)
            hists = {metric_name: (list(h.buckets), h.count, h.sum_ms)
                     for metric_name, h in self._hists.items()}
        parts: List[str] = []
        for metric_name in sorted(counters):
            pn = prom(metric_name)
            parts.append("# TYPE %s counter\n" % pn)
            parts.append("%s %d\n" % (pn, counters[metric_name]))
        for metric_name in sorted(gauges):
            pn = prom(metric_name)
            parts.append("# TYPE %s gauge\n" % pn)
            parts.append("%s %g\n" % (pn, gauges[metric_name]))
        for metric_name in sorted(hists):
            buckets, count, sum_ms = hists[metric_name]
            pn = prom(metric_name) + "_ms"
            parts.append("# TYPE %s histogram\n" % pn)
            cumulative = 0
            for bound, n in zip(bounds, buckets):
                cumulative += n
                le = ("+Inf" if math.isinf(bound)
                      else "%g" % bound)
                parts.append('%s_bucket{le="%s"} %d\n'
                             % (pn, le, cumulative))
            parts.append("%s_sum %g\n" % (pn, sum_ms))
            parts.append("%s_count %d\n" % (pn, count))
        return "".join(parts)

    def _write_exposition(self, path: str) -> None:
        """Write :meth:`render_exposition` atomically (tmp +
        ``os.replace``) so file-based scrapers watching the per-tick
        refresh never observe a torn exposition."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.render_exposition())
        os.replace(tmp, path)

    # -- reporting ----------------------------------------------------

    def final_snapshot(self) -> Optional[dict]:
        """The last snapshot taken (after :meth:`stop`, the FINAL
        footing record — identical to metrics.jsonl's last line, so
        consumers calibrating from it are reproducible offline)."""
        with self._lock:
            return self._recent[-1] if self._recent else None

    def summary(self) -> Dict[str, int]:
        """Final counters for the ``Metrics:``/``Slo:`` log-meta lines
        and the BenchmarkResult ``metrics_*``/``slo_*`` fields."""
        with self._lock:
            series = (len(self._counters) + len(self._gauges)
                      + len(self._rates) + len(self._hists)
                      + len(self._polled_counters))
            return {
                "snapshots": self.seq,
                "series": series,
                "dumps": self.num_dumps,
                "triggers": self.num_triggers,
                "slo_tracked": self.slo_tracked,
                "slo_within": self.slo_within,
                "slo_missed": self.slo_missed,
                "burn_max_milli": int(round(self.burn_max * 1000.0)),
            }
