"""Pipeline tracing: spans, counters, Perfetto export, phases.

Counterpart of ``rnb_tpu/trace.py``, the port's own copy. It turns the
run's signals into two artifacts:

* **A per-job timeline** (``logs/<job>/trace.json``): named spans from
  every thread role (client, stage executors, the transfer worker),
  counter tracks sampled at a low background rate (queue depths,
  staging-slot occupancy, the fusing loader's in-flight window), and
  flow links chaining one request's spans across stages — a standard
  Chrome trace loadable in ``ui.perfetto.dev`` untouched. Enabled per
  job by the root config key ``trace: {enabled, sample_hz,
  max_events}``.
* **A per-request cost breakdown** (:func:`attribute_phases`): each
  request's end-to-end latency split into named phases —
  ``client_queue -> decode -> hold -> transfer -> inference{i} ->
  inter_stage_queue -> drain`` — from TimeCard stamps alone, so it
  works on any past log directory (coarser there: without the
  trace-mode refinement stamps the loader span reports as one
  ``decode`` phase). Phases partition [first stamp, last stamp] by
  construction, so they always sum to the end-to-end latency. Merged
  segment cards (``TimeCard.merge``) are read through their
  ``-{sub_id}`` suffixes.

Cost discipline: like :mod:`rnb_tpu_torch.hostprof`, the disabled path
of every instrumentation call is one module-global ``None`` test and
no allocation — ``trace.span(name)`` returns a shared no-op context
manager when no tracer is active. Event names are declared in
``rnb_tpu_torch.telemetry.TRACE_EVENT_REGISTRY``; the tests hold every
name a run emits to it.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

#: the active per-job tracer, installed/cleared by
#: rnb_tpu_torch.benchmark
#: around the measured run (module-global like hostprof's accumulator:
#: jobs run one at a time per process)
ACTIVE: Optional["Tracer"] = None

#: default background counter-sampling rate (Hz); 0 disables the
#: sampler thread while keeping spans/instants/explicit counters
DEFAULT_SAMPLE_HZ = 20.0
#: default event-buffer cap — beyond it events are counted as dropped,
#: never grown (a runaway trace must not OOM the bench host)
DEFAULT_MAX_EVENTS = 200000


class _NullSpan:
    """Shared no-op context manager: the disabled path costs one
    function call, one global read, and no allocation."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def name(pattern: str, *args) -> str:
    """Format a registered event-name pattern once, ahead of a hot
    loop (``trace.name("exec%d.model_call", step)``). Call sites keep
    the literal pattern here so the static schema checker (RNB-T008)
    can see every name the tree may emit; the hot loop then passes the
    prebuilt string to :func:`span`/:func:`instant` with zero
    formatting cost per event."""
    return pattern % args if args else pattern


def span(event_name: str, rid: Optional[int] = None):
    """Context manager timing one named span on the current thread.

    ``rid`` correlates the span with a request id: the exporter chains
    all events of one rid into a Perfetto flow. Disabled path: shared
    no-op, no allocation."""
    t = ACTIVE
    if t is None:
        return _NULL
    return t.span(event_name, rid)


def instant(event_name: str, rid: Optional[int] = None,
            args: Optional[dict] = None) -> None:
    """A zero-duration event on the current thread's track."""
    t = ACTIVE
    if t is None:
        return
    t.add_event(event_name, "i", time.time(), 0.0, rid, args)


def counter(event_name: str, value) -> None:
    """An explicit counter sample (event-driven counter track)."""
    t = ACTIVE
    if t is None:
        return
    t.add_event(event_name, "C", time.time(), 0.0, None,
                {"value": value})


class TraceSettings:
    """Validated per-job tracing knobs (root config key ``trace``)."""

    __slots__ = ("enabled", "sample_hz", "max_events")

    def __init__(self, enabled: bool = True,
                 sample_hz: float = DEFAULT_SAMPLE_HZ,
                 max_events: int = DEFAULT_MAX_EVENTS):
        self.enabled = bool(enabled)
        self.sample_hz = float(sample_hz)
        self.max_events = int(max_events)

    @staticmethod
    def from_config(raw: Optional[dict]) -> Optional["TraceSettings"]:
        """Settings from the validated config dict, or None when the
        key is absent or ``enabled`` is false (tracing fully off: no
        tracer, no refinement stamps, byte-stable logs)."""
        if raw is None:
            return None
        settings = TraceSettings(
            enabled=raw.get("enabled", True),
            sample_hz=raw.get("sample_hz", DEFAULT_SAMPLE_HZ),
            max_events=raw.get("max_events", DEFAULT_MAX_EVENTS))
        return settings if settings.enabled else None


class _Span:
    """One live enabled-mode span (allocated only while tracing)."""

    __slots__ = ("tracer", "name", "rid", "t0")

    def __init__(self, tracer: "Tracer", event_name: str,
                 rid: Optional[int]):
        self.tracer = tracer
        self.name = event_name
        self.rid = rid
        self.t0 = time.time()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        t1 = time.time()
        self.tracer.add_event(self.name, "X", self.t0, t1 - self.t0,
                              self.rid, None)
        return False


class Tracer:
    """Bounded, thread-safe event collector + background sampler.

    Events are (name, ph, t_epoch_s, dur_s, thread_name, rid, args)
    tuples appended under one lock; the export step normalizes them
    into Chrome-trace JSON (microsecond timestamps relative to the
    earliest event, one ``tid`` per thread role, counter tracks, and
    synthesized flow chains per request id)."""

    def __init__(self, settings: Optional[TraceSettings] = None):
        self.settings = settings or TraceSettings()
        self._lock = threading.Lock()
        self._events: List[Tuple] = []
        self.dropped = 0
        #: (name, callable) pairs the sampler polls; callables must be
        #: cheap and thread-safe (queue qsize, pool availability)
        self._counter_sources: List[Tuple[str, Callable[[], float]]] = []
        self._sampler: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- collection ---------------------------------------------------

    def span(self, event_name: str, rid: Optional[int] = None) -> _Span:
        return _Span(self, event_name, rid)

    def add_event(self, event_name: str, ph: str, t0: float,
                  dur: float, rid: Optional[int],
                  args: Optional[dict]) -> None:
        thread_name = threading.current_thread().name
        with self._lock:
            if len(self._events) >= self.settings.max_events:
                self.dropped += 1
                return
            self._events.append(
                (event_name, ph, t0, dur, thread_name, rid, args))

    def num_events(self) -> int:
        with self._lock:
            return len(self._events)

    def snapshot_events(self) -> List[Tuple]:
        """Copy of the collected event tuples — the devobs merge reads
        the ``model_call`` spans here to rid-correlate device ops."""
        with self._lock:
            return list(self._events)

    def extend(self, events: List[Tuple]) -> int:
        """Append externally-built event tuples (the collection schema)
        under the same ``max_events`` bound as live collection; returns
        how many were admitted. rnb_tpu_torch.devobs merges captured
        device-op intervals as ``device:<plane>`` tracks here after the
        run drained (never on the hot path); a rid on a device event
        joins that request's flow chain in :func:`export_events`."""
        added = 0
        with self._lock:
            for event in events:
                if len(self._events) >= self.settings.max_events:
                    self.dropped += 1
                    continue
                self._events.append(tuple(event))
                added += 1
        return added

    # -- background occupancy sampler ---------------------------------

    def add_counter_source(self, event_name: str,
                           fn: Callable[[], float]) -> None:
        """Register a queue-depth/occupancy probe for the sampler."""
        with self._lock:
            self._counter_sources.append((event_name, fn))

    def start_sampler(self) -> None:
        if self.settings.sample_hz <= 0 or self._sampler is not None:
            return
        self._sampler = threading.Thread(target=self._sample_loop,
                                         name="trace-sampler",
                                         daemon=True)
        self._sampler.start()

    def stop_sampler(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._sampler is not None:
            self._sampler.join(timeout=timeout)
            self._sampler = None

    def _sample_loop(self) -> None:
        period = 1.0 / self.settings.sample_hz
        while not self._stop.wait(timeout=period):
            with self._lock:
                sources = list(self._counter_sources)
            now = time.time()
            for event_name, fn in sources:
                try:
                    value = fn()
                except Exception:
                    continue  # a dying probe must not kill the sampler
                self.add_event(event_name, "C", now, 0.0, None,
                               {"value": value})

    # -- export -------------------------------------------------------

    def export(self, path: str, job_id: str = "") -> int:
        """Write the collected events as Chrome-trace JSON; returns
        the number of trace events written (excluding metadata)."""
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        return export_events(events, dropped, path, job_id)


def export_events(events: List[Tuple], dropped: int, path: str,
                  job_id: str = "", extra: Optional[dict] = None) -> int:
    """Export one event list — ``(name, ph, t0, dur_s, thread_name,
    rid, args)`` tuples, the :class:`Tracer` collection schema — as
    Chrome-trace JSON: :meth:`Tracer.export` and the flight recorder's
    dumps (rnb_tpu_torch.metrics), whose ``extra`` keys (the trigger,
    the metric window) land in ``otherData``."""
    events = sorted(events, key=lambda e: e[2])
    t_base = events[0][2] if events else 0.0
    tids: Dict[str, int] = {}
    out: List[dict] = []
    #: rid -> mutable [ts_us, tid, record] flow points
    by_rid: Dict[int, List[list]] = {}
    #: tid -> unrounded (start_us, end_us) of every duration slice
    slice_ivals: Dict[int, List[Tuple[float, float]]] = {}

    def tid_of(thread_name: str) -> int:
        tid = tids.get(thread_name)
        if tid is None:
            tid = len(tids) + 1
            tids[thread_name] = tid
        return tid

    for event_name, ph, t0, dur, thread_name, rid, args in events:
        tid = tid_of(thread_name)
        ts = (t0 - t_base) * 1e6
        record = {"name": event_name, "ph": ph, "pid": 1,
                  "tid": tid, "ts": round(ts, 3)}
        if ph == "X":
            dur_us = max(0.0, dur) * 1e6
            record["dur"] = round(dur_us, 3)
            slice_ivals.setdefault(tid, []).append(
                (ts, ts + dur_us))
        record_args = dict(args) if args else {}
        if rid is not None:
            record_args["rid"] = rid
            by_rid.setdefault(rid, []).append([ts, tid, record])
        if record_args:
            record["args"] = record_args
        out.append(record)

    # -- flow anchoring ------------------------------------------
    # Perfetto/Chrome bind a legacy s/t/f flow event to the
    # duration slice enclosing its ts on (pid, tid); an anchor
    # outside every slice is silently dropped at import, which
    # would amputate the chain ends living on instant-only tracks
    # (client.enqueue, the swallow markers). Promote every
    # unenclosed rid-instant to a thin anchor slice (<= 1 us,
    # clamped so it cannot overlap the next slice or anchor on its
    # track) and bind the flow at its midpoint.
    starts_by_tid: Dict[int, List[float]] = {}
    maxend_by_tid: Dict[int, List[float]] = {}
    for tid, ivals in slice_ivals.items():
        ivals.sort()
        running, maxend = float("-inf"), []
        for _start, end in ivals:
            running = max(running, end)
            maxend.append(running)
        starts_by_tid[tid] = [start for start, _end in ivals]
        maxend_by_tid[tid] = maxend

    def _enclosed(tid: int, ts: float) -> bool:
        starts = starts_by_tid.get(tid)
        if not starts:
            return False
        idx = bisect.bisect_right(starts, ts) - 1
        return idx >= 0 and maxend_by_tid[tid][idx] > ts

    def _next_slice_start(tid: int, ts: float) -> Optional[float]:
        starts = starts_by_tid.get(tid)
        if not starts:
            return None
        idx = bisect.bisect_right(starts, ts)
        return starts[idx] if idx < len(starts) else None

    all_points = sorted((p for pts in by_rid.values() for p in pts),
                        key=lambda p: (p[1], p[0]))
    last_anchor: Dict[int, Tuple[float, float, dict, list]] = {}
    for point in all_points:
        ts, tid, record = point
        if record["ph"] != "i" or _enclosed(tid, ts):
            continue
        nxt = _next_slice_start(tid, ts)
        dur = 1.0 if nxt is None else min(1.0, nxt - ts)
        prev = last_anchor.get(tid)
        if prev is not None and ts < prev[0] + prev[1]:
            # shrink the previous anchor up to this one's start
            p_ts, _p_dur, p_record, p_point = prev
            p_dur = max(0.0, ts - p_ts)
            p_record["dur"] = round(p_dur, 3)
            p_point[0] = p_ts + p_dur / 2.0
        record["ph"] = "X"
        record["dur"] = round(dur, 3)
        point[0] = ts + dur / 2.0
        last_anchor[tid] = (ts, dur, record, point)

    # flow chains: every rid with >= 2 correlated events gets a
    # start -> step... -> finish chain binding its spans across
    # thread tracks (Perfetto draws the arrows)
    num_flows = 0
    for rid in sorted(by_rid):
        points = sorted(by_rid[rid], key=lambda p: (p[0], p[1]))
        if len(points) < 2:
            continue
        num_flows += 1
        last = len(points) - 1
        for idx, (ts, tid, record) in enumerate(points):
            ph = "s" if idx == 0 else ("f" if idx == last else "t")
            flow = {"name": "request", "cat": "request", "ph": ph,
                    "id": rid, "pid": 1, "tid": tid,
                    "ts": round(ts, 3)}
            if ph == "f":
                flow["bp"] = "e"
            out.append(flow)
    meta = [{"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
             "ts": 0, "args": {"name": "rnb-tpu %s" % job_id}}]
    for thread_name, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                     "tid": tid, "ts": 0,
                     "args": {"name": thread_name}})
    other = {"job_id": job_id,
             "num_events": len(events),
             "num_flows": num_flows,
             "dropped_events": dropped,
             "t_base_epoch_s": t_base}
    if extra:
        other.update(extra)
    doc = {"traceEvents": meta + out,
           "displayTimeUnit": "ms",
           "otherData": other}
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(events)


def validate_trace(path: str) -> List[str]:
    """Structural checks over one exported ``trace.json``; returns a
    list of human-readable problems (empty = valid). Held to the same
    bar as ``parse_utils --check``: every event carries ts/tid/ph (and
    dur for complete spans), and every flow id resolves start-to-
    finish."""
    problems: List[str] = []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return ["trace unreadable: %s" % e]
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    flow_starts: Dict[int, int] = {}
    flow_ends: Dict[int, int] = {}
    slices: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
    flow_points: List[Tuple[int, dict]] = []
    for idx, ev in enumerate(events):
        for key in ("ph", "ts", "tid", "pid"):
            if key not in ev:
                problems.append("event %d (%r) missing %r"
                                % (idx, ev.get("name"), key))
                break
        ph = ev.get("ph")
        if ph == "X":
            if "dur" not in ev or ev["dur"] < 0:
                problems.append("span %d (%r) missing/negative dur"
                                % (idx, ev.get("name")))
            else:
                slices.setdefault(
                    (ev.get("pid"), ev.get("tid")), []).append(
                        (ev["ts"], ev["ts"] + ev["dur"]))
        elif ph in ("s", "t", "f"):
            flow_points.append((idx, ev))
            if ph == "s":
                flow_starts[ev.get("id")] = \
                    flow_starts.get(ev.get("id"), 0) + 1
            elif ph == "f":
                flow_ends[ev.get("id")] = \
                    flow_ends.get(ev.get("id"), 0) + 1
    for rid, n in flow_starts.items():
        if flow_ends.get(rid, 0) != n:
            problems.append("flow id %r: %d start(s) but %d finish(es)"
                            % (rid, n, flow_ends.get(rid, 0)))
    for rid in flow_ends:
        if rid not in flow_starts:
            problems.append("flow id %r finishes without a start" % rid)
    # Perfetto binds a legacy flow event to the duration slice
    # enclosing its ts on (pid, tid) and silently DROPS unbound ones —
    # an arrow endpoint missing from the rendered timeline with the
    # JSON still "valid". Hold the exporter to renderability, not just
    # structure (closed interval: thin promoted anchors count). Same
    # bisect index the exporter uses, so a max_events-sized trace
    # validates in O(n log n), not O(flow_points x slices).
    starts_by_track: Dict[Tuple[int, int], List[float]] = {}
    maxend_by_track: Dict[Tuple[int, int], List[float]] = {}
    for track, ivals in slices.items():
        ivals.sort()
        running, maxend = float("-inf"), []
        for _start, end in ivals:
            running = max(running, end)
            maxend.append(running)
        starts_by_track[track] = [start for start, _end in ivals]
        maxend_by_track[track] = maxend
    for idx, ev in flow_points:
        ts = ev.get("ts")
        track = (ev.get("pid"), ev.get("tid"))
        starts = starts_by_track.get(track)
        pos = bisect.bisect_right(starts, ts) - 1 if starts else -1
        if pos < 0 or maxend_by_track[track][pos] < ts:
            problems.append(
                "flow event %d (id %r, ph %r) has no enclosing slice "
                "on tid %r at ts %r — Perfetto would drop this arrow"
                % (idx, ev.get("id"), ev.get("ph"), ev.get("tid"), ts))
    return problems


def track_names(path: str) -> List[str]:
    """The distinct named thread tracks of one exported trace (the
    acceptance criterion counts these sources)."""
    with open(path) as f:
        doc = json.load(f)
    return sorted(ev.get("args", {}).get("name", "")
                  for ev in doc.get("traceEvents", [])
                  if ev.get("ph") == "M"
                  and ev.get("name") == "thread_name")


# -- deterministic phase attribution ----------------------------------
#
# The decomposition consumes ONLY TimeCard stamps — the columnar data
# every past per-instance timing table already holds — so it can be
# applied offline to any log directory (scripts/parse_utils.py
# --attribute). Stamps recorded under tracing refine the loader span
# into decode/hold/transfer/drain; without them the whole loader span
# reports as one `decode` phase (the STANDARD_COMPONENTS name for it).

#: canonical phase print order (phases absent from a request's stamps
#: are simply absent from its decomposition)
PHASE_ORDER = ("client_queue", "decode", "hold", "transfer", "drain",
               "inference", "inter_stage_queue")


def _strip_suffix(key: str) -> str:
    """Merged segment cards suffix post-fork stamps with ``-{sub_id}``
    (telemetry.TimeCard.merge); classification ignores the suffix."""
    base, dash, tail = key.rpartition("-")
    if dash and tail.isdigit():
        return base
    return key


def _step_of(base: str, prefix: str, suffix: str) -> Optional[int]:
    if base.startswith(prefix) and base.endswith(suffix):
        digits = base[len(prefix):len(base) - len(suffix)]
        if digits.isdigit():
            return int(digits)
    return None


def phase_of(prev_key: str, next_key: str) -> str:
    """The phase name of the gap between two adjacent stamps.

    Every gap maps to exactly one phase, so per-request phases
    partition [first stamp, last stamp] and sum to the end-to-end
    latency by construction. Unrecognized gaps (segment-sibling skew,
    future stamps) fall into ``drain`` rather than being dropped —
    attribution must account for every microsecond or it lies.
    """
    prev_base = _strip_suffix(prev_key)
    next_base = _strip_suffix(next_key)
    step = _step_of(next_base, "runner", "_start")
    if step is not None:
        return "client_queue" if step == 0 else "inter_stage_queue"
    step = _step_of(next_base, "decode", "_done")
    if step is not None:
        return "decode"
    step = _step_of(next_base, "transfer", "_start")
    if step is not None:
        return "hold"
    step = _step_of(next_base, "transfer", "_done")
    if step is not None:
        return "transfer"
    step = _step_of(next_base, "inference", "_start")
    if step is not None:
        return "client_queue" if step == 0 else "inter_stage_queue"
    step = _step_of(next_base, "inference", "_finish")
    if step is not None:
        if _step_of(prev_base, "transfer", "_done") == step:
            return "drain"  # transfer complete -> publish pickup
        if step == 0:
            # the un-refined loader span: decode(+transfer) in one —
            # the STANDARD_COMPONENTS name for inference0 on past logs
            return "decode"
        return "inference%d" % step
    return "drain"


def attribute_phases(timings: Mapping[str, float]
                     ) -> "Dict[str, float]":
    """Per-request phase decomposition in milliseconds.

    ``timings`` is one TimeCard's stamp mapping (or one timing-table
    row): event key -> epoch seconds. Stamps are ordered by time (a
    merged segment card's sibling stamps interleave), adjacent gaps
    are classified by :func:`phase_of`, and same-named gaps accumulate.
    The values always sum to ``(last - first) * 1000`` exactly (up to
    float rounding), which ``parse_utils --check`` asserts per request.
    """
    stamps = [(float(t), key) for key, t in timings.items()
              if t == t]  # drop NaNs from union-schema frames
    stamps.sort(key=lambda p: p[0])
    phases: Dict[str, float] = {}
    for (t_prev, k_prev), (t_next, k_next) in zip(stamps, stamps[1:]):
        phase = phase_of(k_prev, k_next)
        phases[phase] = phases.get(phase, 0.0) \
            + (t_next - t_prev) * 1000.0
    return phases


def _phase_sort_key(phase: str) -> Tuple[int, str]:
    for idx, prefix in enumerate(PHASE_ORDER):
        if phase == prefix or (prefix == "inference"
                               and phase.startswith("inference")):
            return (idx, phase)
    return (len(PHASE_ORDER), phase)


def sorted_phases(names) -> List[str]:
    """Phase names in the canonical display order."""
    return sorted(names, key=_phase_sort_key)


def phase_stats(samples: Mapping[str, List[float]]
                ) -> "Dict[str, Dict[str, float]]":
    """{phase: {mean_ms, p99_ms, count}} over per-request samples —
    the one aggregation rule shared by the ``Phases:`` log-meta line,
    the ``# phases`` table trailer, and ``parse_utils --attribute``."""
    import numpy as np
    out: Dict[str, Dict[str, float]] = {}
    for phase, values in samples.items():
        if not values:
            continue
        arr = np.asarray(values, dtype=float)
        out[phase] = {"mean_ms": float(arr.mean()),
                      "p99_ms": float(np.percentile(arr, 99.0)),
                      "count": len(values)}
    return out
