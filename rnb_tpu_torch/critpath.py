"""Per-request critical-path extraction: blocking chains, rankings,
throughput bounds.

Counterpart of ``rnb_tpu/critpath.py``, the port's own copy. For every
completed request it recovers the **blocking chain**: the sequence of
segments that gated its completion, from the same TimeCard stamps the
phase attribution walks (:mod:`rnb_tpu_torch.trace`), so it works on any
past log directory, refined by the trace-mode stamps where present.
Segments carry a *class* — ``queue_wait`` (starved behind a queue),
``decode``, ``hold`` (batch-fill wait), ``transfer``, ``service``,
``drain`` (publish/pickup) — and the *pipeline step* they blocked on.

Invariant: chain segments partition the end-to-end span. They are the
adjacent gaps of the time-ordered stamp sequence, so their sum equals
``last - first`` up to float rounding; merged segment cards are read
through their ``-{sub_id}`` suffixes.

Aggregated over a run's steady-state completions the chains give a
blocking-time ranking — total blocked milliseconds per (step, class) —
and a per-stage critical-path throughput bound, ``lanes x requests /
occupied_seconds`` over the stage's occupied segments
(decode/transfer/service/drain, not waits), whose minimum names the
stage that caps the pipeline.

Surfaced as the ``Critpath:``/``Critpath stages:`` log-meta pair, a
``# critpath`` table trailer and ``critpath_*`` result fields, all gated
on the root ``critpath`` config key. The same ranking rule annotates the
metrics plane's flight dumps (:func:`rank_ring_events`).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from rnb_tpu_torch.trace import _step_of, _strip_suffix

#: segment classes a blocking chain may carry, in display order
SEGMENT_CLASSES = ("queue_wait", "decode", "hold", "transfer",
                   "service", "drain")

#: classes that OCCUPY a stage (its lanes are doing the request's
#: work): the per-stage throughput bound divides lane capacity by
#: these; ``queue_wait``/``hold`` are waits, not occupancy
OCCUPIED_CLASSES = ("decode", "transfer", "service", "drain")


class CritpathSettings:
    """Validated per-job knobs (root config key ``critpath``)."""

    __slots__ = ("enabled",)

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)

    @staticmethod
    def from_config(raw: Optional[dict]) -> Optional["CritpathSettings"]:
        """Settings from the validated config dict, or None when the
        key is absent or ``enabled`` is false (extraction fully off:
        no meta lines, no trailer, byte-stable logs)."""
        if raw is None:
            return None
        settings = CritpathSettings(enabled=raw.get("enabled", True))
        return settings if settings.enabled else None


def _digits_of(base: str) -> Optional[int]:
    """The step index embedded in a known stamp key, or None."""
    for prefix, suffix in (("runner", "_start"), ("inference", "_start"),
                           ("inference", "_finish"), ("decode", "_done"),
                           ("transfer", "_start"), ("transfer", "_done")):
        step = _step_of(base, prefix, suffix)
        if step is not None:
            return step
    return None


def classify_gap(prev_key: str, next_key: str) -> Tuple[str, int]:
    """(class, step) of the gap between two adjacent stamps.

    The same gap-walk rule as :func:`rnb_tpu_torch.trace.phase_of`, kept
    structurally parallel so the two decompositions partition the same
    span — but returning the *pipeline step* each gap blocked on,
    which the phase names lump (every inter-stage wait is one
    ``inter_stage_queue`` phase; here it is ``(queue_wait, i)``).
    Unrecognized gaps land in ``drain`` at the last known step rather
    than being dropped: attribution must account for every
    microsecond or it lies."""
    prev_base = _strip_suffix(prev_key)
    next_base = _strip_suffix(next_key)
    step = _step_of(next_base, "runner", "_start")
    if step is not None:
        return ("queue_wait", step)
    step = _step_of(next_base, "decode", "_done")
    if step is not None:
        return ("decode", step)
    step = _step_of(next_base, "transfer", "_start")
    if step is not None:
        return ("hold", step)
    step = _step_of(next_base, "transfer", "_done")
    if step is not None:
        return ("transfer", step)
    step = _step_of(next_base, "inference", "_start")
    if step is not None:
        return ("queue_wait", step)
    step = _step_of(next_base, "inference", "_finish")
    if step is not None:
        if _step_of(prev_base, "transfer", "_done") == step:
            return ("drain", step)  # transfer done -> publish pickup
        if step == 0:
            # the un-refined loader span: decode(+transfer) in one —
            # same rule the phase attribution applies to past logs
            return ("decode", 0)
        return ("service", step)
    prev_step = _digits_of(prev_base)
    return ("drain", prev_step if prev_step is not None else 0)


def blocking_chain(timings: Mapping[str, float]
                   ) -> List[Tuple[str, int, float]]:
    """One request's blocking chain: ``[(class, step, ms), ...]`` in
    completion order, consecutive same-(class, step) gaps merged.

    ``timings`` is one TimeCard's stamp mapping (or one timing-table
    row): key -> epoch seconds; NaNs (union-schema frames) are
    dropped. The ms values sum to ``(last - first) * 1000`` exactly
    (up to float rounding) — the partition invariant."""
    stamps = [(float(t), key) for key, t in timings.items()
              if t == t]
    stamps.sort(key=lambda p: p[0])
    chain: List[Tuple[str, int, float]] = []
    for (t_prev, k_prev), (t_next, k_next) in zip(stamps, stamps[1:]):
        cls, step = classify_gap(k_prev, k_next)
        ms = (t_next - t_prev) * 1000.0
        if chain and chain[-1][0] == cls and chain[-1][1] == step:
            chain[-1] = (cls, step, chain[-1][2] + ms)
        else:
            chain.append((cls, step, ms))
    return chain


def chain_totals(timings: Mapping[str, float]
                 ) -> Dict[Tuple[str, int], float]:
    """{(class, step): total ms} over one request's blocking chain."""
    totals: Dict[Tuple[str, int], float] = {}
    for cls, step, ms in blocking_chain(timings):
        totals[(cls, step)] = totals.get((cls, step), 0.0) + ms
    return totals


def segment_key(cls: str, step: int) -> str:
    """The flat ``<class><step>`` name the ``# critpath`` trailer and
    the ranking tables print (``service1``, ``queue_wait0``)."""
    return "%s%d" % (cls, step)


def aggregate(rows: Iterable[Tuple[Mapping[str, float], bool, int]],
              lanes: Mapping[int, int]) -> Optional[Dict[str, object]]:
    """The job-level critical-path report over completed requests.

    ``rows`` yields ``(timings, hedged, redispatched)`` per request —
    the stamp mapping, whether a hedge copy won the completion and how
    often the request was re-enqueued off an evicted lane (the port has
    neither hedging nor lanes yet, so its rows carry False and 0, and
    the ``Critpath:`` line keeps the reference's fields). ``lanes``
    maps step index -> executor instances (replica lanes included).
    Returns None when no request decomposed (fewer than 2 stamps
    everywhere)."""
    stages: Dict[int, Dict[str, Dict[str, float]]] = {}
    requests = 0
    segments = 0
    residual_us_max = 0.0
    hedged = 0
    redispatched = 0
    for timings, hedge_flag, redisp in rows:
        chain = blocking_chain(timings)
        if not chain:
            continue
        requests += 1
        segments += len(chain)
        finite = [float(t) for t in timings.values() if t == t]
        e2e_ms = (max(finite) - min(finite)) * 1000.0
        residual_us_max = max(
            residual_us_max,
            abs(sum(ms for _c, _s, ms in chain) - e2e_ms) * 1000.0)
        if hedge_flag:
            hedged += 1
        redispatched += int(redisp)
        for cls, step, ms in chain:
            entry = stages.setdefault(step, {}).setdefault(
                cls, {"total_ms": 0.0, "count": 0})
            entry["total_ms"] += ms
            entry["count"] += 1
    if not requests:
        return None
    stage_detail: Dict[str, Dict[str, object]] = {}
    bound_step = -1
    bound_vps = 0.0
    for step in sorted(stages):
        classes = {
            cls: {"total_ms": round(entry["total_ms"], 3),
                  "mean_ms": round(entry["total_ms"] / requests, 3),
                  "count": int(entry["count"])}
            for cls, entry in stages[step].items()}
        occupied_ms = sum(stages[step][cls]["total_ms"]
                          for cls in OCCUPIED_CLASSES
                          if cls in stages[step])
        step_lanes = int(lanes.get(step, 1) or 1)
        # the stage could serve `requests` in occupied_ms/lanes of
        # wall — its critical-path throughput bound; 0 occupied ms
        # (a pure-wait stage) bounds nothing
        vps = (step_lanes * requests / (occupied_ms / 1000.0)
               if occupied_ms > 0.0 else 0.0)
        stage_detail["step%d" % step] = {
            "lanes": step_lanes,
            "requests": requests,
            "occupied_ms": round(occupied_ms, 3),
            "bound_vps": round(vps, 3),
            "classes": classes,
        }
        if vps > 0.0 and (bound_step < 0 or vps < bound_vps):
            bound_step = step
            bound_vps = vps
    return {
        "requests": requests,
        "segments": segments,
        "residual_us_max": int(round(residual_us_max)),
        "hedged": hedged,
        "redispatched": redispatched,
        "bound_step": bound_step,
        "bound_vps_milli": int(round(bound_vps * 1000.0)),
        "stage_detail": stage_detail,
    }


def ranking(stage_detail: Mapping[str, Mapping[str, object]]
            ) -> List[Tuple[str, float, float]]:
    """The blocking-time ranking from a ``Critpath stages:`` payload:
    ``[(segment_name, total_ms, mean_ms)]`` sorted by total blocked
    time, largest first (ties: segment name) — the "fix this first"
    list ``parse_utils --explain`` prints."""
    rows: List[Tuple[str, float, float]] = []
    for step_key, entry in stage_detail.items():
        step = int(step_key[4:])
        for cls, stats in dict(entry.get("classes", {})).items():
            rows.append((segment_key(cls, step),
                         float(stats["total_ms"]),
                         float(stats["mean_ms"])))
    rows.sort(key=lambda r: (-r[1], r[0]))
    return rows


def trailer_totals(rows: Iterable[Mapping[str, float]]
                   ) -> Tuple[int, Dict[str, int]]:
    """(steady request count, {segment_name: total_us}) — the
    ``# critpath`` trailer's payload over one instance's rows."""
    n = 0
    totals: Dict[str, float] = {}
    for timings in rows:
        per_req = chain_totals(timings)
        if not per_req:
            continue
        n += 1
        for (cls, step), ms in per_req.items():
            key = segment_key(cls, step)
            totals[key] = totals.get(key, 0.0) + ms
    return n, {key: int(round(ms * 1000.0))
               for key, ms in totals.items()}


def rank_ring_events(events: Iterable[Tuple],
                     top: int = 12) -> List[Dict[str, object]]:
    """Ranked busy-time attribution over a flight-recorder ring
    window: collection-schema event tuples ``(name, ph, t0, dur_s,
    thread, rid, args)`` -> the ``top`` span names by total duration,
    ``[{name, busy_ms, count}, ...]``. Embedded in every flight dump's
    ``otherData.critpath`` so an anomaly dump names its suspect
    without a separate analysis pass."""
    busy: Dict[str, List[float]] = {}
    for event in events:
        name, ph, _t0, dur = event[0], event[1], event[2], event[3]
        if ph != "X":
            continue
        entry = busy.setdefault(str(name), [0.0, 0])
        entry[0] += max(0.0, float(dur)) * 1000.0
        entry[1] += 1
    ranked = sorted(busy.items(), key=lambda kv: (-kv[1][0], kv[0]))
    return [{"name": name, "busy_ms": round(ms, 3), "count": int(count)}
            for name, (ms, count) in ranked[:top]]
