"""Load-adaptive batching controller: SLO-aware hold/bucket autotuning.

Counterpart of ``rnb_tpu/autotune.py``, the port's own copy. A static
``max_hold_ms`` on the fusing loader, or ``batch=N`` on the Batcher,
makes low-rate traffic pay the full hold for batches that never fill
and caps high-rate traffic at whatever constant the config names. A
per-stage :class:`BatchController` observes the live stream and, at
every emission decision, picks the hold deadline / accumulation target
/ row bucket as the **largest batch whose predicted residual-fill wait
plus predicted service time stays inside a configured latency budget**
(``slo_ms``) — immediate dispatch at low arrival rates, full warmed
buckets at saturation.

Estimators (all EWMA, one ``ewma_alpha``):

* **arrival rate** — successive ``enqueue_filename`` TimeCard stamps
  (the client's wall-clock enqueue instants) feed an inter-arrival
  EWMA; the residual wait to grow a batch by ``k`` more requests is
  ``k * E[interarrival]``;
* **rows per request** — the loader's sampled clip counts (Batcher:
  incoming valid rows split over the emission's constituent requests),
  converting a row-bucket target into a residual request count;
* **service time per (stage, row bucket)** — the stage's own
  dispatch->done span on the monotonic clock. The Batcher's is fed by
  the executor from the ``inference{i}_start``/``_finish`` stamps; the
  fusing loader reports its batch-close -> ready-queue span itself
  (``AUTOTUNE_SELF_SERVICE``), since under ``transfer_async`` its
  emissions never return through a stamp-bearing call.

The budget bounds batching-added latency per stage: hold wait plus the
stage's own batch service must stay inside ``slo_ms``.

Safety invariant: decisions are restricted to **already-warmed row
buckets** (the stage's ``row_buckets``, optionally intersected with
``autotune.buckets``) — on the card, the buckets whose forward graphs
the runner captured before the start barrier — so a decision can never
cause a capture inside the measured window. Controller math is host
arithmetic over the observed stamps: no clock reads, no RNG, so a
seeded stamp stream replays to identical decisions.

Config (root key, validated in rnb_tpu_torch.config)::

    "autotune": {"enabled": true, "slo_ms": 50.0, "ewma_alpha": 0.2,
                 "min_hold_ms": 0.5, "max_hold_ms": 50.0,
                 "buckets": [6, 15]}   // optional candidate restriction

Per-step opt-out: ``"autotune": false`` on a pipeline step. Stages
advertise support via ``SUPPORTS_AUTOTUNE`` (R2P1DFusingLoader,
Batcher); the executor calls ``enable_autotune()`` after construction
and feeds the estimators from its hot loop (rnb_tpu_torch.runner).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from rnb_tpu_torch import metrics, trace

#: defaults for the optional keys of the ``autotune`` root config
AUTOTUNE_DEFAULTS = {
    "slo_ms": 50.0,
    "ewma_alpha": 0.2,
    "min_hold_ms": 0.5,
    "max_hold_ms": 50.0,
}


@dataclasses.dataclass(frozen=True)
class AutotuneSettings:
    """Validated, defaulted view of the ``autotune`` root config key."""

    slo_ms: float
    ewma_alpha: float
    min_hold_ms: float
    max_hold_ms: float
    #: optional candidate restriction; None = every warmed bucket
    buckets: Optional[Tuple[int, ...]] = None

    @staticmethod
    def from_config(raw: Optional[dict]) -> Optional["AutotuneSettings"]:
        """Settings from the (schema-validated) config dict, or None
        when autotune is absent or ``enabled`` is false."""
        if not raw or not raw.get("enabled", True):
            return None
        buckets = raw.get("buckets")
        min_hold = float(raw.get("min_hold_ms",
                                 AUTOTUNE_DEFAULTS["min_hold_ms"]))
        # the omitted-max default tracks min_hold_ms exactly like
        # config-time validation (config.py) does — a flat 50.0 would
        # silently invert the clamp pair under min_hold_ms > 50
        max_hold = float(raw.get(
            "max_hold_ms",
            max(min_hold, AUTOTUNE_DEFAULTS["max_hold_ms"])))
        if max_hold < min_hold:
            raise ValueError(
                "autotune max_hold_ms (%g) must be >= min_hold_ms (%g)"
                % (max_hold, min_hold))
        return AutotuneSettings(
            slo_ms=float(raw.get("slo_ms", AUTOTUNE_DEFAULTS["slo_ms"])),
            ewma_alpha=float(raw.get("ewma_alpha",
                                     AUTOTUNE_DEFAULTS["ewma_alpha"])),
            min_hold_ms=min_hold,
            max_hold_ms=max_hold,
            buckets=(tuple(sorted(int(b) for b in buckets))
                     if buckets else None))


@dataclasses.dataclass(frozen=True)
class Decision:
    """One emission decision.

    ``target_rows`` — the row count worth accumulating toward (always
    a warmed candidate bucket); the stage emits once its ready rows
    reach it. ``hold_s`` — the hold deadline for the *oldest* ready
    request, measured from the instant it became ready; the stage
    emits once the oldest has waited this long (0.0 = dispatch now).
    ``bucket`` — the warmed bucket the current ready rows would pad
    to. ``immediate`` — the decision advises dispatching now (the
    hold already expired or growing the batch cannot meet the budget).
    """

    target_rows: int
    hold_s: float
    bucket: int
    immediate: bool


class BatchController:
    """Per-stage-instance online batch autotuner (module docstring).

    Single-threaded by design: the owning executor thread both feeds
    the estimators and asks for decisions, so no lock is needed (the
    snapshot is taken after the stage drained, like cache/staging).
    """

    def __init__(self, settings: AutotuneSettings,
                 candidates: Sequence[int], max_rows: int):
        if not candidates:
            raise ValueError("autotune needs at least one candidate "
                             "row bucket")
        self.slo_ms = float(settings.slo_ms)
        self.ewma_alpha = float(settings.ewma_alpha)
        self.min_hold_ms = float(settings.min_hold_ms)
        self.max_hold_ms = float(settings.max_hold_ms)
        self.candidates: Tuple[int, ...] = tuple(
            sorted(int(b) for b in candidates))
        self.max_rows = int(max_rows)
        # -- estimators (EWMA) ----------------------------------------
        self._ia_s: Optional[float] = None      # inter-arrival seconds
        self._last_enqueue: Optional[float] = None
        self._rows_per_req: Optional[float] = None
        self._service_s: Dict[int, float] = {}  # bucket -> seconds
        # -- accounting (snapshot/log-meta schema) --------------------
        self._decisions = 0
        self._immediate = 0
        self._held = 0
        self._emissions = 0
        self._bucket_counts: Dict[int, int] = {}
        self._deadline_us_min: Optional[int] = None
        self._deadline_us_max = 0
        self._deadline_us_sum = 0
        # every emission must be covered by a decision; forced
        # emissions (end-of-stream flush, slot-exhaustion drain) count
        # as immediate decisions so the invariant decisions >=
        # emissions holds on every path
        self._decided_since_emit = False

    @classmethod
    def for_stage(cls, settings: AutotuneSettings,
                  warmed_buckets: Sequence[int],
                  max_rows: int) -> "BatchController":
        """Build a controller for one stage instance, restricting the
        candidate set to the stage's *warmed* buckets. An
        ``autotune.buckets`` restriction naming an un-warmed bucket is
        rejected here with the reference's message: a chosen un-warmed
        bucket would be a capture inside the measured window."""
        warmed = tuple(sorted(int(b) for b in warmed_buckets))
        candidates = warmed
        if settings.buckets is not None:
            missing = sorted(set(settings.buckets) - set(warmed))
            if missing:
                raise ValueError(
                    "autotune.buckets %s include row bucket(s) %s this "
                    "stage never warms (warmed: %s) — decisions are "
                    "restricted to warmed buckets so autotune can never "
                    "recompile mid-run" % (list(settings.buckets),
                                           missing, list(warmed)))
            candidates = settings.buckets
        return cls(settings, candidates, max_rows)

    # -- estimator feeds ----------------------------------------------

    def _ewma(self, old: Optional[float], obs: float) -> float:
        if old is None:
            return obs
        a = self.ewma_alpha
        return a * obs + (1.0 - a) * old

    def observe_enqueue(self, t_enqueue: float) -> None:
        """One request's client enqueue stamp (wall clock); successive
        stamps feed the inter-arrival EWMA. Out-of-order stamps (fused
        upstream emissions interleaving) clamp to zero gap — a burst
        reads as a burst, never as negative time."""
        if self._last_enqueue is not None:
            dt = t_enqueue - self._last_enqueue
            if dt < 0.0:
                dt = 0.0
            self._ia_s = self._ewma(self._ia_s, dt)
        if self._last_enqueue is None or t_enqueue > self._last_enqueue:
            self._last_enqueue = t_enqueue

    def observe_rows(self, rows: float) -> None:
        """One request's row (clip) count (fractional when derived
        from a fused emission's per-request average; clamped to >= 1
        so the residual-request conversion can never divide by ~0)."""
        self._rows_per_req = self._ewma(self._rows_per_req,
                                        max(1.0, float(rows)))

    def observe_service(self, bucket_rows: int, service_s: float) -> None:
        """One dispatch's service span for the bucket shape it shipped
        (the executor feeds dispatch->done from the TimeCard stamps).
        Keyed by the ACTUAL shipped row count — a stage's static pad
        rule may legally emit at a warmed bucket outside a narrowed
        ``autotune.buckets`` candidate set, and rounding such a sample
        up to a candidate would pollute the larger bucket's EWMA with
        the smaller bucket's service times (``service_for`` already
        bridges candidates with no samples of their own)."""
        b = int(bucket_rows)
        self._service_s[b] = self._ewma(self._service_s.get(b),
                                        max(0.0, float(service_s)))

    # -- the decision --------------------------------------------------

    def bucket_for(self, rows: int) -> int:
        """Smallest candidate bucket holding ``rows``; the largest
        candidate when none does (the stage's hard cap applies)."""
        for b in self.candidates:
            if rows <= b:
                return b
        return self.candidates[-1]

    def service_for(self, bucket: int) -> float:
        """Predicted service seconds for a bucket: its own EWMA, else
        the nearest observed bucket's (larger preferred — conservative
        for growth decisions), else 0.0 (optimistic until the first
        observation lands)."""
        got = self._service_s.get(bucket)
        if got is not None:
            return got
        above = [b for b in self._service_s if b > bucket]
        if above:
            return self._service_s[min(above)]
        below = [b for b in self._service_s if b < bucket]
        if below:
            return self._service_s[max(below)]
        return 0.0

    def peek(self, n_ready: int, rows_ready: int,
             oldest_wait_s: float) -> Decision:
        """:meth:`decide` without the accounting side effects — for
        pure deadline queries (the executor's ``poll_plan`` asks for
        the next deadline every hot-loop tick, and charging each tick
        as a decision would make the ``Autotune:`` counters an
        artifact of poll frequency rather than controller behavior)."""
        del n_ready  # the row axis is what sizes the dispatch
        budget_s = self.slo_ms / 1000.0
        base = self.bucket_for(rows_ready)
        # the largest candidate bucket whose residual-fill wait plus
        # predicted service fits the budget; 0 = no feasible growth.
        # NOT seeded with `base` — padding the current rows to `base`
        # needs no growth, so it must never justify holding by itself
        # (an unknown arrival rate would otherwise hold forever)
        target = 0
        ia = self._ia_s
        if ia is not None and ia > 0.0:
            rpr = self._rows_per_req or 1.0
            for b in self.candidates:
                if b <= rows_ready or b > self.max_rows:
                    continue
                extra_reqs = math.ceil((b - rows_ready) / rpr)
                predicted = (oldest_wait_s + extra_reqs * ia
                             + self.service_for(b))
                if predicted <= budget_s:
                    target = max(target, b)
        if target > rows_ready:
            # worth holding: allow the oldest to wait until the batch
            # could no longer meet the budget, clamped to the
            # configured hold window
            hold_s = budget_s - self.service_for(target)
            hold_s = max(hold_s, self.min_hold_ms / 1000.0)
            hold_s = min(hold_s, self.max_hold_ms / 1000.0)
            if oldest_wait_s >= hold_s:
                return Decision(target, hold_s, base, True)
            return Decision(target, hold_s, base, False)
        # no feasible growth (or unknown arrival rate): dispatch now
        return Decision(base, 0.0, base, True)

    def decide(self, n_ready: int, rows_ready: int,
               oldest_wait_s: float) -> Decision:
        """The emission decision for the current accumulator state:
        ``n_ready`` ready requests totalling ``rows_ready`` rows, the
        oldest of which has waited ``oldest_wait_s``. Pure arithmetic
        over the estimators — no clock reads, no RNG. Counts toward
        the ``Autotune:`` accounting; deadline-only queries must use
        :meth:`peek`."""
        dec = self.peek(n_ready, rows_ready, oldest_wait_s)
        if trace.ACTIVE is not None:
            # decision marker on the deciding thread's trace track
            # (rnb_tpu_torch.trace; args allocated only while tracing) —
            # still no clock reads or RNG on the decision path itself
            trace.instant("autotune.decision", args={
                "verdict": "immediate" if dec.immediate else "held",
                "target_rows": dec.target_rows,
                "hold_ms": dec.hold_s * 1000.0})
        if metrics.ACTIVE is not None:
            # live controller state (rnb_tpu_torch.metrics): the
            # arrival-rate estimate and chosen target stream — still no
            # clock reads or RNG on the decision path
            metrics.gauge("autotune.arrival_hz",
                          1.0 / self._ia_s if self._ia_s else 0.0)
            metrics.gauge("autotune.target_rows", dec.target_rows)
        self._decisions += 1
        self._decided_since_emit = True
        if dec.immediate:
            self._immediate += 1
        else:
            self._held += 1
            us = int(round(dec.hold_s * 1e6))
            if self._deadline_us_min is None or us < self._deadline_us_min:
                self._deadline_us_min = us
            if us > self._deadline_us_max:
                self._deadline_us_max = us
            self._deadline_us_sum += us
        return dec

    def note_emission(self, bucket: int) -> None:
        """One emission shipped at ``bucket`` rows. Emissions no
        decision preceded (end-of-stream flush, forced drains) are
        counted as immediate decisions, keeping the --check invariant
        decisions >= emissions true on every path."""
        if not self._decided_since_emit:
            self._decisions += 1
            self._immediate += 1
        self._decided_since_emit = False
        self._emissions += 1
        b = int(bucket)
        self._bucket_counts[b] = self._bucket_counts.get(b, 0) + 1

    # -- reporting -----------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """Final counters for the job-wide aggregation (BenchmarkResult
        ``autotune_*`` fields / log-meta ``Autotune:`` line)."""
        return {
            "decisions": self._decisions,
            "immediate": self._immediate,
            "held": self._held,
            "emissions": self._emissions,
            "deadline_us_min": self._deadline_us_min or 0,
            "deadline_us_max": self._deadline_us_max,
            "deadline_us_sum": self._deadline_us_sum,
            "bucket_counts": {str(b): n for b, n
                              in sorted(self._bucket_counts.items())},
        }


def aggregate_snapshots(snapshots: List[Dict[str, object]]
                        ) -> Dict[str, object]:
    """Sum per-instance controller snapshots into the job-wide view
    (min over non-empty mins, max over maxes, sums elsewhere)."""
    out: Dict[str, object] = {
        "decisions": 0, "immediate": 0, "held": 0, "emissions": 0,
        "deadline_us_min": 0, "deadline_us_max": 0, "deadline_us_sum": 0,
        "bucket_counts": {},
    }
    mins = [int(s.get("deadline_us_min", 0)) for s in snapshots
            if int(s.get("held", 0)) > 0]
    out["deadline_us_min"] = min(mins) if mins else 0
    for s in snapshots:
        for key in ("decisions", "immediate", "held", "emissions",
                    "deadline_us_sum"):
            out[key] += int(s.get(key, 0))
        out["deadline_us_max"] = max(int(out["deadline_us_max"]),
                                     int(s.get("deadline_us_max", 0)))
        for b, n in dict(s.get("bucket_counts", {})).items():
            counts = out["bucket_counts"]
            counts[b] = counts.get(b, 0) + int(n)
    return out
