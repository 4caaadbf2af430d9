"""Self-healing serving: lane health, deadlines, hedging.

Counterpart of ``rnb_tpu/health.py``, the port's own copy. Three pieces:

* **Deadline propagation + expiry shedding** (:class:`DeadlineSettings`
  / :class:`DeadlineStats`, root config key ``deadline``): the client
  stamps every request with an absolute wall-clock deadline
  (``enqueue + budget_ms``, on ``time.time()`` as the client's enqueue
  stamp; the budget defaults to ``autotune.slo_ms``, then to 1000 ms).
  Every stage boundary — the fusing loader's hold, the Batcher's emit,
  the executor's queue-take and pre-publish — checks it and sheds the
  expired requests through the containment layer's shed machinery
  (site suffix ``:deadline_expired``), so under overload the pipeline
  serves fresh requests instead of uniformly late ones.
* **Lane health + circuit breaking** (:class:`LaneHealthBoard`, root
  ``health`` key): per replica lane ``healthy -> suspect -> open ->
  half_open`` (and the terminal ``evicted``), driven by in-flight age,
  dead letters and an executor liveness beat. The upstream
  ``ReplicaSelector`` stops routing to open lanes; a lane killed by a
  ``replica_crash``/``replica_stall`` fault is evicted and its queued
  work redispatched onto its siblings (:mod:`rnb_tpu_torch.runner`).
* **Hedged re-dispatch** (:class:`HedgeGovernor`, step key
  ``hedge_ms``): a dispatch outstanding on a lane past its threshold is
  re-issued to a healthy sibling; the first resolution wins, the loser
  is discarded by request id.

The board and the governor are the reference's, held to it on the CPU
with explicit clocks; each replica step builds one of each, and the
network edge (:mod:`rnb_tpu_torch.netedge`) a board of one lane. Every
method takes an explicit ``now``
(``time.monotonic()`` seconds) so tests drive the state machines
deterministically.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from rnb_tpu_torch import lockwitness, metrics, trace

# -- lane states -------------------------------------------------------

HEALTHY = "healthy"
SUSPECT = "suspect"
OPEN = "open"
HALF_OPEN = "half_open"
EVICTED = "evicted"

#: dead-letters on one lane since its last state transition that trip
#: the circuit one hop (healthy -> suspect, suspect -> open): a lane
#: failing FAST stays low-distress (it beats and settles promptly), so
#: failure count is its own signal next to in-flight age and beat
#: staleness — without it the least-loaded router would keep feeding
#: an always-empty always-failing lane forever
FAILURE_TRIP_THRESHOLD = 3

#: the legal state machine — parse_utils --check replays every lane's
#: transition log against exactly these edges (eviction is legal from
#: any live state: a crash needs no circuit warning first)
LEGAL_TRANSITIONS = {
    (HEALTHY, SUSPECT), (SUSPECT, HEALTHY), (SUSPECT, OPEN),
    (OPEN, HALF_OPEN), (HALF_OPEN, HEALTHY), (HALF_OPEN, OPEN),
    (HEALTHY, EVICTED), (SUSPECT, EVICTED), (OPEN, EVICTED),
    (HALF_OPEN, EVICTED),
}


class HealthSettings:
    """Validated, defaulted view of the ``health`` root config key."""

    __slots__ = ("suspect_after_ms", "open_after_ms",
                 "probe_interval_ms")

    def __init__(self, suspect_after_ms: float = 500.0,
                 open_after_ms: float = 2000.0,
                 probe_interval_ms: float = 1000.0):
        if not suspect_after_ms > 0:
            raise ValueError("health suspect_after_ms must be > 0")
        if open_after_ms < suspect_after_ms:
            raise ValueError("health open_after_ms (%g) must be >= "
                             "suspect_after_ms (%g)"
                             % (open_after_ms, suspect_after_ms))
        if not probe_interval_ms > 0:
            raise ValueError("health probe_interval_ms must be > 0")
        self.suspect_after_ms = float(suspect_after_ms)
        self.open_after_ms = float(open_after_ms)
        self.probe_interval_ms = float(probe_interval_ms)

    @staticmethod
    def from_config(raw: Optional[dict]) -> Optional["HealthSettings"]:
        """Settings from the (schema-validated) config dict, or None
        when the key is absent or ``enabled`` is false — absent means
        no boards, no Health: line, byte-stable logs."""
        if raw is None or not raw.get("enabled", True):
            return None
        return HealthSettings(
            suspect_after_ms=raw.get("suspect_after_ms", 500.0),
            open_after_ms=raw.get("open_after_ms", 2000.0),
            probe_interval_ms=raw.get("probe_interval_ms", 1000.0))


class _Lane:
    """Mutable per-lane record (board-lock protected)."""

    __slots__ = ("state", "since", "last_beat", "inflight", "failures",
                 "path", "probe_outstanding", "probe_t", "redispatched",
                 "routes_after_open", "drained", "instances")

    def __init__(self, now: float):
        self.state = HEALTHY
        self.since = now
        #: end-of-stream reached on this lane (its executor saw the
        #: exit marker, or an evicted lane's drain pump finished)
        self.drained = False
        #: live executor instances serving this lane's queue
        #: (register_instance/instance_died) — the LAST one to die
        #: runs the drain pump; while any lives, the lane still serves
        self.instances = 0
        self.last_beat: Optional[float] = None  # None = not yet live
        #: monotonic enqueue instants of in-flight dispatches, oldest
        #: first — the age signal the circuit trips on
        self.inflight: "deque[float]" = deque()
        self.failures = 0
        #: transition log: state names in visit order, healthy first
        self.path: List[str] = [HEALTHY]
        self.probe_outstanding = False
        self.probe_t = 0.0
        self.redispatched = 0
        self.routes_after_open = 0


class LaneHealthBoard:
    """Shared per-replica-step health state: producers route on it,
    replica executors feed it.

    Thread-safe under one lock (same discipline as
    :class:`rnb_tpu.handoff.InflightDepths`, which it parallels — the
    depths carry the load signal, this board carries the health
    verdict). Every transition is appended to the lane's path log and
    emitted as a ``health.lane_state`` trace instant, so the state
    machine's whole history is a checkable artifact, not a claim.
    """

    #: minimum gap between full state-machine evaluations — beats fire
    #: per executor loop iteration, and an O(lanes) scan under the
    #: shared lock on every one would make the board a hot-loop
    #: serialization point for a machine whose thresholds are
    #: hundreds of milliseconds
    EVAL_INTERVAL_S = 0.02

    #: declared concurrency contract (rnb-lint RNB-C001/C003)
    GUARDED_BY = {
        "_lanes": "_lock",
        "_last_eval": "_lock",
        "num_transitions": "_lock",
        "num_opens": "_lock",
        "num_evictions": "_lock",
        "num_probes": "_lock",
    }

    def __init__(self, queue_indices, settings: HealthSettings):
        self.settings = settings
        self._lock = lockwitness.lock("LaneHealthBoard._lock")
        now = time.monotonic()
        self._last_eval = float("-inf")
        self._lanes: "OrderedDict[int, _Lane]" = OrderedDict(
            (int(q), _Lane(now)) for q in queue_indices)
        # -- counters (snapshot/log-meta schema) ----------------------
        self.num_transitions = 0
        self.num_opens = 0
        self.num_evictions = 0
        self.num_probes = 0

    # -- signal feeds (executor + producer sides) ---------------------

    def beat(self, queue_idx: int, now: Optional[float] = None) -> None:
        """Executor loop-top liveness beat for its lane — and a
        state-machine tick: a wedged sibling's circuit must open even
        after the producer routed its last item (routing is the only
        other evaluation driver), so every live executor's beat also
        advances the clock-driven transitions."""
        with self._lock:
            lane = self._lanes.get(queue_idx)
            if lane is not None:
                now = time.monotonic() if now is None else now
                lane.last_beat = now
                self._evaluate_locked(now)

    def note_enqueue(self, queue_idx: int,
                     now: Optional[float] = None) -> None:
        """Producer routed one dispatch onto the lane: opens its
        in-flight age window (paired with :meth:`note_settle`)."""
        with self._lock:
            lane = self._lanes.get(queue_idx)
            if lane is not None:
                lane.inflight.append(
                    time.monotonic() if now is None else now)

    def note_settle(self, queue_idx: int, n: int = 1) -> None:
        """The lane's executor finished processing ``n`` dispatches
        (or redispatch moved them off the lane): close the oldest
        in-flight windows and let a successful half-open probe heal
        the lane."""
        with self._lock:
            lane = self._lanes.get(queue_idx)
            if lane is None:
                return
            for _ in range(min(n, len(lane.inflight))):
                lane.inflight.popleft()
            if lane.state == HALF_OPEN and lane.probe_outstanding:
                lane.probe_outstanding = False
                self._transition_locked(queue_idx, lane, HEALTHY,
                                 "probe-settled")

    def note_failure(self, queue_idx: int) -> None:
        """A dispatch on this lane was dead-lettered (the PR 1 fault
        stats' per-lane face)."""
        with self._lock:
            lane = self._lanes.get(queue_idx)
            if lane is not None:
                lane.failures += 1

    def evict(self, queue_idx: int, reason: str) -> None:
        """Permanent lane death (replica_crash/replica_stall): the
        lane leaves the routable set forever."""
        with self._lock:
            lane = self._lanes.get(queue_idx)
            if lane is not None and lane.state != EVICTED:
                self._transition_locked(queue_idx, lane, EVICTED, reason)
                self.num_evictions += 1

    def note_redispatch(self, from_queue_idx: int, n: int = 1) -> None:
        """``n`` queued items drained off an evicted lane and
        re-enqueued onto siblings."""
        with self._lock:
            lane = self._lanes.get(from_queue_idx)
            if lane is not None:
                lane.redispatched += n

    def register_instance(self, queue_idx: int) -> None:
        """One executor instance serves this lane's queue (called at
        thread start, before the start barrier). A lane may carry
        several instances (a multi-device sub-mesh per replica); lane
        death is only lane-wide once the LAST one died."""
        with self._lock:
            lane = self._lanes.get(queue_idx)
            if lane is not None:
                lane.instances += 1

    def instance_died(self, queue_idx: int) -> int:
        """One of the lane's executor instances died; returns how many
        remain. The caller runs the eviction drain only at 0 — while
        any instance survives, the lane's queue still has a consumer
        and draining it would steal live work, not rescue stranded
        work."""
        with self._lock:
            lane = self._lanes.get(queue_idx)
            if lane is None:
                return 0
            lane.instances = max(0, lane.instances - 1)
            return lane.instances

    def note_drained(self, queue_idx: int) -> None:
        """This lane's stream is over: its executor consumed the
        end-of-stream marker (or, for an evicted lane, its drain pump
        finished moving the queue's remainder to siblings)."""
        with self._lock:
            lane = self._lanes.get(queue_idx)
            if lane is not None:
                lane.drained = True

    def all_drained(self) -> bool:
        """Every lane of the step has reached end-of-stream.

        The end-of-stream *linger* protocol (rnb_tpu.runner): a
        healthy lane seeing its exit marker must not exit while a
        sibling could still redispatch stranded work onto its queue —
        it keeps polling until every lane is drained. Without this, a
        lane evicted AFTER its siblings finished would re-enqueue its
        queued items into queues nobody reads, stranding exactly the
        requests the drain exists to rescue."""
        with self._lock:
            return all(lane.drained for lane in self._lanes.values())

    # -- the state machine --------------------------------------------

    def _transition_locked(self, queue_idx: int, lane: _Lane, to: str,
                    why: str, now: Optional[float] = None) -> None:
        # lock held by caller; `now` keeps the transition clock in the
        # caller's timeline (unit tests drive it explicitly)
        frm = lane.state
        lane.state = to
        lane.since = time.monotonic() if now is None else now
        lane.failures = 0
        lane.path.append(to)
        self.num_transitions += 1
        if to == OPEN:
            self.num_opens += 1
        if trace.ACTIVE is not None:
            trace.instant("health.lane_state", args={
                "lane": queue_idx, "from": frm, "to": to, "why": why})
        if to == OPEN:
            # the flight recorder's circuit-open trigger
            # (rnb_tpu_torch.metrics): arm a black-box dump of the ring
            # around this exact incident — the recorder's flusher
            # does the IO, never this (board-lock-holding) thread
            metrics.trigger(metrics.TRIGGER_CIRCUIT_OPEN,
                            {"lane": queue_idx, "why": why})

    def _evaluate_locked(self, now: float) -> None:
        if now - self._last_eval < self.EVAL_INTERVAL_S:
            return  # rate-limited: transitions lag by <= 20 ms
        self._last_eval = now
        s = self.settings
        for queue_idx, lane in self._lanes.items():
            if lane.state == EVICTED:
                continue
            # the distress signal: the oldest undrained dispatch's age
            # — and, once the lane has ever beaten, a stale beat while
            # work is outstanding (a wedged executor stops beating but
            # its queue keeps aging; an idle lane with nothing queued
            # is silent, not sick)
            age_ms = ((now - lane.inflight[0]) * 1000.0
                      if lane.inflight else 0.0)
            beat_ms = 0.0
            if lane.inflight and lane.last_beat is not None:
                beat_ms = (now - lane.last_beat) * 1000.0
            distress = max(age_ms, beat_ms)
            # the failure-rate signal: dead-letters since the last
            # transition (reset each hop, so escalation needs FRESH
            # failures at every rung)
            failing = lane.failures >= FAILURE_TRIP_THRESHOLD
            if lane.state == HEALTHY:
                if distress > s.suspect_after_ms or failing:
                    self._transition_locked(
                        queue_idx, lane, SUSPECT,
                        "failures %d" % lane.failures if failing
                        else "distress %.0fms" % distress, now)
            elif lane.state == SUSPECT:
                if distress > s.open_after_ms or failing:
                    self._transition_locked(
                        queue_idx, lane, OPEN,
                        "failures %d" % lane.failures if failing
                        else "distress %.0fms" % distress, now)
                elif distress <= s.suspect_after_ms \
                        and lane.failures == 0 \
                        and (now - lane.since) * 1000.0 \
                        >= s.suspect_after_ms:
                    # recovery needs a CLEAN record since the
                    # transition (failures reset each hop, so healing
                    # demands zero NEW dead-letters) plus a dwell of
                    # suspect_after_ms — a fast-failing lane is
                    # low-distress the instant it transitions, and
                    # dwell-free healing would flap
                    # healthy<->suspect forever
                    self._transition_locked(queue_idx, lane, HEALTHY,
                                     "recovered", now)
            elif lane.state == OPEN:
                if (now - lane.since) * 1000.0 >= s.probe_interval_ms:
                    self._transition_locked(queue_idx, lane, HALF_OPEN,
                                     "probe-due", now)
            elif lane.state == HALF_OPEN:
                if lane.probe_outstanding and \
                        (now - lane.probe_t) * 1000.0 > s.open_after_ms:
                    lane.probe_outstanding = False
                    self._transition_locked(queue_idx, lane, OPEN,
                                     "probe-aged-out", now)

    def state(self, queue_idx: int) -> Optional[str]:
        with self._lock:
            lane = self._lanes.get(queue_idx)
            return lane.state if lane is not None else None

    def route_filter(self, queue_indices,
                     now: Optional[float] = None
                     ) -> Tuple[List[int], Optional[int]]:
        """The producer-side routing consult: evaluate transitions,
        then return ``(routable_lanes, probe_lane)``.

        ``routable_lanes`` is the least-loaded candidate set (healthy
        + suspect lanes, in the caller's order; suspect still serves —
        only an *open* circuit stops traffic). ``probe_lane`` is a
        half-open lane due for its single recovery probe (the caller
        MUST route this dispatch there and nowhere else when set).
        Both empty means no routable lane exists — the caller falls
        back to routing over everything (deterministic beats dropping
        on the floor) and marks those routes ``forced``, which exempts
        them from the ``routes_after_open`` invariant.
        """
        now = time.monotonic() if now is None else now
        with self._lock:
            self._evaluate_locked(now)
            allowed = [q for q in queue_indices
                       if (lane := self._lanes.get(q)) is not None
                       and lane.state in (HEALTHY, SUSPECT)]
            probe = None
            for q in queue_indices:
                lane = self._lanes.get(q)
                if lane is not None and lane.state == HALF_OPEN \
                        and not lane.probe_outstanding:
                    lane.probe_outstanding = True
                    lane.probe_t = now
                    self.num_probes += 1
                    probe = q
                    break
            return allowed, probe

    def consult_and_route(self, queue_idx: int,
                          now: Optional[float] = None) -> bool:
        """Atomic single-lane routing decision: evaluate transitions
        and, in the same locked step, either claim the route (True) or
        refuse it (False, caller goes elsewhere).

        The split ``route_filter`` + ``note_route`` consult leaves a
        window where another thread's evaluation flips the lane OPEN
        between the caller's check and its note — which would count a
        ``routes_after_open`` violation against a dispatch that was
        decided while the lane was still routable. A caller with a
        single candidate lane and a fallback path (the netedge
        dispatcher) uses this instead: the decision and the
        accounting share one lock acquisition, so a route claimed
        here is by construction never a containment violation.
        Healthy/suspect route; a half-open lane grants exactly one
        probe (the claimer must dispatch it); open/evicted refuse.
        """
        now = time.monotonic() if now is None else now
        with self._lock:
            self._evaluate_locked(now)
            lane = self._lanes.get(queue_idx)
            if lane is None:
                return False
            if lane.state in (HEALTHY, SUSPECT):
                return True
            if lane.state == HALF_OPEN and not lane.probe_outstanding:
                lane.probe_outstanding = True
                lane.probe_t = now
                self.num_probes += 1
                return True
            return False

    def note_route(self, queue_idx: int, forced: bool = False) -> None:
        """One dispatch routed to the lane. A route landing on an
        open/evicted lane while routable siblings existed is the
        containment violation ``--check`` holds to zero; ``forced``
        marks the no-routable-sibling fallback, which is exempt."""
        with self._lock:
            lane = self._lanes.get(queue_idx)
            if lane is None:
                return
            if lane.state in (OPEN, EVICTED) and not forced:
                # (probe routes land while the lane is HALF_OPEN, so
                # they never count here)
                lane.routes_after_open += 1

    # -- reporting ----------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """Job-end counters + per-lane detail for the ``Health:`` /
        ``Health lanes:`` log-meta lines (read after the pipeline
        drained, like every other sink snapshot)."""
        with self._lock:
            detail = {
                str(q): {
                    "state": lane.state,
                    "path": list(lane.path),
                    "redispatched_from": lane.redispatched,
                    "routes_after_open": lane.routes_after_open,
                }
                for q, lane in self._lanes.items()}
            return {
                "lanes": len(self._lanes),
                "transitions": self.num_transitions,
                "opens": self.num_opens,
                "evictions": self.num_evictions,
                "probes": self.num_probes,
                "redispatches": sum(lane.redispatched
                                    for lane in self._lanes.values()),
                "routes_after_open": sum(
                    lane.routes_after_open
                    for lane in self._lanes.values()),
                "lane_detail": detail,
            }


def aggregate_board_snapshots(snapshots: List[Dict[str, object]]
                              ) -> Dict[str, object]:
    """Sum per-step board snapshots into the job-wide view (lane
    queue indices are globally unique, so the detail dicts merge
    without collision)."""
    out: Dict[str, object] = {"lanes": 0, "transitions": 0, "opens": 0,
                              "evictions": 0, "probes": 0,
                              "redispatches": 0, "routes_after_open": 0}
    detail: Dict[str, dict] = {}
    for snap in snapshots:
        for key in ("lanes", "transitions", "opens", "evictions",
                    "probes", "redispatches", "routes_after_open"):
            out[key] += int(snap.get(key, 0))
        detail.update(dict(snap.get("lane_detail", {})))
    out["lane_detail"] = detail
    return out


def legal_path(path) -> bool:
    """Is a lane's transition log a legal automaton walk? (The
    ``--check`` invariant: starts healthy, every hop a declared
    edge.)"""
    path = list(path)
    if not path or path[0] != HEALTHY:
        return False
    return all((a, b) in LEGAL_TRANSITIONS
               for a, b in zip(path, path[1:]))


# -- deadline propagation ---------------------------------------------

class DeadlineSettings:
    """Validated view of the ``deadline`` root config key.

    ``budget_ms`` defaults to ``autotune.slo_ms`` when the autotune
    key is present (the one latency contract the config already
    declares), else 1000 ms.
    """

    __slots__ = ("budget_ms",)

    DEFAULT_BUDGET_MS = 1000.0

    def __init__(self, budget_ms: float):
        if not budget_ms > 0:
            raise ValueError("deadline budget_ms must be > 0")
        self.budget_ms = float(budget_ms)

    @staticmethod
    def from_config(raw: Optional[dict],
                    autotune_raw: Optional[dict] = None
                    ) -> Optional["DeadlineSettings"]:
        if raw is None or not raw.get("enabled", True):
            return None
        budget = raw.get("budget_ms")
        if budget is None and autotune_raw:
            budget = autotune_raw.get("slo_ms")
        if budget is None:
            budget = DeadlineSettings.DEFAULT_BUDGET_MS
        return DeadlineSettings(budget_ms=budget)


class DeadlineStats:
    """Job-wide expiry-shed accounting, per check site.

    Deliberately a SECOND ledger next to ``FaultStats.shed_sites``
    (every deadline shed records in both): ``parse_utils --check``
    cross-foots the two, so a check site that shed without counting —
    or counted without shedding — is a detectable inconsistency, not
    silent drift.
    """

    GUARDED_BY = {"expired": "_lock", "sites": "_lock"}

    def __init__(self):
        self._lock = lockwitness.lock("DeadlineStats._lock")
        self.expired = 0
        self.sites: Dict[str, int] = {}

    def record(self, site: str, n: int = 1) -> None:
        with self._lock:
            self.expired += n
            self.sites[site] = self.sites.get(site, 0) + n

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"expired": self.expired, "sites": dict(self.sites)}


#: the shed-site suffix every deadline expiry site carries — the
#: ``--check`` cross-foot selects FaultStats shed sites by it
DEADLINE_SITE_SUFFIX = ":deadline_expired"


def deadline_site(where: str) -> str:
    """The one site-naming rule for deadline sheds (``where`` names
    the boundary, e.g. ``step1_take``)."""
    return where + DEADLINE_SITE_SUFFIX


def cards_of(time_card) -> list:
    """The individual TimeCards behind one pipeline item (mirrors
    rnb_tpu_torch.telemetry.cards_of without importing telemetry)."""
    cards = getattr(time_card, "time_cards", None)
    return list(cards) if cards is not None else [time_card]


def expired(time_card, now: Optional[float] = None) -> bool:
    """Has EVERY constituent request of this item blown its absolute
    deadline? (A fused batch is one indivisible dispatch — it sheds
    only when no member can still meet its contract; wall clock,
    matching the client's enqueue stamps.)

    Cards without a ``deadline_s`` stamp never expire, so the check
    is inert on deadline-off runs and on exit markers.
    """
    now = time.time() if now is None else now
    saw = False
    for tc in cards_of(time_card):
        d = getattr(tc, "deadline_s", None)
        if d is None:
            return False
        saw = True
        if d >= now:
            return False
    return saw


# -- hedged re-dispatch -----------------------------------------------

#: claim() verdicts
WINNER = "winner"
LOSER = "loser"
UNTRACKED = "untracked"


class DirectPayload:
    """A hedge copy's tensor payload, carried INSIDE the queue item in
    place of a ring :class:`rnb_tpu.control.Signal`.

    The original dispatch still owns its ring slot (read + release on
    its own lane); re-enqueueing the same Signal twice would let the
    first consumer release the slot under the second one. A hedge
    instead snapshots the committed (immutable) arrays by reference at
    fire time and ships them directly — same zero-copy discipline as
    the device-resident handoff adopt rule.
    """

    __slots__ = ("payload",)

    def __init__(self, payload):
        self.payload = payload


def clone_cards(time_card):
    """A stamp-complete copy of one item's card (or TimeCardList) for
    a hedge dispatch: same id(s) and timings, so the winner's summary
    row is schema-identical whichever copy wins — but a distinct
    object, so the two lanes' stamps never race on one card. The
    clone carries ``hedge_copy`` (a declared content stamp) so the
    claim site knows which copy resolved first."""
    from rnb_tpu_torch.telemetry import (CONTENT_STAMPS, TimeCard,
                                         TimeCardList)

    def _one(tc):
        child = TimeCard(tc.id)
        child.timings = OrderedDict(tc.timings)
        child.devices = list(tc.devices)
        for attr in CONTENT_STAMPS:
            if hasattr(tc, attr):
                setattr(child, attr, getattr(tc, attr))
        child.hedge_copy = True
        return child

    cards = getattr(time_card, "time_cards", None)
    if cards is not None:
        return TimeCardList([_one(tc) for tc in cards])
    return _one(time_card)


class _Outstanding:
    __slots__ = ("key", "lane", "t0", "payload", "non_tensors", "card",
                 "hedged")

    def __init__(self, key, lane, t0, payload, non_tensors, card):
        self.key = key
        self.lane = lane
        self.t0 = t0
        self.payload = payload
        self.non_tensors = non_tensors
        self.card = card
        self.hedged = False


class HedgeGovernor:
    """Tail-latency hedging for one replica-expanded edge.

    The producer tracks every dispatch it routes onto a lane; when one
    is outstanding past the threshold, :meth:`poll` hands back a hedge
    copy to re-issue on the best healthy sibling. Each hedged request
    id resolves exactly once through :meth:`claim` — consulted at the
    replica step's completion, dead-letter and shed sites — so
    "first completion wins" is an accounting invariant, not a race:
    ``hedges_won + hedges_lost == hedges_fired`` always, and the
    loser's burned service time lands in ``hedges_wasted_ms``
    (overhead, never throughput — the honesty policy).

    Threshold modes: a static ``hedge_ms`` number, or ``"p95x"`` — a
    p95 estimate (EWMA mean + 2 sigma from an EWMA of squares) of the
    edge's own enqueue->settle latency, floored at
    :data:`P95X_MIN_SAMPLES` observations so cold starts never hedge.
    """

    P95X_MIN_SAMPLES = 5
    P95X_MIN_MS = 1.0

    #: declared concurrency contract (rnb-lint RNB-C001/C003); mode /
    #: static_ms / ewma_alpha are immutable after __init__ and so
    #: outside the contract by convention
    GUARDED_BY = {
        "_outstanding": "_lock",
        "_unresolved": "_lock",
        "_resolved": "_lock",
        "_lat_mean_ms": "_lock",
        "_lat_sq_ms": "_lock",
        "_samples": "_lock",
        "fired": "_lock",
        "won": "_lock",
        "lost": "_lock",
        "wasted_ms": "_lock",
    }

    def __init__(self, hedge_ms, ewma_alpha: float = 0.2):
        self.mode = "p95x" if hedge_ms == "p95x" else "static"
        self.static_ms = (float(hedge_ms) if self.mode == "static"
                          else 0.0)
        self.ewma_alpha = float(ewma_alpha)
        self._lock = lockwitness.lock("HedgeGovernor._lock")
        self._outstanding: "OrderedDict[tuple, _Outstanding]" = \
            OrderedDict()
        #: hedged keys awaiting their FIRST resolution (either copy)
        self._unresolved: set = set()
        #: hedged keys whose winner already resolved — the other
        #: copy's resolution is the loser; removed on that second
        #: claim (exactly two copies exist per fired hedge)
        self._resolved: set = set()
        self._lat_mean_ms: Optional[float] = None
        self._lat_sq_ms: Optional[float] = None
        self._samples = 0
        # -- counters (snapshot/log-meta schema) ----------------------
        self.fired = 0
        self.won = 0
        self.lost = 0
        self.wasted_ms = 0.0

    @staticmethod
    def key_of(time_card) -> tuple:
        """The dispatch identity: the sorted tuple of constituent
        request ids (stable across the original and its clone)."""
        return tuple(tc.id for tc in cards_of(time_card))

    # -- producer side ------------------------------------------------

    def threshold_ms(self) -> Optional[float]:
        if self.mode == "static":
            return self.static_ms
        with self._lock:
            if self._samples < self.P95X_MIN_SAMPLES:
                return None
            mean = self._lat_mean_ms or 0.0
            var = max(0.0, (self._lat_sq_ms or 0.0) - mean * mean)
            # mean + 2 sigma approximates p95 for the typical settle
            # distribution, with a 1.5x-mean floor so a low-variance
            # stream never hedges its own median dispatch
            return max(self.P95X_MIN_MS, 1.5 * mean,
                       mean + 2.0 * var ** 0.5)

    def track(self, time_card, lane: int, payload, non_tensors,
              now: Optional[float] = None) -> None:
        """One dispatch routed onto ``lane``: snapshot what a hedge
        would need. Called by the producer BEFORE the enqueue so the
        clone can never race the consumer's stamps."""
        key = self.key_of(time_card)
        clone = clone_cards(time_card)
        now = time.monotonic() if now is None else now
        with self._lock:
            self._outstanding[key] = _Outstanding(
                key, lane, now, payload, non_tensors, clone)

    def _settle_locked(self, key: tuple, now: float) -> None:
        # lock held: close the outstanding window + feed the p95x
        # estimator. A key already settled (the other copy resolved
        # first, or a redundant call) is a no-op.
        entry = self._outstanding.pop(key, None)
        if entry is None:
            return
        lat_ms = (now - entry.t0) * 1000.0
        a = self.ewma_alpha
        self._lat_mean_ms = (lat_ms if self._lat_mean_ms is None
                             else a * lat_ms
                             + (1 - a) * self._lat_mean_ms)
        sq = lat_ms * lat_ms
        self._lat_sq_ms = (sq if self._lat_sq_ms is None
                           else a * sq + (1 - a) * self._lat_sq_ms)
        self._samples += 1

    def settle(self, time_card, now: Optional[float] = None) -> None:
        """Close one dispatch's outstanding window without resolving
        a claim (abort-path bookkeeping; :meth:`claim` settles
        implicitly on every normal resolution path)."""
        with self._lock:
            self._settle_locked(self.key_of(time_card),
                                time.monotonic() if now is None
                                else now)

    def num_outstanding(self) -> int:
        """Tracked dispatches not yet settled — the producer lingers
        on this at end-of-stream (rnb_tpu.runner): exit markers may
        only follow once nothing is left that could still need a
        hedge (a hedge fired after the markers would arrive behind
        them and strand)."""
        with self._lock:
            return len(self._outstanding)

    def poll(self, now: Optional[float] = None) -> List[_Outstanding]:
        """Dispatches outstanding past the threshold and not yet
        hedged — the producer re-issues each on a healthy sibling and
        then commits with :meth:`begin_fire` before enqueueing."""
        threshold = self.threshold_ms()
        if threshold is None:
            return []
        now = time.monotonic() if now is None else now
        due: List[_Outstanding] = []
        with self._lock:
            for entry in self._outstanding.values():
                if entry.hedged:
                    continue
                if (now - entry.t0) * 1000.0 > threshold:
                    due.append(entry)
        return due

    def begin_fire(self, entry: _Outstanding) -> bool:
        """Atomically commit to hedging ``entry`` BEFORE the copy is
        enqueued: False when the dispatch already resolved (its
        consumer's claim settled it between the poll and this call —
        firing then would let the late copy claim WINNER and publish
        the request a second time) or another producer got here
        first. On True the caller MUST enqueue the copy or roll back
        with :meth:`cancel_fire`."""
        with self._lock:
            if entry.hedged or entry.key not in self._outstanding:
                return False
            entry.hedged = True
            self.fired += 1
            self._unresolved.add(entry.key)
            return True

    def cancel_fire(self, entry: _Outstanding) -> None:
        """Roll back :meth:`begin_fire` (the sibling queue was full):
        the dispatch goes back to un-hedged so a later tick retries."""
        with self._lock:
            if entry.hedged and entry.key in self._unresolved:
                entry.hedged = False
                self.fired -= 1
                self._unresolved.discard(entry.key)

    # -- consumer side ------------------------------------------------

    def claim(self, time_card, now: Optional[float] = None) -> str:
        """Resolve one copy of a dispatch: WINNER for the first
        resolution of a hedged key (count it normally), LOSER for the
        second (discard — the rid already terminated), UNTRACKED for
        dispatches no hedge was ever fired for. Always settles the
        key's outstanding window in the same critical section, so a
        dispatch that resolved can never be hedged afterwards
        (:meth:`begin_fire` re-checks under the same lock)."""
        key = self.key_of(time_card)
        is_hedge = any(getattr(tc, "hedge_copy", False)
                       for tc in cards_of(time_card))
        with self._lock:
            self._settle_locked(key, time.monotonic() if now is None
                                else now)
            if key in self._unresolved:
                self._unresolved.discard(key)
                self._resolved.add(key)
                if is_hedge:
                    self.won += 1
                else:
                    self.lost += 1
                return WINNER
            if key in self._resolved:
                self._resolved.discard(key)
                return LOSER
            return UNTRACKED

    def discard(self, time_card) -> None:
        """The losing copy's accounting: the service span it burned at
        the hedged step — the DEEPEST ``inference{i}_start``'s step,
        which is the losing dispatch itself (earlier steps' spans are
        shared pre-fork history both copies paid exactly once, so
        falling back to them would inflate the counter). A loser that
        never finished that span (contained failure mid-service, shed
        before dispatch) counts 0 — undercounting unfinished waste
        beats charging shared work to the hedge."""
        waste = 0.0
        for tc in cards_of(time_card):
            starts: Dict[int, float] = {}
            finishes: Dict[int, float] = {}
            for key, t in tc.timings.items():
                for suffix, into in (("_start", starts),
                                     ("_finish", finishes)):
                    if key.startswith("inference") \
                            and key.endswith(suffix):
                        digits = key[len("inference"):-len(suffix)]
                        if digits.isdigit():
                            into[int(digits)] = t
            if starts:
                step = max(starts)
                t1 = finishes.get(step)
                if t1 is not None:
                    waste = max(waste, (t1 - starts[step]) * 1000.0)
        with self._lock:
            self.wasted_ms += waste

    # -- reporting ----------------------------------------------------

    def live_counters(self) -> Dict[str, int]:
        """Read-only counter view for the live-metrics poll
        (rnb_tpu_torch.metrics) — unlike :meth:`snapshot` it does NOT
        resolve unresolved hedges, so it can be read every flusher
        tick without perturbing the claim ledger. The final metric
        snapshot is taken AFTER :meth:`snapshot` ran at teardown, so
        it foots with the Hedge: log-meta line exactly."""
        with self._lock:
            return {"fired": self.fired, "won": self.won,
                    "lost": self.lost}

    def snapshot(self) -> Dict[str, object]:
        """Final counters; hedges still unresolved at teardown (the
        run was cut off mid-flight) resolve as lost with zero waste so
        ``won + lost == fired`` holds on every path."""
        with self._lock:
            unresolved = len(self._unresolved)
            self._unresolved.clear()
            self.lost += unresolved
            return {"fired": self.fired, "won": self.won,
                    "lost": self.lost,
                    "wasted_ms": int(round(self.wasted_ms))}


def aggregate_hedge_snapshots(snapshots: List[Dict[str, object]]
                              ) -> Dict[str, object]:
    out = {"fired": 0, "won": 0, "lost": 0, "wasted_ms": 0}
    for snap in snapshots:
        for key in out:
            out[key] += int(snap.get(key, 0))
    return out
