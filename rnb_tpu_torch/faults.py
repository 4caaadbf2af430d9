"""Failure taxonomy and the deterministic fault-injection plan.

Counterpart of ``rnb_tpu/faults.py``, the port's own copy. The
containment layer (:mod:`rnb_tpu_torch.runner`) sorts every exception
escaping a stage's model call into one of three classes:

* **transient** — worth retrying on the same request: I/O blips, an
  injected :class:`InjectedTransientError`, any plain ``OSError``. The
  executor retries up to the step's ``max_retries`` with
  ``retry_backoff_ms`` of sleep between attempts; an exhausted budget
  degrades the error to permanent.
* **permanent** — the request can never succeed: a corrupt or
  unsupported video (:class:`CorruptVideoError`), an injected
  :class:`InjectedPermanentError`. The request's TimeCard is stamped
  ``failed`` and dead-lettered; the stream continues.
* **fatal** — everything else. Stage-init failures, queue-protocol
  violations and genuine bugs abort the job with ``INTERNAL_ERROR``;
  containment never papers over a broken pipeline.

:class:`FaultPlan` is the chaos side of the same taxonomy: a seeded,
fully deterministic injection schedule (the config's ``fault_plan`` key
or the ``RNB_FAULT_PLAN`` env JSON) that raises classified errors, adds
latency, or stalls a stage at chosen request ids or probabilities. The
draw (:func:`_hash_draw`) is the reference's, so one plan picks the same
request ids in both packages. The ``net_*`` and ``replica_*`` kinds
validate as in the reference; the port has no network edge and no
replica lanes yet, so :mod:`rnb_tpu_torch.benchmark` refuses a plan that
injects them, with the reference's messages.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import Any, Dict, List, Optional

#: classification outcomes (string constants, compared by identity)
TRANSIENT = "transient"
PERMANENT = "permanent"
FATAL = "fatal"

ENV_PLAN = "RNB_FAULT_PLAN"


class TransientError(Exception):
    """Base for errors worth retrying on the same request."""


class PermanentError(Exception):
    """Base for errors that can never succeed for this request."""


class CorruptVideoError(PermanentError, ValueError):
    """Malformed/truncated/unsupported video input.

    Subclasses ValueError so pre-containment callers (and tests) that
    caught the decoders' plain ValueError keep working.
    """


class TransientDecodeError(TransientError, ValueError):
    """Decode-layer I/O error (e.g. the native decoder's read failure)
    — the file may be fine on a retry. Subclasses ValueError for the
    same back-compat reason as :class:`CorruptVideoError`."""


class InjectedTransientError(TransientError):
    """Raised by a :class:`FaultPlan` 'transient' fault."""


class InjectedPermanentError(PermanentError):
    """Raised by a :class:`FaultPlan` 'permanent' fault."""


class NetRefusedError(TransientError):
    """The peer actively refused the dial (nothing listening yet, or
    the listener's backlog is gone). Transient: the peer may come up —
    the sender retries the dial under its capped backoff schedule."""
    fault_reason = "net_refused"


class NetResetError(TransientError):
    """The established connection died mid-stream (RST / broken pipe /
    EOF inside a frame boundary). Transient: the sender reconnects and
    resends every non-terminal window entry; the receiver's dedup
    ledger keeps the resend from double-dispatching."""
    fault_reason = "net_reset"


class NetTimeoutError(TransientError):
    """A configured socket timeout (``netedge.io_timeout_ms``) expired
    waiting on the peer — wedged, not dead. Transient: the sender
    resends the oldest unacked frame / reconnects; the health board
    has usually opened the circuit from beat staleness well before
    this fires (that ordering is asserted by ``make netchaos``)."""
    fault_reason = "net_timeout"


class NetPartialFrameError(TransientError):
    """The stream ended inside a length-prefixed frame (short read).
    Transient: framing is lost so the connection is torn down and
    re-dialed; unacked frames are resent on the fresh connection."""
    fault_reason = "net_partial_frame"


class NetCorruptFrameError(PermanentError):
    """A frame arrived complete but its CRC32 did not match. Permanent
    for the REQUEST it carried: retrying cannot un-corrupt recorded
    bytes, so the request is dead-lettered with reason ``net_corrupt``
    — but framing stayed in sync, so the connection survives."""
    fault_reason = "net_corrupt"


class LaneDeathError(Exception):
    """A replica lane's executor is dead (chaos 'replica_crash' /
    'replica_stall' fault kinds).

    NOT part of the transient/permanent taxonomy: the *lane* fails, not
    the request. The executor (the reference's runner) intercepts it before
    classification on replica lanes — dead-letters the in-service
    dispatch, evicts the lane on the health board
    (the reference's LaneHealthBoard), and re-enqueues the lane's
    queued-but-undispatched work onto healthy siblings. Escaping to
    :func:`classify_error` (a plan targeting a non-replica step with no
    lane to evict) it classifies FATAL, so a misconfigured chaos plan
    aborts loudly instead of silently containing a lane-scale failure
    as one dead-lettered request.
    """

    def __init__(self, message: str, fate: str):
        super().__init__(message)
        #: "crash" (immediate death) or "stall" (wedged, then dead)
        self.fate = fate


#: OSErrors that are deterministic verdicts on the input, not blips —
#: retrying an open() of a file that is not there cannot succeed, so
#: burning the retry budget on them would only delay the dead-letter
_PERMANENT_OS_ERRORS = (FileNotFoundError, IsADirectoryError,
                        NotADirectoryError, PermissionError)


def classify_error(exc: BaseException) -> str:
    """-> TRANSIENT | PERMANENT | FATAL for one caught exception.

    Only explicitly classified errors (and OSError, the canonical
    host-I/O blip — minus its deterministic subtypes like
    FileNotFoundError, which are permanent) are contained; anything
    unrecognized is FATAL so a genuine bug still aborts the job loudly.
    """
    if isinstance(exc, TransientError):
        return TRANSIENT
    if isinstance(exc, PermanentError):
        return PERMANENT
    if isinstance(exc, _PERMANENT_OS_ERRORS):
        return PERMANENT
    if isinstance(exc, OSError):
        return TRANSIENT
    return FATAL


def fault_reason(exc: BaseException) -> str:
    """Stable short reason string for dead-letter accounting."""
    reason = getattr(exc, "fault_reason", None)
    if reason:
        return str(reason)
    if isinstance(exc, LaneDeathError):
        return "replica-%s" % exc.fate
    if isinstance(exc, InjectedTransientError):
        return "injected-transient"
    if isinstance(exc, InjectedPermanentError):
        return "injected-permanent"
    if isinstance(exc, CorruptVideoError):
        return "corrupt-video"
    if isinstance(exc, TransientDecodeError):
        return "decode-io"
    if isinstance(exc, FileNotFoundError):
        return "file-not-found"
    if isinstance(exc, OSError):
        return "os-error"
    return type(exc).__name__.lower()


#: kinds that address the cross-host ingest EDGE (the reference's netedge)
#: instead of a pipeline step: net_refused fires at the sender's dial,
#: the other four fire on the peer while serving a matched request.
#: net_corrupt is the one permanent member (a recorded-bytes verdict);
#: the rest are transient per the PR 1 taxonomy.
NET_KINDS = ("net_refused", "net_reset", "net_timeout",
             "net_partial_frame", "net_corrupt")

VALID_KINDS = ("transient", "permanent", "latency", "stall",
               "replica_crash", "replica_stall") + NET_KINDS

#: kinds that kill a replica LANE rather than fail a request — they
#: carry an optional 'lane' (queue index) address and fire exactly once
#: per matching (step, lane) executor
LANE_KINDS = ("replica_crash", "replica_stall")

#: the one edge-addressed site key used in the deterministic draw for
#: NET_KINDS faults (there is exactly one edge, and it is not a step)
NET_SITE = -1


def validate_plan(spec: Any) -> Dict[str, Any]:
    """Validate a fault-plan dict; returns it. Raises ValueError with a
    config-grade message on any structural problem (rnb_tpu_torch.config
    wraps this into a ConfigError at parse time)."""
    if not isinstance(spec, dict):
        raise ValueError("fault plan must be a JSON object, got %r"
                         % type(spec).__name__)
    seed = spec.get("seed", 0)
    if not isinstance(seed, int):
        raise ValueError("fault plan 'seed' must be an integer")
    faults = spec.get("faults")
    if not isinstance(faults, list):
        raise ValueError("fault plan needs a 'faults' list")
    for idx, f in enumerate(faults):
        where = "fault %d" % idx
        if not isinstance(f, dict):
            raise ValueError("%s must be an object" % where)
        kind = f.get("kind")
        if kind not in VALID_KINDS:
            raise ValueError("%s: 'kind' must be one of %s, got %r"
                             % (where, list(VALID_KINDS), kind))
        step = f.get("step")
        if step is not None and (not isinstance(step, int) or step < 0):
            raise ValueError("%s: 'step' must be a non-negative integer "
                             "(or omitted for every step)" % where)
        ids = f.get("request_ids")
        prob = f.get("probability")
        if (ids is None) == (prob is None):
            raise ValueError("%s needs exactly one of 'request_ids' or "
                             "'probability'" % where)
        if ids is not None and (
                not isinstance(ids, list)
                or not all(isinstance(i, int) for i in ids)):
            raise ValueError("%s: 'request_ids' must be a list of "
                             "integers" % where)
        if prob is not None and not (isinstance(prob, (int, float))
                                     and 0.0 <= prob <= 1.0):
            raise ValueError("%s: 'probability' must be in [0, 1]" % where)
        fatal = f.get("fatal")
        if fatal is not None:
            if kind != "net_reset":
                raise ValueError("%s: 'fatal' only applies to net_reset "
                                 "faults (it kills the peer process)"
                                 % where)
            if not isinstance(fatal, bool):
                raise ValueError("%s: 'fatal' must be a boolean" % where)
        if kind in NET_KINDS:
            if step is not None:
                raise ValueError("%s: net faults address the edge; "
                                 "'step' is not allowed" % where)
            if f.get("lane") is not None:
                raise ValueError("%s: net faults address the edge; "
                                 "'lane' is not allowed" % where)
            if "times" in f:
                raise ValueError("%s: 'times' only applies to "
                                 "transient/permanent faults" % where)
            if kind == "net_timeout":
                ms = f.get("ms")
                if not (isinstance(ms, (int, float)) and ms >= 0):
                    raise ValueError("%s: net_timeout faults need a "
                                     "non-negative 'ms' (peer wedge "
                                     "duration)" % where)
            elif "ms" in f:
                raise ValueError("%s: among net faults only net_timeout "
                                 "takes 'ms'" % where)
        elif kind in ("latency", "stall", "replica_stall"):
            ms = f.get("ms")
            if not (isinstance(ms, (int, float)) and ms >= 0):
                raise ValueError("%s: %r faults need a non-negative 'ms'"
                                 % (where, kind))
            if "times" in f:
                # would be silently ignored (delay kinds fire on
                # attempt 0 only; lane deaths are permanent by nature)
                # — reject like any other typo
                raise ValueError("%s: 'times' only applies to "
                                 "transient/permanent faults" % where)
        elif kind == "replica_crash":
            if "ms" in f:
                raise ValueError("%s: 'ms' only applies to latency/"
                                 "stall/replica_stall faults" % where)
            if "times" in f:
                raise ValueError("%s: 'times' only applies to "
                                 "transient/permanent faults" % where)
        else:
            if "ms" in f:
                raise ValueError("%s: 'ms' only applies to latency/"
                                 "stall/replica_stall faults" % where)
            times = f.get("times", 1)
            if not (isinstance(times, int) and times >= 1):
                raise ValueError("%s: 'times' must be a positive integer"
                                 % where)
        lane = f.get("lane")
        if lane is not None:
            # any kind may be lane-addressed: replica_crash/
            # replica_stall target the lane itself; a lane-addressed
            # 'latency'/'stall' is the SLOW-LANE class (one replica
            # degrades while its siblings stay fast — the shape
            # hedged re-dispatch exists for); error kinds emulate a
            # lane-local fault domain
            if not (isinstance(lane, int) and not isinstance(lane, bool)
                    and lane >= 0):
                raise ValueError("%s: 'lane' must be a non-negative "
                                 "queue index" % where)
        reason = f.get("reason")
        if reason is not None and not isinstance(reason, str):
            raise ValueError("%s: 'reason' must be a string" % where)
        unknown = set(f) - {"kind", "step", "request_ids", "probability",
                            "ms", "times", "reason", "lane", "fatal"}
        if unknown:
            raise ValueError("%s has unknown keys %s"
                             % (where, sorted(unknown)))
    unknown = set(spec) - {"seed", "faults"}
    if unknown:
        raise ValueError("fault plan has unknown keys %s"
                         % sorted(unknown))
    return spec


def _hash_draw(seed: int, fault_idx: int, step_idx: int,
               request_id: int) -> float:
    """Deterministic uniform [0, 1) draw keyed by the fault site —
    stateless, so concurrent stage threads cannot perturb each other's
    draws (a shared RNG would make plans depend on thread scheduling)."""
    key = ("%d:%d:%d:%d" % (seed, fault_idx, step_idx, request_id))
    return zlib.crc32(key.encode()) / 2.0 ** 32


class FaultPlan:
    """A validated, deterministic fault-injection schedule.

    The executor consults two hooks per request:

    * :meth:`stall_ms` before the inference span — 'stall' faults wedge
      the stage thread there, so the induced delay lands in downstream
      queue-wait accounting (the queue behind the stage backs up);
    * :meth:`fire` immediately before each model-call attempt —
      'latency' faults sleep inside the inference span, 'transient' /
      'permanent' faults raise their classified error. Error faults
      fire on the first ``times`` attempts of a request (default 1), so
      an injected transient succeeds on retry — the shape the retry
      budget exists for.

    Matching is by TimeCard id. Both hooks accept one id or the id list
    of a fused TimeCardList batch: a fault matching ANY constituent
    affects the whole fused dispatch (the blast radius a real fault at
    a batched stage has), so plans targeting downstream-of-batcher
    steps fire instead of silently never matching.
    """

    def __init__(self, spec: Dict[str, Any]):
        spec = validate_plan(spec)
        self.seed = int(spec.get("seed", 0))
        self.faults: List[Dict[str, Any]] = list(spec.get("faults", []))
        # pre-resolve id lists to sets for the hot-loop membership test
        self._id_sets = [set(f["request_ids"])
                         if f.get("request_ids") is not None else None
                         for f in self.faults]

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        """Plan from the RNB_FAULT_PLAN env JSON, or None if unset."""
        raw = os.environ.get(ENV_PLAN)
        if not raw:
            return None
        try:
            spec = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ValueError("%s is not valid JSON: %s" % (ENV_PLAN, e)) \
                from e
        return cls(spec)

    def check_steps(self, num_steps: int) -> None:
        """Reject fault 'step' indices outside the pipeline — a typo'd
        step would otherwise silently never fire while --check reports
        the plan active (the chaos run would then read as 'containment
        verified' without a single fault injected)."""
        for idx, f in enumerate(self.faults):
            step = f.get("step")
            if step is not None and step >= num_steps:
                raise ValueError(
                    "fault %d targets step %d but the pipeline has %d "
                    "step(s) (0..%d) — the fault would never fire"
                    % (idx, step, num_steps, num_steps - 1))

    @classmethod
    def resolve(cls, config_plan: Optional[Dict[str, Any]]
                ) -> Optional["FaultPlan"]:
        """The ONE precedence rule for plan resolution, shared by the
        launcher and --check so they can never disagree: the
        RNB_FAULT_PLAN env JSON overrides the config's ``fault_plan``
        key; None when neither is set."""
        plan = cls.from_env()
        if plan is None and config_plan is not None:
            plan = cls(config_plan)
        return plan

    @staticmethod
    def _as_ids(request_ids) -> tuple:
        return ((request_ids,) if isinstance(request_ids, int)
                else tuple(request_ids))

    @staticmethod
    def _lane_matches(fault: Dict[str, Any],
                      lane: Optional[int]) -> bool:
        """Lane-addressed faults fire only on the named replica lane
        (the executor passes its input-queue index); un-addressed
        faults fire anywhere."""
        fault_lane = fault.get("lane")
        return fault_lane is None or fault_lane == lane

    def _matches(self, fault_idx: int, fault: Dict[str, Any],
                 step_idx: int, request_ids: tuple) -> Optional[int]:
        """The first matching request id of the batch, or None."""
        step = fault.get("step")
        if step is not None and step != step_idx:
            return None
        ids = self._id_sets[fault_idx]
        for rid in request_ids:
            if ids is not None:
                if rid in ids:
                    return rid
            elif _hash_draw(self.seed, fault_idx, step_idx,
                            rid) < fault["probability"]:
                return rid
        return None

    def stall_ms(self, step_idx: int, request_ids,
                 lane: Optional[int] = None) -> float:
        """Total 'stall' milliseconds scheduled at this site (one id or
        a fused batch's id list — each fault contributes at most once
        per dispatch). A lane-addressed stall wedges only the named
        replica lane's dispatches (the slow-lane chaos class)."""
        request_ids = self._as_ids(request_ids)
        total = 0.0
        for idx, f in enumerate(self.faults):
            if f["kind"] == "stall" and self._lane_matches(f, lane) \
                    and self._matches(
                        idx, f, step_idx, request_ids) is not None:
                total += float(f["ms"])
        return total

    def fire(self, step_idx: int, request_ids,
             attempt: int = 0, lane: Optional[int] = None) -> None:
        """Sleep scheduled latency, then raise the first matching error
        fault whose ``times`` budget covers this attempt.

        ``lane`` is the calling executor's input-queue index on a
        replica-expanded step (None elsewhere): 'replica_crash' /
        'replica_stall' faults optionally address one lane with it and
        raise :class:`LaneDeathError` — a stall first wedges the
        executor for ``ms`` inside the dispatch (beats stop, the health
        board's circuit opens from the missing-liveness signal) before
        the lane is declared dead."""
        request_ids = self._as_ids(request_ids)
        for idx, f in enumerate(self.faults):
            kind = f["kind"]
            if kind not in LANE_KINDS or attempt > 0:
                continue
            if not self._lane_matches(f, lane):
                continue
            rid = self._matches(idx, f, step_idx, request_ids)
            if rid is None:
                continue
            fate = "crash" if kind == "replica_crash" else "stall"
            if kind == "replica_stall":
                time.sleep(float(f["ms"]) / 1000.0)
            exc = LaneDeathError(
                "injected %s at step %d lane %s (request %d)"
                % (kind, step_idx, lane, rid), fate)
            reason = f.get("reason")
            if reason:
                exc.fault_reason = reason
            raise exc
        for idx, f in enumerate(self.faults):
            kind = f["kind"]
            if kind == "latency" and attempt == 0 \
                    and self._lane_matches(f, lane) \
                    and self._matches(idx, f, step_idx,
                                      request_ids) is not None:
                time.sleep(float(f["ms"]) / 1000.0)
        for idx, f in enumerate(self.faults):
            kind = f["kind"]
            if kind not in ("transient", "permanent"):
                continue
            if attempt >= int(f.get("times", 1)):
                continue
            if not self._lane_matches(f, lane):
                continue
            rid = self._matches(idx, f, step_idx, request_ids)
            if rid is None:
                continue
            reason = f.get("reason")
            msg = ("injected %s fault at step %d, request %d (attempt %d)"
                   % (kind, step_idx, rid, attempt))
            if kind == "transient":
                exc: Exception = InjectedTransientError(msg)
            else:
                exc = InjectedPermanentError(msg)
            if reason:
                exc.fault_reason = reason
            raise exc

    def has_net_faults(self) -> bool:
        """True if any fault addresses the network edge — the launcher
        rejects such a plan when ``netedge`` is off, the same loud-typo
        posture as LANE_KINDS without replicas (the chaos run would
        otherwise read 'containment verified' with zero injections)."""
        return any(f["kind"] in NET_KINDS for f in self.faults)

    def net_fault(self, kind: str, request_id: int
                  ) -> Optional[tuple]:
        """First matching edge fault of ``kind`` for one request id, as
        ``(fault_idx, fault_dict)``, or None.

        Net faults draw at the edge site (:data:`NET_SITE`), not a
        step. The plan stays stateless (same thread-safety contract as
        :meth:`fire`), so the CALLER keeps a fired ledger keyed by the
        returned ``fault_idx`` + request id — a resend of the same
        request must re-match here without re-firing there, otherwise
        a net_reset would reset every resend of its victim forever.
        ``net_refused`` is consulted at dial time where no request is
        in scope: the sender passes its dial counter as the id, which
        keeps the draw deterministic per attempt.
        """
        request_ids = self._as_ids(request_id)
        for idx, f in enumerate(self.faults):
            if f["kind"] != kind:
                continue
            if self._matches(idx, f, NET_SITE, request_ids) is not None:
                return idx, f
        return None

    def describe(self) -> str:
        """One-line summary for --check output and logs."""
        kinds: Dict[str, int] = {}
        for f in self.faults:
            kinds[f["kind"]] = kinds.get(f["kind"], 0) + 1
        detail = ", ".join("%d %s" % (n, k)
                           for k, n in sorted(kinds.items()))
        return "seed=%d, %d fault(s)%s" % (
            self.seed, len(self.faults),
            (" [%s]" % detail) if detail else "")
