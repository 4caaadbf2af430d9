"""Calibrated queueing what-if engine: counterfactuals before builds.

Counterpart of ``rnb_tpu/whatif.py``, the port's own copy, whole: the
same model, calibration and query vocabulary, so a port job directory
and a reference one calibrate to the same numbers from the same
artifacts. It calibrates a per-stage open queueing model from signals
the runtime already streams — the per-stage service histograms bridged
into ``metrics.jsonl`` (``exec{i}.model_call``/``device_sync``), the
lane counts and the declared fault-plan injection from the job-dir
config copy, the arrival rate — and answers counterfactual queries
("what would throughput and queue delay become with another lane, a
stage at half its service, 1.5x the arrivals, a bigger pool") against it.

Model:

* Per stage ``i``: ``lanes_i`` lanes; ``dispatches_i`` batched
  dispatches carrying ``requests / dispatches_i`` requests each;
  per-dispatch service split into a **lane-parallel** part ``p_i``
  (the config-declared fault-plan latency injection) and a
  **host-serial** part ``h_i`` (the measured remainder).
* **Throughput** (:meth:`WhatIfModel.predict_throughput`) comes from a
  deterministic event simulation: dispatches flow stage to stage,
  each claims its stage's earliest-free lane for ``p_i`` then the
  shared host resource for ``h_i``.
* **Queue delay** (:meth:`WhatIfModel.predict_wait_ms`) uses the
  Pollaczek-Khinchine mean-wait formula per stage at the calibrated
  (or scaled) arrival rate; a query that saturates a stage
  (``rho >= 1``) reports ``saturated``.
* **Shard degree**: only the measured ``exec{i}.collective`` slice is
  rescaled, by :func:`rnb_tpu_torch.placement.ring_hop_factor`; a
  degree-1 calibration has no measured slice and predicts no tax. On
  the card the port's one-card degree-2 copy measures the merge as host
  time, and it is kept as measured.
* Extrapolation limits: calibrated from ONE run's operating point;
  service times load-independent, the host one serial resource,
  pool-size queries linear in requests per dispatch.

Calibration sources are artifacts, so it works offline on any job dir
(:func:`calibrate_job`) and in-run at teardown (the ``Whatif:``
log-meta line, gated on the root ``whatif`` config key — absent =>
byte-stable logs). ``whatif`` requires ``metrics``: the service
histograms ARE the calibration data.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Dict, Iterable, List, Mapping, Optional, Tuple


class WhatifSettings:
    """Validated per-job knobs (root config key ``whatif``)."""

    __slots__ = ("enabled",)

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)

    @staticmethod
    def from_config(raw: Optional[dict]) -> Optional["WhatifSettings"]:
        if raw is None:
            return None
        settings = WhatifSettings(enabled=raw.get("enabled", True))
        return settings if settings.enabled else None


class StageCalib:
    """One pipeline stage's calibrated queueing parameters."""

    __slots__ = ("step", "lanes", "dispatches", "service_ms",
                 "service_m2_ms2", "injected_ms", "rows_cap",
                 "collective_ms", "shard_degree")

    def __init__(self, step: int, lanes: int, dispatches: int,
                 service_ms: float, service_m2_ms2: float = 0.0,
                 injected_ms: float = 0.0,
                 rows_cap: Optional[int] = None,
                 collective_ms: float = 0.0, shard_degree: int = 1):
        self.step = int(step)
        self.lanes = max(1, int(lanes))
        self.dispatches = max(0, int(dispatches))
        #: mean per-dispatch service (model_call + device_sync), ms
        self.service_ms = float(service_ms)
        #: second moment of the per-dispatch service (ms^2) — the
        #: P-K wait formula's variance input; 0 = treat deterministic
        self.service_m2_ms2 = float(service_m2_ms2)
        #: config-declared lane-parallel injection per dispatch
        #: (expected fault-plan latency: probability x ms)
        self.injected_ms = float(injected_ms)
        #: row capacity per dispatch (ragged pool_rows), for pool
        #: queries; None = not a pooled stage
        self.rows_cap = rows_cap
        #: mean per-dispatch collective tax (ms) — the measured
        #: ``exec{i}.collective`` merge wall. It is NOT added to
        #: service_ms (the merge span nests inside model_call, so the
        #: service histograms already count it); it is the measured
        #: slice shard-degree queries rescale.
        self.collective_ms = float(collective_ms)
        #: the degree the run was calibrated at (config-declared;
        #: 1 = unsharded)
        self.shard_degree = max(1, int(shard_degree))

    @property
    def host_ms(self) -> float:
        """The host-serial service component: measured minus the
        declared lane-parallel injection, floored at 0."""
        return max(0.0, self.service_ms - self.injected_ms)


class WhatIfModel:
    """A calibrated pipeline + the counterfactual query surface."""

    def __init__(self, stages: List[StageCalib], requests: int,
                 wall_s: float, arrival_hz: Optional[float] = None):
        self.stages = sorted(stages, key=lambda s: s.step)
        self.requests = max(0, int(requests))
        self.wall_s = float(wall_s)
        #: calibrated offered arrival rate (requests/s), None for a
        #: saturated bulk run (arrivals never limited the run)
        self.arrival_hz = arrival_hz

    @property
    def calibrated(self) -> bool:
        return bool(self.stages) and self.requests > 0 \
            and all(s.dispatches > 0 for s in self.stages)

    # -- overrides ----------------------------------------------------

    def _resolved(self, overrides: Optional[Mapping] = None
                  ) -> List[Tuple[StageCalib, int, float, int]]:
        """[(stage, lanes, per-dispatch service ms, dispatches)] with
        a query's overrides applied."""
        overrides = dict(overrides or {})
        replicas = {_step_idx(k): v for k, v
                    in dict(overrides.get("replicas", {})).items()}
        scales = {_step_idx(k): float(v) for k, v
                  in dict(overrides.get("service_scale", {})).items()}
        shard = {_step_idx(k): max(1, int(v)) for k, v
                 in dict(overrides.get("shard_degree", {})).items()}
        pool_rows = overrides.get("pool_rows")
        out = []
        for stage in self.stages:
            lanes = stage.lanes
            if stage.step in replicas:
                spec = replicas[stage.step]
                if isinstance(spec, str) and spec.startswith(("+", "-")):
                    lanes = max(1, lanes + int(spec))
                else:
                    lanes = max(1, int(spec))
            service_base = stage.service_ms
            if stage.step in shard:
                # shard-degree counterfactual: rescale ONLY the
                # measured collective slice by the ring-hop factor
                # ratio g(k)/g(d0), g(k) = (k-1)/k — the compute slice
                # is degree-invariant (weight-gathered sharding divides
                # parameter residency, not FLOPs). Calibrated at
                # degree 1 there is no measured collective slice
                # (collective_ms == 0), so the model honestly predicts
                # no tax rather than inventing one it never measured —
                # validate degree-1 -> k predictions against an
                # executed arm, never trust them.
                from rnb_tpu_torch.placement import ring_hop_factor
                g0 = ring_hop_factor(stage.shard_degree)
                if g0 > 0.0 and stage.collective_ms > 0.0:
                    gk = ring_hop_factor(shard[stage.step])
                    service_base = (stage.service_ms
                                    - stage.collective_ms
                                    + stage.collective_ms * (gk / g0))
            service = service_base * scales.get(stage.step, 1.0)
            dispatches = stage.dispatches
            if pool_rows and stage.rows_cap:
                # first-order: requests-per-dispatch scales with the
                # pool capacity, so dispatch count scales inversely
                factor = float(pool_rows) / float(stage.rows_cap)
                dispatches = max(1, int(math.ceil(
                    stage.dispatches / factor)))
            out.append((stage, lanes, service, dispatches))
        return out

    def _arrivals(self, overrides: Optional[Mapping] = None
                  ) -> Optional[List[float]]:
        """Per-request arrival epochs (seconds), or None for bulk
        (everything offered at t=0)."""
        overrides = dict(overrides or {})
        hz = self.arrival_hz
        if hz is None:
            return None
        hz *= float(overrides.get("arrival_scale", 1.0))
        if hz <= 0.0:
            return None
        return [i / hz for i in range(self.requests)]

    # -- throughput: deterministic event simulation -------------------

    def predict_throughput(self, overrides: Optional[Mapping] = None
                           ) -> Tuple[float, int]:
        """(predicted requests/s, bottleneck step) for the calibrated
        workload size under ``overrides``. The bottleneck is the stage
        with the highest lane-busy fraction over the simulated wall."""
        if not self.calibrated:
            return (0.0, -1)
        arrivals = self._arrivals(overrides)
        ready = (list(arrivals) if arrivals is not None
                 else [0.0] * self.requests)
        host_free = 0.0
        busy_s: Dict[int, float] = {}
        lanes_of: Dict[int, int] = {}
        for stage, lanes, service_ms, dispatches in \
                self._resolved(overrides):
            lanes_of[stage.step] = lanes
            p_s = min(stage.injected_ms, service_ms) / 1000.0
            h_s = max(0.0, service_ms / 1000.0 - p_s)
            lane_free = [0.0] * lanes
            done: List[float] = []
            n = self.requests
            for j in range(dispatches):
                lo = (j * n) // dispatches
                hi = ((j + 1) * n) // dispatches
                if hi <= lo:
                    continue
                dispatch_ready = max(ready[lo:hi])
                lane = min(range(lanes), key=lambda i: lane_free[i])
                start = max(dispatch_ready, lane_free[lane])
                par_done = start + p_s
                host_start = max(par_done, host_free)
                finish = host_start + h_s
                host_free = finish
                lane_free[lane] = finish
                busy_s[stage.step] = busy_s.get(stage.step, 0.0) \
                    + (p_s + h_s)
                done.extend([finish] * (hi - lo))
            ready = done if len(done) == self.requests else ready
        start_s = arrivals[0] if arrivals else 0.0
        wall = max(ready) - start_s if ready else 0.0
        if wall <= 0.0:
            return (0.0, -1)
        bottleneck = max(
            busy_s,
            key=lambda s: (busy_s[s] / lanes_of.get(s, 1), -s))
        return (self.requests / wall, bottleneck)

    # -- queue delay: Pollaczek-Khinchine per stage -------------------

    def predict_wait_ms(self, step: int,
                        overrides: Optional[Mapping] = None
                        ) -> Optional[Dict[str, float]]:
        """Predicted mean queue wait at ``step`` under ``overrides``:
        ``{"rho": utilization, "wait_ms": mean queue delay}`` — or
        ``{"rho": .., "wait_ms": inf}`` when the query saturates the
        stage (the honest answer; no finite wait exists), or None when
        no arrival rate is calibrated (bulk runs have no open-queue
        operating point to perturb)."""
        overrides = dict(overrides or {})
        hz = self.arrival_hz
        if hz is None or not self.calibrated:
            return None
        hz *= float(overrides.get("arrival_scale", 1.0))
        for stage, lanes, service_ms, dispatches in \
                self._resolved(overrides):
            if stage.step != step:
                continue
            if dispatches <= 0 or service_ms <= 0.0:
                return {"rho": 0.0, "wait_ms": 0.0}
            per_dispatch = self.requests / dispatches
            lam = hz / per_dispatch  # dispatch arrivals per second
            mu = 1000.0 / service_ms  # dispatches per lane-second
            rho = lam / (lanes * mu)
            if rho >= 1.0:
                return {"rho": rho, "wait_ms": float("inf")}
            scale = service_ms / stage.service_ms \
                if stage.service_ms > 0.0 else 1.0
            m2 = (stage.service_m2_ms2 * scale * scale
                  if stage.service_m2_ms2 > 0.0 else service_ms ** 2)
            # P-K mean wait, with the multi-lane rho/L approximation:
            # each lane sees lam/lanes of the dispatch stream
            wait_ms = (lam / lanes) / 1000.0 * m2 / (2.0 * (1.0 - rho))
            return {"rho": rho, "wait_ms": wait_ms}
        return None

    def query(self, spec: Optional[Mapping] = None) -> Dict[str, object]:
        """One counterfactual: baseline vs predicted throughput (and
        per-stage waits when an arrival rate is calibrated)."""
        base_vps, base_bottleneck = self.predict_throughput()
        pred_vps, pred_bottleneck = self.predict_throughput(spec)
        out: Dict[str, object] = {
            "base_vps": round(base_vps, 4),
            "pred_vps": round(pred_vps, 4),
            "vps_ratio": round(pred_vps / base_vps, 4)
            if base_vps > 0 else 0.0,
            "base_bottleneck_step": base_bottleneck,
            "pred_bottleneck_step": pred_bottleneck,
        }
        if self.arrival_hz is not None:
            waits = {}
            for stage in self.stages:
                before = self.predict_wait_ms(stage.step)
                after = self.predict_wait_ms(stage.step, spec)
                if before is None or after is None:
                    continue
                waits["step%d" % stage.step] = {
                    "base_wait_ms": round(before["wait_ms"], 3)
                    if math.isfinite(before["wait_ms"]) else "saturated",
                    "pred_wait_ms": round(after["wait_ms"], 3)
                    if math.isfinite(after["wait_ms"]) else "saturated",
                }
            out["waits"] = waits
        return out


def _step_idx(key) -> int:
    """'step1' / '1' / 1 -> 1."""
    if isinstance(key, int):
        return key
    text = str(key)
    return int(text[4:]) if text.startswith("step") else int(text)


# -- calibration -------------------------------------------------------

def _hist_moments(hist: Mapping[str, object],
                  bounds: List[float]) -> Tuple[float, float]:
    """(mean ms, second moment ms^2) of one fixed-log2 metrics
    histogram: the mean is exact (count/sum are carried); the second
    moment approximates each bucket at its geometric midpoint (the
    last, unbounded bucket at 2x its lower bound)."""
    count = int(hist.get("count", 0))
    if count <= 0:
        return (0.0, 0.0)
    mean = float(hist.get("sum_ms", 0.0)) / count
    m2 = 0.0
    lower = 0.0
    for bound, n in zip(bounds, list(hist.get("buckets", []))):
        if not n:
            lower = bound
            continue
        if math.isinf(bound):
            mid = lower * 2.0 if lower > 0.0 else mean
        elif lower <= 0.0:
            mid = bound / 2.0
        else:
            mid = math.sqrt(lower * bound)
        m2 += int(n) * mid * mid
        lower = bound
    return (mean, m2 / count)


def steps_info_from_config(raw: Mapping[str, object]
                           ) -> Dict[int, Dict[str, object]]:
    """{step: {lanes, injected_ms, rows_cap}} from a (job-dir copy of
    a) pipeline config dict: lane counts from the replica-expanded
    device lists, the lane-parallel injection from the declared fault
    plan (expected latency: probability x ms), row capacity from the
    ragged pool."""
    info: Dict[int, Dict[str, object]] = {}
    ragged = raw.get("ragged") if isinstance(raw, dict) else None
    pool_rows = None
    if isinstance(ragged, dict) and ragged.get("enabled", True):
        pool_rows = ragged.get("pool_rows")
    for step_idx, step in enumerate(raw.get("pipeline", [])):
        if not isinstance(step, dict):
            continue
        # 'gpus' is the schema-accepted alias for 'devices'
        # (the config reader): count whichever key the group declares,
        # matching the parsed config's instance count exactly
        lanes = sum(len(g.get("devices") or g.get("gpus") or [])
                    for g in step.get("queue_groups", [])
                    if isinstance(g, dict)) or 1
        shard = step.get("shard")
        shard_degree = 1
        if isinstance(shard, dict):
            try:
                shard_degree = max(1, int(shard.get("degree", 1)))
            except (TypeError, ValueError):
                shard_degree = 1
            # a shard ring is one executable over degree devices, not
            # degree executors — the as-written device list counts
            # replicas x degree entries, but only replicas lanes exist
            lanes = max(1, lanes // shard_degree)
        info[step_idx] = {"lanes": lanes, "injected_ms": 0.0,
                          "rows_cap": pool_rows,
                          "shard_degree": shard_degree}
    plan = raw.get("fault_plan") if isinstance(raw, dict) else None
    faults = dict(plan or {}).get("faults", [])
    for fault in faults or []:
        if not isinstance(fault, dict) or fault.get("kind") != "latency":
            continue
        step_idx = fault.get("step")
        if step_idx in info:
            info[step_idx]["injected_ms"] += (
                float(fault.get("probability", 1.0))
                * float(fault.get("ms", 0.0)))
    return info


_SPAN_RE = re.compile(r"^exec(\d+)\.(model_call|device_sync)$")
#: the shard merge span — parsed SEPARATELY from the service spans:
#: it nests inside model_call, so adding it to sum_ms would count the
#: collective tax twice
_COLL_RE = re.compile(r"^exec(\d+)\.collective$")


def calibrate_from_snapshot(snapshot: Mapping[str, object],
                            steps_info: Mapping[int, Mapping[str, object]],
                            wall_s: float,
                            requests: Optional[int] = None,
                            arrival_hz: Optional[float] = None
                            ) -> WhatIfModel:
    """A model from one metrics snapshot (the final metrics.jsonl
    record — the same dict in-run and offline, so the ``Whatif:`` line
    is reproducible from the artifacts alone) plus the config-derived
    per-step facts. ``requests`` defaults to the snapshot's
    ``slo.tracked`` completion counter; ``arrival_hz`` defaults to
    saturated/bulk (None) — pass the client-arrival or autotune EWMA
    rate for open-queue wait predictions."""
    from rnb_tpu_torch.metrics import hist_upper_bounds
    bounds = hist_upper_bounds()
    hists = dict(snapshot.get("histograms", {}))
    counters = dict(snapshot.get("counters", {}))
    if requests is None:
        requests = int(counters.get("slo.tracked", 0))
    per_step: Dict[int, Dict[str, object]] = {}
    coll_sum_ms: Dict[int, float] = {}
    for name, hist in hists.items():
        cm = _COLL_RE.match(str(name))
        if cm is not None:
            coll_sum_ms[int(cm.group(1))] = \
                coll_sum_ms.get(int(cm.group(1)), 0.0) \
                + float(dict(hist).get("sum_ms", 0.0))
            continue
        m = _SPAN_RE.match(str(name))
        if m is None:
            continue
        step = int(m.group(1))
        entry = per_step.setdefault(
            step, {"dispatches": 0, "sum_ms": 0.0, "m2_ms2": 0.0})
        hist = dict(hist)
        count = int(hist.get("count", 0))
        mean, m2 = _hist_moments(hist, bounds)
        if m.group(2) == "model_call":
            entry["dispatches"] = count
            # the service variance lives in the model_call span; the
            # sync span adds its mean (its variance is second-order)
            entry["m2_ms2"] = m2
        entry["sum_ms"] += float(hist.get("sum_ms", 0.0))
    stages: List[StageCalib] = []
    for step, entry in sorted(per_step.items()):
        dispatches = int(entry["dispatches"])
        if dispatches <= 0:
            continue
        service_ms = entry["sum_ms"] / dispatches
        info = dict(steps_info.get(step, {}))
        # the m2 approximation can undershoot the exact mean (coarse
        # log2 buckets); floor it at the deterministic-service moment
        m2 = max(float(entry["m2_ms2"]), service_ms ** 2)
        stages.append(StageCalib(
            step=step, lanes=int(info.get("lanes", 1) or 1),
            dispatches=dispatches, service_ms=service_ms,
            service_m2_ms2=m2,
            injected_ms=float(info.get("injected_ms", 0.0)),
            rows_cap=info.get("rows_cap"),
            collective_ms=coll_sum_ms.get(step, 0.0) / dispatches,
            shard_degree=int(info.get("shard_degree", 1) or 1)))
    return WhatIfModel(stages, requests=requests, wall_s=wall_s,
                       arrival_hz=arrival_hz)


def arrival_hz_from_snapshot(snapshot: Mapping[str, object]
                             ) -> Optional[float]:
    """The one arrival-rate rule shared by the in-run ``Whatif:``
    line and :func:`calibrate_job`, so the two calibrations can never
    diverge: the autotune controller's arrival EWMA gauge when it
    exists, else the client's windowed arrival rate (which reads 0 on
    a bulk run whose enqueue burst left the window — correctly
    yielding the saturated/bulk model)."""
    gauges = dict(snapshot.get("gauges", {}))
    rates = dict(snapshot.get("rates", {}))
    if gauges.get("autotune.arrival_hz"):
        return float(gauges["autotune.arrival_hz"])
    if rates.get("client.arrivals"):
        return float(rates["client.arrivals"]) or None
    return None


def job_config(job_dir: str) -> Optional[Dict[str, object]]:
    """The pipeline-config copy benchmark.py drops into a job dir
    (first ``*.json`` carrying a ``pipeline`` key), or None. Shared
    with ``parse_utils``'s offline critpath recompute so the two
    consumers can never disagree on which file is the config."""
    for name in sorted(os.listdir(job_dir)):
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(job_dir, name)) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(raw, dict) and "pipeline" in raw:
            return raw
    return None


def _job_wall(job_dir: str) -> float:
    try:
        with open(os.path.join(job_dir, "log-meta.txt")) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    try:
                        t0, t1 = float(parts[0]), float(parts[1])
                    except ValueError:
                        continue
                    return t1 - t0
    except OSError:
        pass
    return 0.0


def calibrate_job(job_dir: str) -> Optional[WhatIfModel]:
    """Calibrate from one job directory's artifacts alone: the final
    metrics.jsonl snapshot, the config copy, and the log-meta wall
    window — the offline twin of the in-run ``Whatif:`` line (the two
    must agree; ``parse_utils --check`` holds them to +-1 milli-vps).
    None when the job streamed no metrics (nothing to calibrate
    from)."""
    path = os.path.join(job_dir, "metrics.jsonl")
    if not os.path.isfile(path):
        return None
    last = None
    with open(path) as f:
        for line in f:
            if line.strip():
                last = line
    if last is None:
        return None
    snapshot = json.loads(last)
    raw = job_config(job_dir) or {}
    return calibrate_from_snapshot(
        snapshot, steps_info_from_config(raw), wall_s=_job_wall(job_dir),
        arrival_hz=arrival_hz_from_snapshot(snapshot))


def summary_counters(model: Optional[WhatIfModel]) -> Dict[str, int]:
    """The ``Whatif:`` log-meta line's integer payload (and the
    ``whatif_*`` BenchmarkResult fields) for one calibrated model —
    zeros/-1 when calibration found nothing to model."""
    if model is None or not model.calibrated:
        return {"stages": len(model.stages) if model else 0,
                "calibrated": 0, "pred_vps_milli": 0,
                "bottleneck_step": -1}
    vps, bottleneck = model.predict_throughput()
    return {"stages": len(model.stages), "calibrated": 1,
            "pred_vps_milli": int(round(vps * 1000.0)),
            "bottleneck_step": int(bottleneck)}
