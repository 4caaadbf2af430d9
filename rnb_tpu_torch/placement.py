"""Measured-cost placement planner: replication plans from live costs.

Counterpart of ``rnb_tpu/placement.py``, whose arithmetic it keeps to
the digit. Every executor measures its dispatch busy seconds (fault-plan
latency, the stage call and the device sync: the spans the trace records
as ``exec{i}.model_call`` and ``exec{i}.device_sync``) and dispatch
count; :func:`build_report` turns them into the ``Placement:`` line:

* per-dispatch service ``c_i`` = busy seconds / dispatches, offered load
  ``L_i = rate_i * c_i`` with ``rate_i`` = dispatches / wall;
* the executed plan's predicted occupancy ``L_i / n_i`` at its ``n_i``
  instances, which ``parse_utils`` holds to the traced busy fraction;
* the recommendation: every step one device, each spare device of the
  budget to the step with the highest predicted occupancy (ties to the
  lowest step), :func:`recommend`.

A sharded step's service holds a measured collective slice that scales
with the ring-hop factor ``g(k) = (k-1)/k`` (:func:`ring_hop_factor`,
which :mod:`rnb_tpu_torch.whatif` also reads); :func:`service_at_degree`
rescales it and refuses to invent one from a degree-1 run, and
:func:`recommend_joint` plans replicas x degree, each step at the
smallest degree its memory floor admits.

The device budget is the card count the run sees (the reference's is
``len(jax.devices())``): on one card a recommendation names one device
a step, whatever the load.

Config (root key, validated in ``rnb_tpu_torch.config``)::

    "placement": {"mode": "plan"}                         // report only
    "placement": {"mode": "apply", "plan": {"step1": 4}}  // auto-apply

``apply`` expands the named replica counts at parse time (a step's own
``replicas`` key wins) and still reports, so an applied plan's
prediction is checked like any other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

#: modes the root ``placement`` config key accepts
PLACEMENT_MODES = ("plan", "apply")


@dataclasses.dataclass(frozen=True)
class PlacementSettings:
    """Validated view of the ``placement`` root config key."""

    mode: str
    #: step index -> replica count to apply (apply mode only)
    plan: Tuple[Tuple[int, int], ...] = ()

    @staticmethod
    def from_config(raw: Optional[dict]) -> Optional["PlacementSettings"]:
        """Settings from the (schema-validated) config dict, or None
        when the key is absent or ``enabled`` is false."""
        if not raw or not raw.get("enabled", True):
            return None
        mode = raw.get("mode", "plan")
        plan = tuple(sorted(
            (int(key[4:]), int(val))
            for key, val in dict(raw.get("plan") or {}).items()))
        return PlacementSettings(mode=mode, plan=plan)


@dataclasses.dataclass(frozen=True)
class CostRecord:
    """One executor instance's measured dispatch cost, appended by the
    runner's teardown into the launcher's placement sink."""

    step_idx: int
    busy_s: float
    dispatches: int
    #: executed shard degree: 0 = the step declared no `shard` key,
    #: >= 1 = the declared degree (1 included, so an operator
    #: iterating degrees keeps a stable report shape)
    shard_degree: int = 0
    #: host-timed exec{i}.collective seconds (merge gathers), a slice
    #: OF busy_s — the calibration source for degree counterfactuals
    collective_s: float = 0.0
    #: smallest degree the stage's armed HBM feasibility gate admits
    #: (1 when no budget was declared — no documented memory floor)
    min_degree: int = 1


def aggregate_costs(records: Sequence) -> Dict[int, Dict[str, float]]:
    """Per-step sums over the executors' cost records:
    {step_idx: {instances, busy_s, dispatches, shard_degree,
    collective_s, min_degree}}."""
    out: Dict[int, Dict[str, float]] = {}
    for rec in records:
        step = out.setdefault(int(rec.step_idx),
                              {"instances": 0, "busy_s": 0.0,
                               "dispatches": 0, "shard_degree": 0,
                               "collective_s": 0.0, "min_degree": 1})
        step["instances"] += 1
        step["busy_s"] += float(rec.busy_s)
        step["dispatches"] += int(rec.dispatches)
        step["shard_degree"] = max(step["shard_degree"],
                                   int(getattr(rec, "shard_degree", 0)))
        step["collective_s"] += float(getattr(rec, "collective_s", 0.0))
        step["min_degree"] = max(step["min_degree"],
                                 int(getattr(rec, "min_degree", 1)))
    return out


def recommend(loads: Dict[int, float], device_budget: int
              ) -> Dict[int, int]:
    """Greedy replica allocation: minimize the predicted bottleneck
    occupancy ``max_i loads[i] / n_i`` subject to ``sum n_i <=
    device_budget`` and ``n_i >= 1``. Deterministic: ties go to the
    lowest step index."""
    steps = sorted(loads)
    if not steps:
        return {}
    n = {s: 1 for s in steps}
    spare = int(device_budget) - len(steps)
    while spare > 0:
        hottest = max(steps, key=lambda s: (loads[s] / n[s], -s))
        if loads[hottest] <= 0.0:
            break  # nothing left that predicts any occupancy
        n[hottest] += 1
        spare -= 1
    return n


def ring_hop_factor(degree: int) -> float:
    """``g(k) = (k-1)/k`` — the fraction of the gathered bytes a
    degree-k ring moves (k-1 one-step hops of 1/k-sized chunks).
    The collective slice of a sharded step's service scales with this
    factor; g(1) = 0 (no ring, no tax)."""
    degree = int(degree)
    return 0.0 if degree <= 1 else (degree - 1) / degree


def service_at_degree(service_s: float, collective_s: float,
                      degree0: int, degree: int) -> Optional[float]:
    """Per-dispatch service predicted at ``degree``, calibrated from
    the measurement at ``degree0``: the compute slice is invariant
    (weight-gathered sharding), the collective slice scales by
    ``g(degree)/g(degree0)``. Returns None when ``degree0 <= 1`` and
    ``degree > 1`` — a degree-1 run measured NO collective, and this
    module refuses to invent one (whatif documents the same limit on
    its ``shard_degree_step<i>`` vocabulary)."""
    degree0, degree = int(degree0), int(degree)
    if degree == degree0:
        return float(service_s)
    g0 = ring_hop_factor(degree0)
    if g0 <= 0.0:
        if degree <= 1:
            return float(service_s)
        return None
    compute = max(0.0, float(service_s) - float(collective_s))
    return compute + float(collective_s) * ring_hop_factor(degree) / g0


def recommend_joint(loads: Dict[int, float], device_budget: int,
                    degrees: Dict[int, int],
                    collective_loads: Dict[int, float],
                    min_degrees: Dict[int, int]) -> Dict[int, Dict]:
    """Greedy min-bottleneck plan over (replicas x shard degree) under
    ``sum_i n_i * k_i <= device_budget``.

    Degree choice is analytic on this cost model: a higher degree only
    ever *adds* collective tax (compute is degree-invariant under
    weight-gathered sharding) while costing more devices per replica,
    so each step takes the smallest degree its memory floor
    (``min_degrees``) admits — the executed degree when the floor
    binds, degree 1 (shedding the whole measured collective slice,
    a calibrated drop, not an assumed one) when it does not. Replicas
    then spread greedily exactly like :func:`recommend`, except each
    replica of step i costs ``k_i`` devices; a step whose ring no
    longer fits the spare budget is skipped for the next-hottest.

    Returns ``{step: {"replicas", "shard_degree", "load"}}``.
    """
    steps = sorted(loads)
    if not steps:
        return {}
    plan: Dict[int, Dict] = {}
    for s in steps:
        d0 = max(1, int(degrees.get(s, 1)))
        floor = max(1, int(min_degrees.get(s, 1)))
        d = d0 if floor > 1 else 1
        if d == d0:
            load = float(loads[s])
        else:
            # calibrated compute-only load at degree 1: shed the
            # measured collective slice
            load = max(0.0,
                       float(loads[s]) - float(collective_loads.get(
                           s, 0.0)))
        plan[s] = {"replicas": 1, "shard_degree": d, "load": load}
    spare = int(device_budget) - sum(p["shard_degree"]
                                     for p in plan.values())
    while spare > 0:
        order = sorted(
            steps,
            key=lambda s: (-(plan[s]["load"] / plan[s]["replicas"]), s))
        gave = False
        for s in order:
            p = plan[s]
            if p["load"] <= 0.0:
                break
            if p["shard_degree"] <= spare:
                p["replicas"] += 1
                spare -= p["shard_degree"]
                gave = True
                break
        if not gave:
            break
    return plan


def build_report(records: Sequence, wall_s: float, device_budget: int,
                 mode: str) -> Optional[Dict[str, object]]:
    """The ``Placement:`` log-meta payload for one finished run: the
    per-step measured costs, the executed plan's predicted occupancy,
    and the recommendation over the device budget. None when nothing
    was measured (no dispatches or no wall window)."""
    costs = aggregate_costs(records)
    if not costs or wall_s <= 0.0:
        return None
    steps: Dict[str, Dict[str, object]] = {}
    loads: Dict[int, float] = {}
    degrees: Dict[int, int] = {}
    collective_loads: Dict[int, float] = {}
    min_degrees: Dict[int, int] = {}
    sharded = False
    for step_idx in sorted(costs):
        c = costs[step_idx]
        dispatches = int(c["dispatches"])
        instances = int(c["instances"])
        busy = float(c["busy_s"])
        service_s = busy / dispatches if dispatches else 0.0
        rate_hz = dispatches / wall_s
        load = rate_hz * service_s
        loads[step_idx] = load
        row: Dict[str, object] = {
            "instances": instances,
            "dispatches": dispatches,
            "service_ms": round(service_s * 1000.0, 3),
            "rate_hz": round(rate_hz, 4),
            # the executed plan's prediction — what parse_utils
            # --check holds to the traced busy fraction
            "occupancy": round(load / instances if instances else 0.0,
                               4),
        }
        degree = int(c.get("shard_degree", 0))
        degrees[step_idx] = max(1, degree)
        min_degrees[step_idx] = int(c.get("min_degree", 1))
        coll_s = float(c.get("collective_s", 0.0))
        collective_loads[step_idx] = (coll_s / dispatches * rate_hz
                                      if dispatches else 0.0)
        if degree > 0:
            # shard-declared step: service_ms above already CONTAINS
            # the collective slice (the corrected service model), and
            # the slice is reported so the calibration is inspectable
            sharded = True
            row["shard_degree"] = degree
            row["collective_ms"] = round(
                (coll_s / dispatches if dispatches else 0.0) * 1000.0,
                3)
        steps["step%d" % step_idx] = row
    if sharded:
        joint = recommend_joint(loads, device_budget, degrees,
                                collective_loads, min_degrees)
        plan_out = {"step%d" % s: {
            "replicas": joint[s]["replicas"],
            "shard_degree": joint[s]["shard_degree"],
            "occupancy": round(joint[s]["load"]
                               / joint[s]["replicas"], 4)}
            for s in sorted(joint)}
    else:
        plan = recommend(loads, device_budget)
        plan_out = {"step%d" % s: {
            "replicas": plan[s],
            "occupancy": round(loads[s] / plan[s], 4)}
            for s in sorted(plan)}
    return {
        "mode": mode,
        "device_budget": int(device_budget),
        "steps": steps,
        "plan": plan_out,
    }
