"""The explanation plane checked end to end on the port: the three legs of
``scripts/explain_demo.py`` (``make explain``).

1. **Critical path.** On a ``critpath`` job every request's blocking
   chain sums to its end-to-end latency within 1 ms,
   ``parse_utils --explain`` exits 0 and the job's checks pass
   (:func:`leg_critpath`).
2. **What-if against reality.** The one-card copy of
   ``configs/rnb-scaleout-r1.json`` with the ``metrics`` and ``whatif``
   keys added is served; a queueing model is calibrated from its job
   directory alone (:func:`rnb_tpu_torch.whatif.calibrate_job`) and asked
   ``{"replicas": {"step1": "+3"}}``. The predicted r4/r1 ratio must
   land within 25% (the reference's bound) of the ratio the r4 copy
   measures against it (:func:`leg_whatif`).
3. **Attribution with a known answer.** Two same-seed runs of one fused
   yuv420 config at a light Poisson rate; arm B adds a ``latency`` fault
   of 5 ms on every dispatch of the runner step. ``rnb_diff`` must rank
   that step's ``inference{i}`` as the top significant work phase, with a
   delta between 2.5 and 10 ms a request, and a self-diff of arm A must
   find no significant phase (:func:`leg_attribution`).

``main`` serves every arm itself on the card and exits 0 where all three
legs hold, 1 otherwise; ``chip_smoke.py``
calls the legs on the jobs its own phases serve. The copies are written
under ``--out`` (default ``logs/explain``), never into ``configs/``::

    python3 -m rnb_tpu_torch.tools.explain [--out DIR]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

from rnb_tpu_torch import critpath, parse_utils
from rnb_tpu_torch import whatif as whatif_mod
from rnb_tpu_torch.tools import rnb_diff

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "logs", "explain")

#: leg 1: the traced fused cell with critpath on
CRITPATH_CONFIG = "configs/rnb-fused-yuv-traced.json"
CRITPATH_VIDEOS = 24
#: the bound on a chain's miss of its request's latency (ms)
RESIDUAL_MS = 1.0

#: leg 2: the scale-out pair at ``scripts/multichip_demo.py``'s workload
R1_CONFIG = "configs/rnb-scaleout-r1.json"
R4_CONFIG = "configs/rnb-scaleout-r4.json"
LANES_VIDEOS = 12
LANES_QUEUE = 64
LANES_SEED = 17
#: the counterfactual r4 answers: three more lanes on step 1
REPLICAS_QUERY = {"replicas": {"step1": "+3"}}
RATIO_TOL = 0.25
METRICS_KEY = {"enabled": True, "interval_ms": 200}

#: leg 3: same-seed arms of one fused yuv420 config, light Poisson load
ATTRIBUTION_CONFIG = "configs/rnb-fused-yuv.json"
ATTRIBUTION_MI = 20
ATTRIBUTION_VIDEOS = 100
ATTRIBUTION_SEED = 7
INJECTED_MS = 5
DELTA_RANGE = (2.5, 10.0)


def one_card(raw: dict) -> dict:
    """``raw`` with every device index >= 0 made 0 (the host stays the
    host; a mesh step's members too)."""
    for step in raw["pipeline"]:
        for group in step["queue_groups"]:
            group["devices"] = [0 if d >= 0 else d for d in group["devices"]]
        if "mesh_devices" in step:
            step["mesh_devices"] = [0] * len(step["mesh_devices"])
    return raw


def _load(config: str) -> dict:
    with open(config if os.path.isabs(config)
              else os.path.join(REPO, config)) as f:
        return json.load(f)


def _write(raw: dict, out_dir: str, name: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name + ".json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def critpath_copy(out_dir: str, config: str = CRITPATH_CONFIG) -> str:
    """``config`` with ``critpath`` on (its trace kept), on one card."""
    raw = one_card(_load(config))
    raw["critpath"] = {"enabled": True}
    return _write(raw, out_dir, "explain-critpath")


def whatif_copy(out_dir: str, config: str = R1_CONFIG,
                name: str = "explain-r1-whatif") -> str:
    """The one-card copy of ``config`` with the root ``metrics`` key (the
    calibration's data) and ``whatif`` added."""
    raw = one_card(_load(config))
    raw["metrics"] = dict(METRICS_KEY)
    raw["whatif"] = {"enabled": True}
    return _write(raw, out_dir, name)


def runner_step(raw: dict) -> int:
    """The index of the config's first ``R2P1DRunner`` step."""
    return next(idx for idx, step in enumerate(raw["pipeline"])
                if step["model"].endswith(".R2P1DRunner"))


def attribution_copies(out_dir: str, config: str = ATTRIBUTION_CONFIG,
                       ms: float = INJECTED_MS) -> Tuple[str, str, int]:
    """(arm A, arm B, the runner step): the one-card copy of ``config``
    as it is, and with a ``latency`` fault of ``ms`` on every dispatch of
    the runner step."""
    raw = one_card(_load(config))
    step = runner_step(raw)
    path_a = _write(raw, out_dir, "explain-arm-a")
    raw["fault_plan"] = {"faults": [{"kind": "latency", "step": step,
                                     "probability": 1.0, "ms": ms}]}
    return path_a, _write(raw, out_dir, "explain-arm-b"), step


def worst_residual_ms(job_dir: str) -> float:
    """The largest miss of a row's blocking chain against its end-to-end
    latency, over every row of every table."""
    worst = 0.0
    for path in parse_utils.timing_tables(job_dir):
        keys, rows = parse_utils.read_table(path)
        for row in rows:
            chain = critpath.blocking_chain(dict(zip(keys, row)))
            worst = max(worst, abs(sum(ms for _c, _s, ms in chain)
                                   - 1e3 * (max(row) - min(row))))
    return worst


def _job_problems(label: str, job_dir: str) -> List[str]:
    problems, _parse_failed = parse_utils.check_job_detail(job_dir)
    return ["%s --check: %s" % (label, p) for p in problems]


def leg_critpath(job_dir: str, out=None) -> Tuple[List[str], Dict]:
    """Leg 1 on a critpath job: (failures, {worst_residual_ms,
    explain_rc, explanation})."""
    text = io.StringIO()
    rc = parse_utils.print_explanation(job_dir, text)
    (out or sys.stdout).write(text.getvalue())
    worst = worst_residual_ms(job_dir)
    failures = _job_problems("critpath job", job_dir)
    if rc != 0:
        failures.append("parse_utils --explain exited %d" % rc)
    if worst > RESIDUAL_MS:
        failures.append("a blocking chain misses its request's latency by "
                        "%.3f ms (> %.0f)" % (worst, RESIDUAL_MS))
    if "blocking-chain attribution over" not in text.getvalue():
        failures.append("--explain attributed no request")
    return failures, {"worst_residual_ms": worst, "explain_rc": rc,
                      "explanation": text.getvalue()}


def leg_whatif(r1_job_dir: str, r1_vps: float, r4_vps: float,
               query: Optional[dict] = None) -> Tuple[List[str], Dict]:
    """Leg 2: (failures, {pred_ratio, measured_ratio, rel_err}) of the
    model calibrated from the r1 job alone against r4's measured
    videos/s over r1's."""
    failures = _job_problems("r1 whatif job", r1_job_dir)
    model = whatif_mod.calibrate_job(r1_job_dir)
    if model is None or not model.calibrated:
        failures.append("calibrate_job found nothing to model in %s"
                        % r1_job_dir)
        pred = 0.0
    else:
        pred = float(model.query(query or REPLICAS_QUERY)["vps_ratio"])
    measured = r4_vps / r1_vps if r1_vps > 0 else 0.0
    rel_err = abs(pred - measured) / measured if measured > 0 else 1.0
    if rel_err > RATIO_TOL:
        failures.append("what-if predicts an r4/r1 ratio of %.3f, the "
                        "copies measured %.3f (rel err %.1f%% > %d%%)"
                        % (pred, measured, 100.0 * rel_err,
                           round(100 * RATIO_TOL)))
    return failures, {"pred_ratio": pred, "measured_ratio": measured,
                      "rel_err": rel_err}


def leg_attribution(job_a: str, job_b: str, phase: str,
                    delta_range=DELTA_RANGE) -> Tuple[List[str], Dict]:
    """Leg 3: (failures, the A -> B report) where B injected latency into
    ``phase``; the self-diff of A must find nothing significant."""
    failures = (_job_problems("arm A", job_a)
                + _job_problems("arm B", job_b))
    report = rnb_diff.diff_jobs(job_a, job_b)
    if report["top"] != phase:
        failures.append("rnb_diff names %r as the top significant work "
                        "phase; arm B injected into %r"
                        % (report["top"], phase))
    else:
        delta = report["phases"][phase]["delta_ms"]
        low, high = delta_range
        if not low <= delta <= high:
            failures.append("%s %+.3f ms/req, outside [%g, %g]"
                            % (phase, delta, low, high))
    self_report = rnb_diff.diff_jobs(job_a, job_a)
    significant = sorted(p for p, r in self_report["phases"].items()
                         if r["significant"])
    if significant or self_report["e2e"]["significant"]:
        failures.append("a self-diff of arm A finds %s significant"
                        % (significant or ["end-to-end"]))
    return failures, report


def serve(config: str, videos: int, mi: int, seed: int, log_base: str,
          queue_size: int = 50000):
    """One run of ``config`` on the card; raises unless it ends cleanly."""
    from rnb_tpu_torch.benchmark import run_benchmark
    result = run_benchmark(config, mean_interval_ms=mi, num_videos=videos,
                           queue_size=queue_size, log_base=log_base,
                           print_progress=False, seed=seed, platform="cuda")
    if result.termination_flag != 0:
        raise RuntimeError("%s ended with termination flag %d"
                           % (config, result.termination_flag))
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="The explanation plane's three legs on the port")
    parser.add_argument("--out", default=DEFAULT_OUT,
                        help="where the copies and the jobs go")
    args = parser.parse_args(argv)
    logs = os.path.join(args.out, "jobs")
    failures = []

    res = serve(critpath_copy(args.out), CRITPATH_VIDEOS, 0, LANES_SEED,
                logs)
    more, leg1 = leg_critpath(res.log_dir)
    failures += more
    print("leg 1: worst residual %.3f ms, --explain rc %d"
          % (leg1["worst_residual_ms"], leg1["explain_rc"]))

    r1 = serve(whatif_copy(args.out), LANES_VIDEOS, 0, LANES_SEED, logs,
               LANES_QUEUE)
    r4_path = _write(one_card(_load(R4_CONFIG)), args.out, "explain-r4")
    r4 = serve(r4_path, LANES_VIDEOS, 0, LANES_SEED, logs, LANES_QUEUE)
    more, leg2 = leg_whatif(r1.log_dir, r1.throughput_vps, r4.throughput_vps)
    failures += more
    print("leg 2: r1 %.3f, r4 %.3f videos/s; predicted r4/r1 %.3f against "
          "%.3f measured (rel err %.1f%%)"
          % (r1.throughput_vps, r4.throughput_vps, leg2["pred_ratio"],
             leg2["measured_ratio"], 100.0 * leg2["rel_err"]))

    path_a, path_b, step = attribution_copies(args.out)
    arm_a = serve(path_a, ATTRIBUTION_VIDEOS, ATTRIBUTION_MI,
                  ATTRIBUTION_SEED, logs)
    arm_b = serve(path_b, ATTRIBUTION_VIDEOS, ATTRIBUTION_MI,
                  ATTRIBUTION_SEED, logs)
    more, report = leg_attribution(arm_a.log_dir, arm_b.log_dir,
                                   "inference%d" % step)
    failures += more
    for line in rnb_diff.report_lines(report):
        print(line)

    if failures:
        print("\nexplain: FAIL")
        for failure in failures:
            print("  - %s" % failure)
        return 1
    print("\nexplain: OK: the chains partition, the counterfactual lands "
          "within %d%%, the injected phase is named"
          % round(100 * RATIO_TOL))
    return 0


if __name__ == "__main__":
    sys.exit(main())
