"""Run-diff attribution: why job B's latency differs from job A's, by phase.

The port's counterpart of ``scripts/rnb_diff.py``. It aligns the two
jobs' per-request phase decompositions (the stamp-only attribution of
:func:`rnb_tpu_torch.trace.attribute_phases`, so any pair of job
directories works, the JAX package's included), bootstraps a confidence
interval over each phase's mean delta, and prints a ranked table and a
one-line verdict naming the top mover::

    python3 -m rnb_tpu_torch.tools.rnb_diff logs/<A> logs/<B>

* **Work phases** (decode, hold, transfer, inference{i}, drain) are where
  the work changed: they are ranked and give the verdict.
* **Queue phases** (``client_queue``, ``inter_stage_queue``) are
  backpressure symptoms: they grow wherever the bottleneck moved, so they
  are listed apart and never give the verdict.
* **Paired or unpaired**: where a phase has as many samples in both jobs
  (two arms of one seeded A/B complete the same requests), its deltas are
  taken request by request in completion order; otherwise the bootstrap
  is of the difference of means.
* A delta is significant where its (default 95%) CI excludes zero. The
  RNG is ``numpy.random.default_rng`` from ``--seed``, one more for each
  phase in sorted order, so a report is reproducible.

Exit: 0 with a report (a delta is information, not a failure), 2 where a
job directory cannot be read or holds no samples.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np

from rnb_tpu_torch import parse_utils

#: phases that are queueing symptoms, not work
QUEUE_PHASES = ("client_queue", "inter_stage_queue")

DEFAULT_BOOTSTRAPS = 4000
DEFAULT_SEED = 20260804
DEFAULT_CI = 95.0

#: job-level counters worth a line in the report's header
CONTEXT_KEYS = ("throughput_vps", "wall_time_s", "num_failed", "num_shed",
                "cache_hits", "staging_copied_batches", "deadline_expired")


def bootstrap_delta(a: List[float], b: List[float], seed: int,
                    n_boot: int = DEFAULT_BOOTSTRAPS,
                    ci: float = DEFAULT_CI) -> Dict[str, object]:
    """Mean delta (b - a) with a bootstrap CI, paired where the samples
    align one to one: {delta_ms, ci_lo, ci_hi, significant, paired, n_a,
    n_b}."""
    a_arr = np.asarray(a, dtype=float)
    b_arr = np.asarray(b, dtype=float)
    rng = np.random.default_rng(seed)
    lo_pct = (100.0 - ci) / 2.0
    hi_pct = 100.0 - lo_pct
    paired = a_arr.size == b_arr.size and a_arr.size > 0
    if paired:
        d = b_arr - a_arr
        idx = rng.integers(0, d.size, size=(n_boot, d.size))
        boots = d[idx].mean(axis=1)
        delta = float(d.mean())
    else:
        if a_arr.size == 0 or b_arr.size == 0:
            return {"delta_ms": 0.0, "ci_lo": 0.0, "ci_hi": 0.0,
                    "significant": False, "paired": False,
                    "n_a": int(a_arr.size), "n_b": int(b_arr.size)}
        idx_a = rng.integers(0, a_arr.size, size=(n_boot, a_arr.size))
        idx_b = rng.integers(0, b_arr.size, size=(n_boot, b_arr.size))
        boots = b_arr[idx_b].mean(axis=1) - a_arr[idx_a].mean(axis=1)
        delta = float(b_arr.mean() - a_arr.mean())
    ci_lo, ci_hi = (float(v) for v in np.percentile(boots, [lo_pct, hi_pct]))
    return {"delta_ms": delta, "ci_lo": ci_lo, "ci_hi": ci_hi,
            "significant": ci_lo > 0.0 or ci_hi < 0.0,
            "paired": bool(paired),
            "n_a": int(a_arr.size), "n_b": int(b_arr.size)}


def diff_jobs(job_a: str, job_b: str, num_skips: int = 0,
              seed: int = DEFAULT_SEED, n_boot: int = DEFAULT_BOOTSTRAPS,
              ci: float = DEFAULT_CI) -> Dict[str, object]:
    """The attribution report of one job pair: {phases: {phase:
    :func:`bootstrap_delta`}, ranking (work phases, largest |delta|
    first), queue, top, verdict, e2e, context, paired}. Raises OSError or
    ValueError where a job cannot be read or has no samples."""
    meta_a = parse_utils.parse_meta(job_a)
    meta_b = parse_utils.parse_meta(job_b)
    samples_a, e2e_a = parse_utils.job_phase_samples(job_a, num_skips)
    samples_b, e2e_b = parse_utils.job_phase_samples(job_b, num_skips)
    if not samples_a or not samples_b:
        raise ValueError("no per-request phase samples in %s"
                         % (job_a if not samples_a else job_b))
    phases: Dict[str, Dict[str, object]] = {}
    derived_seed = seed
    for phase in sorted(set(samples_a) | set(samples_b)):
        phases[phase] = bootstrap_delta(
            samples_a.get(phase, []), samples_b.get(phase, []),
            seed=derived_seed, n_boot=n_boot, ci=ci)
        derived_seed += 1
    e2e = bootstrap_delta(e2e_a, e2e_b, seed=derived_seed, n_boot=n_boot,
                          ci=ci)
    work = sorted((p for p in phases if p not in QUEUE_PHASES),
                  key=lambda p: (-abs(phases[p]["delta_ms"]), p))
    queue = sorted((p for p in phases if p in QUEUE_PHASES),
                   key=lambda p: (-abs(phases[p]["delta_ms"]), p))
    top = next((p for p in work if phases[p]["significant"]), None)
    if top is not None:
        r = phases[top]
        verdict = ("%s %+.2f ms/req [CI %+.2f, %+.2f] is the top "
                   "significant work-phase delta (end-to-end %+.2f "
                   "ms/req)" % (top, r["delta_ms"], r["ci_lo"], r["ci_hi"],
                                e2e["delta_ms"]))
    else:
        verdict = ("no significant work-phase delta (end-to-end %+.2f "
                   "ms/req)" % e2e["delta_ms"])
    context = {key: (meta_a.get(key), meta_b.get(key))
               for key in CONTEXT_KEYS if key in meta_a or key in meta_b}
    return {"job_a": job_a, "job_b": job_b, "phases": phases,
            "ranking": work, "queue": queue, "top": top,
            "verdict": verdict, "e2e": e2e, "context": context,
            "paired": all(r["paired"] for r in phases.values())}


def report_lines(report: Dict[str, object]) -> List[str]:
    """The text of one :func:`diff_jobs` report."""
    lines = ["rnb_diff: %s -> %s (%s bootstrap)"
             % (report["job_a"], report["job_b"],
                "paired" if report["paired"] else "unpaired")]
    for key, (va, vb) in sorted(dict(report["context"]).items()):
        if isinstance(va, float) or isinstance(vb, float):
            lines.append("  %-22s %s -> %s"
                         % (key, "%.3f" % va if va is not None else "-",
                            "%.3f" % vb if vb is not None else "-"))
        else:
            lines.append("  %-22s %s -> %s" % (key, va, vb))
    phases = dict(report["phases"])

    def row(phase: str) -> str:
        r = phases[phase]
        return ("  %-18s %+9.2f ms/req  [CI %+8.2f, %+8.2f]  %s  (n=%d/%d)"
                % (phase, r["delta_ms"], r["ci_lo"], r["ci_hi"],
                   "SIG " if r["significant"] else "n.s.", r["n_a"],
                   r["n_b"]))

    lines.append("work phases (ranked by |delta|):")
    lines.extend(row(p) for p in report["ranking"])
    if report["queue"]:
        lines.append("queue phases (backpressure symptoms, not causes):")
        lines.extend(row(p) for p in report["queue"])
    e2e = dict(report["e2e"])
    lines.append("  %-18s %+9.2f ms/req  [CI %+8.2f, %+8.2f]  %s"
                 % ("end-to-end", e2e["delta_ms"], e2e["ci_lo"],
                    e2e["ci_hi"], "SIG " if e2e["significant"] else "n.s."))
    lines.append("verdict: %s" % report["verdict"])
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Attribute the latency delta between two job log "
                    "directories to phases, with bootstrap confidence "
                    "intervals")
    parser.add_argument("job_a", help="baseline logs/<job> directory")
    parser.add_argument("job_b", help="candidate logs/<job> directory")
    parser.add_argument("--skips", type=int, default=0,
                        help="rows to skip per table (default 0: every "
                             "completed request)")
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED,
                        help="bootstrap RNG seed")
    parser.add_argument("--bootstraps", type=int, default=DEFAULT_BOOTSTRAPS)
    parser.add_argument("--ci", type=float, default=DEFAULT_CI,
                        help="CI level in percent (default 95)")
    args = parser.parse_args(argv)
    try:
        report = diff_jobs(args.job_a, args.job_b, num_skips=args.skips,
                           seed=args.seed, n_boot=args.bootstraps,
                           ci=args.ci)
    except (OSError, ValueError) as e:
        print("rnb_diff: cannot diff %s vs %s: %s"
              % (args.job_a, args.job_b, e))
        return 2
    for line in report_lines(report):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
