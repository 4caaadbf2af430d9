"""Latency decomposition over job directories, per job and mean interval.

The port's counterpart of ``scripts/latency_summary.py``: each request's
end-to-end latency split into the pipeline's components
(:func:`rnb_tpu_torch.parse_utils.decompose_latency`: filename-queue wait,
decode, frame-queue wait, device hand-off, network, and a ``gap:`` column
for every other pair of adjacent stamps), averaged per (job, mean
interval), printed as the reference's text table with each job's total
and its dispatch batch sizes, and written as JSON. Where the reference
draws a stacked bar chart, the port writes the JSON (no matplotlib)::

    python3 -m rnb_tpu_torch.tools.latency_summary [--log-base logs ...]
        [--recursive] [--json logs/latency_summary.json]

Job directories of both packages read alike (the timing-table and
log-meta schema is shared). ``--recursive`` takes every job directory
below each log base, as ``tools/bench_matrix.py`` and
``tools/latency_frontier.py`` nest them. Exit 1 where no job holds a
timing-table row.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Dict, List

import numpy as np

from rnb_tpu_torch.parse_utils import (concat_frames, decompose_latency,
                                       dispatch_batch_sizes,
                                       get_data_from_all_logs, select_rows)

#: the named components the reference sums (the refined loader split is
#: not among them; its gaps are named, so they are not gaps either)
COMPONENTS = ("filename_queue_wait", "runner0_dispatch", "decode",
              "frame_queue_wait", "device_comm", "neural_net")
DEFAULT_JSON = os.path.join("logs", "latency_summary.json")


def _mean(values: np.ndarray) -> float:
    """The mean over the non-NaN values, NaN where there are none (a
    column another job's schema brought in)."""
    kept = values[~np.isnan(values)]
    return float(kept.mean()) if kept.size else math.nan


def summarize(log_bases: List[str], recursive: bool = False):
    """-> (job metas, one row a (job, mean interval) with each component's
    mean ms, its ``total_ms`` and its ``dispatch_batch_sizes``, the
    component names in column order)."""
    metas, frames = [], []
    for log_base in log_bases:
        jobs, frame = get_data_from_all_logs(log_base, recursive=recursive)
        metas.extend(jobs)
        if frame:
            frames.append(frame)
    if not frames:
        return metas, [], []
    requests = decompose_latency(concat_frames(frames))
    components = [c for c in requests
                  if c.startswith("gap:") or c in COMPONENTS]
    keys = sorted({(job, int(mi)) for job, mi in zip(
        requests["job_id"], requests["mean_interval_ms"])
        if job is not None and mi == mi})
    rows = []
    for job, mi in keys:
        mask = (requests["job_id"] == job) & \
            (requests["mean_interval_ms"] == mi)
        means = {c: _mean(requests[c][mask]) for c in components}
        rows.append({
            "job_id": job, "mean_interval_ms": mi, "components": means,
            "total_ms": sum(v for v in means.values() if v == v),
            "dispatch_batch_sizes": dispatch_batch_sizes(
                select_rows(requests, requests["job_id"] == job))})
    return metas, rows, components


def table_lines(rows: List[Dict[str, object]], components: List[str]
                ) -> List[str]:
    """The reference's text table (``DataFrame.to_string`` without the
    index, floats to three places, NaN for a component a job lacks)."""
    header = ["job_id", "mean_interval_ms"] + list(components)
    cells = [[str(r["job_id"]), str(r["mean_interval_ms"])]
             + ["%.3f" % r["components"][c] if r["components"][c] == r[
                 "components"][c] else "NaN" for c in components]
             for r in rows]
    widths = [max([len(h)] + [len(row[i]) for row in cells])
              for i, h in enumerate(header)]
    return ["  ".join(cell.rjust(w) for cell, w in zip(line, widths))
            for line in [header] + cells]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Per-component latency summary over job directories")
    parser.add_argument("--log-base", action="append", default=None,
                        help="a directory of job directories (repeatable; "
                             "default logs)")
    parser.add_argument("--recursive", action="store_true",
                        help="take every job directory below each log base")
    parser.add_argument("--json", default=DEFAULT_JSON,
                        help="where to write the numbers (default %s)"
                             % DEFAULT_JSON)
    args = parser.parse_args(argv)
    log_bases = args.log_base or ["logs"]
    _metas, rows, components = summarize(log_bases, args.recursive)
    if not rows:
        print("No per-request timing tables found under %r" % log_bases)
        return 1
    for line in table_lines(rows, components):
        print(line)
    print()
    for row in rows:
        line = "%s: total %.3f ms end-to-end mean latency" % (
            row["job_id"], row["total_ms"])
        if row["dispatch_batch_sizes"]:
            line += "  dispatch batch sizes: %s" % ", ".join(
                "%dx%d" % (s, n)
                for s, n in row["dispatch_batch_sizes"].items())
        print(line)
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump({"log_bases": log_bases, "recursive": args.recursive,
                   "components": components,
                   "rows": [dict(r, components={
                       c: (v if v == v else None)
                       for c, v in r["components"].items()})
                       for r in rows]}, f, indent=2)
    print("Wrote %s" % args.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
