"""Poisson throughput-latency frontier of the port: p50/p99 against
offered load, each cell in a fresh ``bench_cuda.py`` process.

The port's counterpart of ``scripts/latency_frontier.py``: the fused
yuv420 configs at Poisson mean intervals of 3, 4, 6 and 9 ms (333 to
111 requests/s offered) through :func:`bench_matrix.run_cell`, each row
the cell's line with its offered load, its termination flag (an
infeasible rate that overflowed a queue is a row with its flag, not a
crash) and its job directory (``evidence_logs``). Where the reference
draws ``frontier.png``, the port writes a markdown table (no
matplotlib); outputs go under ``logs/frontier`` (``FRONTIER.json``,
``FRONTIER.md``, ``jobs/``), never over the repo root's
``FRONTIER.json`` and ``frontier.png``::

    python3 -m rnb_tpu_torch.tools.latency_frontier [--only GLOB ...]

``--only`` keeps the cells named ``<config stem>@<mi>`` that match a
glob (``rnb-fused-yuv-mid@[49]``). Env: ``RNB_FRONTIER_VIDEOS`` (default
3000), ``RNB_FRONTIER_OUT``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List

from rnb_tpu_torch.tools.bench_matrix import (REPO, cell_name, run_cells,
                                              selected)

CONFIGS = ("configs/rnb-fused-yuv.json",
           "configs/rnb-fused-yuv-mid.json",
           "configs/rnb-fused-yuv-big.json")
#: mean intervals (ms): 3 ms offers 333 requests/s, 9 ms 111
INTERVALS = (3, 4, 6, 9)
DEFAULT_OUT = os.path.join(REPO, "logs", "frontier")


def frontier_row(row: Dict[str, object]) -> Dict[str, object]:
    """A cell's row with its offered load and termination flag (0 for a
    line without one, None for a cell that printed none)."""
    mi = row["mean_interval_ms"]
    row["offered_rps"] = round(1000.0 / mi, 3) if mi else None
    row.setdefault("termination_flag",
                   0 if "error" not in row else None)
    return row


def table_lines(rows: List[Dict[str, object]]) -> List[str]:
    cols = ["config", "mi_ms", "offered req/s", "videos/s", "p50 ms",
            "p99 ms", "termination", "evidence_logs"]
    lines = ["# Latency frontier (PyTorch/CUDA port)", "",
             "| " + " | ".join(cols) + " |", "|" + "---|" * len(cols)]
    for row in sorted(rows, key=lambda r: (r["config"],
                                           -r["mean_interval_ms"])):
        lines.append("| " + " | ".join(str(v) for v in (
            row["config"], row["mean_interval_ms"], row.get("offered_rps"),
            row.get("value"), row.get("p50_ms"), row.get("p99_ms"),
            row.get("termination_flag"),
            row.get("evidence_logs") or row.get("error", "-"))) + " |")
    lines += ["", "Generated by `python3 -m "
              "rnb_tpu_torch.tools.latency_frontier` (one fresh "
              "bench_cuda.py process per cell); full rows in FRONTIER.json."]
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="The port's Poisson latency frontier, one "
                    "bench_cuda.py process per cell")
    parser.add_argument("--only", action="append", default=None,
                        metavar="GLOB",
                        help="run only the cells whose name "
                             "(<config stem>@<mi>) matches")
    args = parser.parse_args(argv)
    videos = int(os.environ.get("RNB_FRONTIER_VIDEOS", "3000"))
    out_dir = os.environ.get("RNB_FRONTIER_OUT", DEFAULT_OUT)
    os.makedirs(out_dir, exist_ok=True)
    cells = [(config, mi, {}, videos) for config in CONFIGS
             for mi in INTERVALS
             if selected(cell_name(config, mi), args.only)]
    if not cells:
        print("frontier: no cell matches %s" % args.only, file=sys.stderr)
        return 2
    rows = [frontier_row(row)
            for row in run_cells(cells, out_dir, "frontier")]
    with open(os.path.join(out_dir, "FRONTIER.json"), "w") as f:
        json.dump({"rows": rows, "videos": videos, "only": args.only,
                   "generated": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                              time.gmtime()),
                   "isolation": "one fresh bench_cuda.py process per cell"},
                  f, indent=2)
    with open(os.path.join(out_dir, "FRONTIER.md"), "w") as f:
        f.write("\n".join(table_lines(rows)) + "\n")
    print("frontier: wrote FRONTIER.json and FRONTIER.md under %s" % out_dir,
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
