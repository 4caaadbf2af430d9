"""Benchmark matrix of the port: the one-card configs, bulk and Poisson,
each cell in a fresh ``bench_cuda.py`` process.

The port's counterpart of ``scripts/bench_matrix.py``, over the same
cells (:func:`_cells`) and caps (:data:`SLOW_CONFIGS`,
:data:`SLOW_DATASETS`). Cells never share a process: an earlier cell's
allocator, graphs and threads would skew a later one's numbers. Each
cell gets its own ``RNB_BENCH_LOG_BASE`` and its row names the job
directory it was measured from under ``evidence_logs`` (the reference's
evidence-log convention), so any two rows can be explained with
``python3 -m rnb_tpu_torch.tools.rnb_diff``. A row is ``bench_cuda.py``'s
one JSON line with ``bench_rc``, ``cell_wall_s`` and ``evidence_logs``
added; a cell that prints no line, or a line that does not parse, costs
only its own row. Once a cell reports that no CUDA device is available
the remaining cells are skipped, as the reference stops when its backend
is down.

Outputs (never the repo root: the JAX package's committed
``BENCH_MATRIX.json`` and ``MATRIX.md`` stay as they are):
``<out>/BENCH_MATRIX.json`` (rows and run metadata), ``<out>/MATRIX.md``
(the table) and ``<out>/jobs/<cell>/<job>`` (the job directories)::

    python3 -m rnb_tpu_torch.tools.bench_matrix [--only GLOB ...]

``--only`` (repeatable) keeps the cells whose name matches a glob; a
cell's name is ``<config stem>@<mean interval ms>``, with ``+<dataset>``
where the cell serves another dataset (``rnb-fused-yuv-big@0``,
``rnb-fused-yuv-big@6``, ``rnb-fused-yuv-big@0+mjpeg``). Env:
``RNB_MATRIX_VIDEOS`` (default 4000; a Poisson cell serves
max(200, half of it)), ``RNB_MATRIX_MI`` (the Poisson cells' mean
interval, default 6 ms), ``RNB_MATRIX_OUT`` (default ``logs/matrix``
under the checkout); ``RNB_TPU_DATA_ROOT`` and ``RNB_BENCH_PLATFORM``
reach every cell.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(REPO, "bench_cuda.py")
DEFAULT_OUT = os.path.join(REPO, "logs", "matrix")
#: the error a cell reports when the card is not there
NO_DEVICE = "no CUDA device"


def _cells(poisson_mi: int):
    """(config, mean_interval_ms, extra_env) cells, 0 meaning bulk: the
    reference's, every one a config that serves on one card as shipped."""
    return [
        ("configs/r2p1d-whole.json", 0, {}),
        ("configs/r2p1d-whole.json", poisson_mi, {}),
        ("configs/r2p1d-whole-yuv.json", 0, {}),
        ("configs/rnb-1chip.json", 0, {}),
        ("configs/rnb-1chip.json", poisson_mi, {}),
        ("configs/rnb-1chip-yuv.json", 0, {}),
        ("configs/rnb-fused-yuv.json", 0, {}),
        ("configs/rnb-fused-yuv.json", poisson_mi, {}),
        # the fused-dispatch cap sweep: -mid the latency point, -big the
        # bulk headline
        ("configs/rnb-fused-yuv-mid.json", 0, {}),
        ("configs/rnb-fused-yuv-mid.json", poisson_mi, {}),
        ("configs/rnb-fused-yuv-big.json", 0, {}),
        ("configs/rnb-fused-yuv-big.json", poisson_mi, {}),
        # compressed decode in the measured loop (the native MJPEG pool)
        ("configs/rnb-fused-yuv-big.json", 0,
         {"RNB_BENCH_DATASET": "mjpeg"}),
        # the network of a converted checkpoint (factored shortcuts)
        ("configs/rnb-fused-yuv-big-torchckpt.json", 0, {}),
        ("configs/r2p1d-nopipeline-1chip.json", 0, {}),
        ("configs/r2p1d-split-1chip.json", 0, {}),
    ]


#: cells capped below the matrix's count: the unpipelined single stage
#: serializes decode and compute a request, the mjpeg cell decodes every
#: frame on the host (the reference's caps)
SLOW_CONFIGS = {"configs/r2p1d-nopipeline-1chip.json": 300}
SLOW_DATASETS = {"mjpeg": 2000}


def cell_name(config: str, mi: int, extra_env: Optional[dict] = None
              ) -> str:
    """``<config stem>@<mi>``, ``+<dataset>`` where the cell sets one."""
    name = "%s@%d" % (os.path.basename(config)[:-len(".json")], mi)
    dataset = (extra_env or {}).get("RNB_BENCH_DATASET")
    return name + ("+" + dataset if dataset else "")


def selected(name: str, only: Optional[List[str]]) -> bool:
    return not only or any(fnmatch.fnmatchcase(name, g) for g in only)


def _evidence(log_base: str) -> Optional[str]:
    """The one job directory a cell's process wrote under its log base,
    repo-relative where it lies in the checkout."""
    jobs = ([os.path.join(log_base, name) for name in sorted(
        os.listdir(log_base)) if os.path.isfile(
            os.path.join(log_base, name, "log-meta.txt"))]
        if os.path.isdir(log_base) else [])
    if len(jobs) != 1:
        return None
    path = os.path.abspath(jobs[0])
    rel = os.path.relpath(path, REPO)
    return path if rel.startswith("..") else rel


def run_cell(config: str, mi: int, videos: int, extra_env=None,
             log_base: Optional[str] = None) -> Dict[str, object]:
    """One fresh ``bench_cuda.py`` process over ``config`` at mean
    interval ``mi`` (0: bulk), logging under ``log_base``; -> its line as
    a dict with ``bench_rc`` and ``evidence_logs``, or a row with only an
    ``error`` where the process printed nothing that parses."""
    env = dict(os.environ)
    env.update({"RNB_BENCH_CONFIG": os.path.join(REPO, config),
                "RNB_BENCH_MEAN_INTERVAL_MS": str(mi),
                "RNB_BENCH_VIDEOS": str(videos)})
    if log_base is not None:
        os.makedirs(log_base, exist_ok=True)
        env["RNB_BENCH_LOG_BASE"] = os.path.abspath(log_base)
    env.update(extra_env or {})
    proc = subprocess.run([sys.executable, BENCH], capture_output=True,
                          text=True, env=env, cwd=REPO)
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if not lines:
        return {"error": "bench_cuda.py produced no output (rc=%d): %s"
                % (proc.returncode, proc.stderr[-300:])}
    try:
        row = json.loads(lines[-1])
    except ValueError:
        # a stray line costs this cell, not the matrix
        return {"error": "unparseable bench_cuda.py output (rc=%d): %r"
                % (proc.returncode, lines[-1][:200])}
    if not isinstance(row, dict):
        return {"error": "bench_cuda.py printed %r, not an object"
                % lines[-1][:200]}
    row["bench_rc"] = proc.returncode
    if log_base is not None:
        row["evidence_logs"] = _evidence(log_base)
    return row


def run_cells(cells, out_dir: str, tag: str) -> List[Dict[str, object]]:
    """Run ``cells`` ((config, mi, extra_env, videos)) one process each,
    in order, each under ``<out_dir>/jobs/<nn>-<name>``; the cells after
    one that found no CUDA device are rows that say so."""
    rows = []
    backend_down = False
    for idx, (config, mi, extra_env, videos) in enumerate(cells):
        name = cell_name(config, mi, extra_env)
        if backend_down:
            rows.append({"config": config, "mean_interval_ms": mi,
                         "num_videos": videos, "cell": name,
                         "error": "skipped: backend unavailable in an "
                                  "earlier cell"})
            continue
        print("%s: %s videos=%d ..." % (tag, name, videos), file=sys.stderr)
        t0 = time.time()
        log_base = os.path.join(out_dir, "jobs", "%02d-%s" % (
            idx, name.replace("@", "-mi").replace("+", "-")))
        row = run_cell(config, mi, videos, extra_env, log_base=log_base)
        row.setdefault("config", config)
        row.setdefault("mean_interval_ms", mi)
        row.setdefault("num_videos", videos)
        row["cell"] = name
        row["cell_wall_s"] = round(time.time() - t0, 1)
        rows.append(row)
        print("%s:   -> %s" % (tag, json.dumps(row)), file=sys.stderr)
        if NO_DEVICE in str(row.get("error", "")):
            backend_down = True
    return rows


def plan(videos: int, poisson_mi: int, only=None):
    """The matrix's cells as (config, mi, extra_env, videos): a Poisson
    cell serves max(200, videos // 2), the slow cells their caps."""
    cells = []
    for config, mi, extra_env in _cells(poisson_mi):
        if not selected(cell_name(config, mi, extra_env), only):
            continue
        n = videos if mi == 0 else max(200, videos // 2)
        n = min(n, SLOW_CONFIGS.get(config, n))
        n = min(n, SLOW_DATASETS.get(extra_env.get("RNB_BENCH_DATASET", ""),
                                     n))
        cells.append((config, mi, extra_env, n))
    return cells


def table_lines(rows: List[Dict[str, object]]) -> List[str]:
    """MATRIX.md: bulk rows report drain time (a request enqueued at t0
    in an all-at-once backlog), Poisson rows latency under load, each in
    its own column."""
    cols = ["config", "mi_ms", "videos", "videos/s", "poisson p50/p99 ms",
            "bulk drain p50/p99 s", "decode", "clips/s", "tflops", "mfu",
            "vs_baseline", "latency", "evidence_logs"]
    default_backend = next((r["decode_backend"] for r in rows
                            if "decode_backend" in r), "?")
    first = rows[0] if rows else {}
    lines = ["# Benchmark matrix (PyTorch/CUDA port)", "",
             "decode_backend: `%s`  platform: `%s`  device: `%s`" % (
                 default_backend, first.get("platform", "?"),
                 first.get("device_kind", "?")), "",
             "| " + " | ".join(cols) + " |", "|" + "---|" * len(cols)]
    for row in rows:
        mi = row.get("mean_interval_ms", 0)
        p50, p99 = row.get("p50_ms"), row.get("p99_ms")
        have = p50 is not None and p99 is not None and "error" not in row
        if mi and have:
            poisson, drain = "%.1f / %.1f" % (p50, p99), "—"
        elif have:
            poisson, drain = "—", "%.1f / %.1f" % (p50 / 1e3, p99 / 1e3)
        else:
            poisson = drain = "-"
        backend = row.get("decode_backend", "-")
        cells = [str(row.get("config", "-")), str(mi),
                 str(row.get("num_videos", "-")), str(row.get("value", "-")),
                 poisson, drain,
                 "=" if backend == default_backend else backend,
                 str(row.get("clips_per_sec", "-")),
                 str(row.get("tflops", "-")), str(row.get("mfu", "-")),
                 str(row.get("vs_baseline", "-")),
                 str(row.get("latency_semantics", "-")),
                 str(row.get("evidence_logs") or row.get("error", "-"))]
        lines.append("| " + " | ".join(cells) + " |")
    lines += ["", "Generated by `python3 -m rnb_tpu_torch.tools.bench_matrix` "
              "(one fresh bench_cuda.py process per cell); full rows in "
              "BENCH_MATRIX.json. Bulk 'drain' is the completion time of a "
              "request enqueued at t0 in an all-at-once backlog: comparable "
              "across bulk rows, not to Poisson latency."]
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="The port's benchmark matrix, one bench_cuda.py "
                    "process per cell")
    parser.add_argument("--only", action="append", default=None,
                        metavar="GLOB",
                        help="run only the cells whose name "
                             "(<config stem>@<mi>[+<dataset>]) matches")
    args = parser.parse_args(argv)
    videos = int(os.environ.get("RNB_MATRIX_VIDEOS", "4000"))
    poisson_mi = int(os.environ.get("RNB_MATRIX_MI", "6"))
    out_dir = os.environ.get("RNB_MATRIX_OUT", DEFAULT_OUT)
    os.makedirs(out_dir, exist_ok=True)
    cells = plan(videos, poisson_mi, args.only)
    if not cells:
        print("matrix: no cell matches %s" % args.only, file=sys.stderr)
        return 2
    rows = run_cells(cells, out_dir, "matrix")
    with open(os.path.join(out_dir, "BENCH_MATRIX.json"), "w") as f:
        json.dump({"rows": rows, "videos": videos, "poisson_mi": poisson_mi,
                   "only": args.only,
                   "isolation": "one fresh bench_cuda.py process per cell"},
                  f, indent=2)
    with open(os.path.join(out_dir, "MATRIX.md"), "w") as f:
        f.write("\n".join(table_lines(rows)) + "\n")
    print("matrix: wrote BENCH_MATRIX.json and MATRIX.md under %s" % out_dir,
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
