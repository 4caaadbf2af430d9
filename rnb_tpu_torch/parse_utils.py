"""Read a benchmark job's logs back into the numbers ``PERF.md`` keeps.

The port's counterpart of ``scripts/parse_utils.py``, for the files the
port's ``benchmark.py`` writes into ``logs/<job>/``: ``log-meta.txt``,
one timing table per final-step instance and, for a ``--profile`` run
on the card, ``profile.json``::

    python -m rnb_tpu_torch.parse_utils logs/<job> [logs/<job> ...]
    python -m rnb_tpu_torch.parse_utils --attribute logs/<job> [...]
    python -m rnb_tpu_torch.parse_utils --explain [--check] logs/<job> [...]
    python -m rnb_tpu_torch.parse_utils --stamps

prints one JSON object per job: requests, videos/s and clips/s over
the measured window, emissions (fused batches) and the mean runner
service per emission and wait before it, from the timing tables; the
clip cache's hit rate and the page allocator's feature hits and
gathers, from ``Cache:`` and ``Pages:``; and from the profile, device
kernel time and launches, kernel time per forward of the last network
step (its ``Graphs:`` replays) and per request, the card's busy share
and each kernel family's share of the kernel time.

It reads the ``Compiles:`` and ``Warmup:`` lines as the reference's
reader does (``compile_signatures``, ``warmup_s``) and the port's
``Graphs:`` line (captured forwards and their replays per step).

Timing tables of a segmented topology hold merged cards: a stamp
recorded after the fork appears once per segment with a ``-{sub_id}``
suffix (``inference1_start-2``), and a request's end-to-end latency runs
from ``enqueue_filename`` to the aggregator's unsuffixed
``inference{last}_finish``. The reader strips the suffixes to find the
steps, and counts each segment's forward as its own emission.

``--attribute`` prints, per job, each phase's mean, p99 and count over
the requests past the first ten (:func:`rnb_tpu_torch.trace.attribute_phases`
of every table row, as the reference's ``--attribute`` does) and the
largest gap between a request's phase sum and its end-to-end latency.

It also checks the reference's footings (``scripts/parse_utils.py
--check``): of the ``Pages:`` line, pages allocated == freed + live at
teardown, feature hits <= feature lookups, and gathered rows <= the
ragged cache-hit rows they serve; of the ``Compiles:`` line, no step
saw a new signature inside the measured window (``steady_new``); of the
``Trace:`` line, that ``trace.json`` exists, records the same event and
drop counts, and passes :func:`rnb_tpu_torch.trace.validate_trace`. Of
the live-metrics plane (``Metrics:``, ``Slo:``): ``metrics.jsonl`` holds
as many snapshots as the line says, with increasing ``seq``, counters
monotone from snapshot to snapshot and each histogram's buckets summing
to its count; the final snapshot's counters equal the ``Staging:``,
``Cache:``, ``Pages:`` and ``Slo:`` ledgers; every ``flight-<n>.json``
passes ``validate_trace`` and names its trigger, and ``metrics.prom``
exists. Of critpath (``Critpath:``, the ``# critpath`` trailer): every
row's blocking chain sums to its end-to-end latency within 1 ms, and the
line and the trailers re-derive from the tables. Of ``Autotune:``:
verdicts sum to the decisions, emissions are covered by decisions and
sum over the buckets, the held deadlines' min/max/sum agree, every
bucket is one the config warms and, where only fusing loaders are
controlled, the emissions equal the loaders' staged and copied batches.
Of the fault ledger (``Faults:``, ``Failure reasons:``, ``Shed
sites:``, ``Deadline:``, ``Deadline sites:``, ``failed-requests.txt``):
on a run that reached its target, completed + failed + shed equals the
requests of a bulk run (and reaches the target of an open-loop one);
``Failure reasons:`` sums to ``num_failed`` and ``Shed sites:`` to
``num_shed``; ``Deadline sites:`` sums to ``expired`` and equals the
``:deadline_expired`` entries of ``Shed sites:``; ``failed-requests.txt``
holds one distinct request per dead letter with the same reasons; the
tables' ``# faults`` trailers stay within the job's counts; and the final
metrics snapshot's ``faults.*`` and ``deadline.expired`` counters equal
the lines. Of the device observability plane (``Compute:``, ``Compute
stages:``, ``Memory:``, ``Memory owners:``, ``devobs-capture-<n>.txt``):
each stage's flops equal its rows x flops_per_row and sum to
``flops_total``, ``tflops_milli`` recomputes from the integer fields,
``mfu_e4 <= 10000`` and ``mfu_busy <= 1`` where a peak exists, the owner
rows sum to the total with peak >= final, a watermark hit means a
watermark the peak reached, ``live_bytes > 0`` means ``reconciled=1``,
and the capture files match ``captures=`` and each stays within its
``ops_written`` bound. Of intra-stage sharding (``Shard:``, ``Shard
steps:``): the totals foot the per-step detail, every degree is at least
1, no running stage projects over its budget, each declared ring fits
the step's listed devices and runs the config's degree, and the traced
``exec{i}.collective`` spans nest inside step i's ``model_call`` spans.
Of the explanation and operator planes (``Whatif:``, ``Operator:``,
``Stacks:``; the reference's ``_check_whatif`` and ``_check_operator``):
``Whatif:`` needs a ``Metrics:`` line, an uncalibrated model predicts
nothing, and a calibrated one recomputes from ``metrics.jsonl`` and the
job's config copy (stages, calibration and bottleneck exactly,
``pred_vps_milli`` within 1); the ``Operator:`` ledger and
``operator.json`` (a bound port, a host) come together or not at all,
and so do ``Stacks:`` and ``stacks.folded``, whose counts re-sum to
``total`` over as many stacks and roles as the line says, with the
sampler's ticks within tolerance of ``sample_hz`` x the window.
Of the network edge (``Net:``, ``Net errors:``, ``Health:``, ``Health
lanes:``; the reference's ``_check_netedge`` and ``_check_health``):
``frames_sent == frames_acked + resent_pending``, the error classes sum
to ``total``, ``dedup_drops == dup_arrivals``, ``remote <= frames_sent``,
no window strand on a run that reached its target; every lane's path a
legal walk ending in its state, the ``Health:`` counters re-derived from
the paths, ``routes_after_open`` 0, and work moved only off an evicted
lane (the same for the replica lanes' boards). Of the replica lanes
(``Handoff:``, ``Handoff edges:``, ``Hedge:``, ``Placement:``; the
reference's ``_check_handoff``, ``_check_hedge`` and
``_check_placement``): every edge take one class and the per-edge detail
summed to the totals, no host bytes where the job's config copy declares
``handoff.mode`` "device"; hedges won + lost == fired; every planned
step at least one replica and, on a complete trace, each step's
predicted occupancy within max(25%, 0.05) of its traced ``model_call`` +
``device_sync`` busy fraction. Of the lock-order witness (``Locks:``,
``Lock edges:``; the reference's ``_check_locks``): the two lines come
together, the counts foot against the detail, no edge without an
acquisition or a witnessed lock behind it, no violation, and every
observed edge in the static lock-order graph of the port's rnb-lint
(:mod:`rnb_tpu_torch.analysis.concurrency`). :func:`check_job` returns
every violation of one job.
Beyond those planes it holds every other invariant of the reference's
``check_job_detail``: ``Termination flag:`` and the window's two stamps
present; every timing table parses, and names only stamps this reader
knows (:data:`TABLE_STAMPS`); the ``# cache`` and ``# padding``
trailers within the ``Cache:`` and ``Padding:`` lines, the cache's
inserts within its misses, the staging pools' waits within their
acquires, the pager's limbo within its live pages, feature inserts equal
to entries plus evictions and feature gathers within feature hits, pads
within shipped rows, a ragged pool's valid rows within emissions x pool
rows and no pad row on a fully ragged run, no negative counter; and the
phase attribution (the reference's ``_check_phases``): every row's
phases partition its end-to-end span, and the ``# phases`` trailers and
the ``Phases:`` line re-derive from the tables.
:func:`check_job_detail` returns ``(problems, parse_failed)``.

``--explain`` prints the reference's explanation of each job: the ranked
blocked time per (class, step), each stage's critical-path bound and the
stage that caps, and the calibrated what-if counterfactuals where the
job streamed metrics (:func:`print_explanation`; 1 where nothing
decomposes or a chain misses its request's latency by over 1 ms, and
without ``--check`` no check runs, as in the reference). ``--stamps``
prints the port's telemetry registries in the reference's layout.

For the offline tools (``tools/rnb_diff.py``, ``tools/latency_summary.py``)
it also reads any job directory, the JAX package's too, as the
reference's pandas reader does, without pandas: :func:`parse_meta` (the
reference's flat dict, either package's ``Args:`` line under the
reference's names), :func:`get_data` and :func:`get_data_from_all_logs`
(request frames: dicts of numpy columns), :func:`decompose_latency`,
:func:`dispatch_batch_sizes`, :func:`attribute_job` and
:func:`table_phase_samples`.

A violation is printed and the exit code is 1; a job the reader cannot
read (log-meta or a timing table) exits 2 (``--check`` is accepted and,
but beside ``--explain``, changes nothing: the checks always run).
"""

from __future__ import annotations

import json
import os
import re
import sys
from typing import Dict, List, Tuple

import numpy as np

from rnb_tpu_torch import critpath
from rnb_tpu_torch import whatif as whatif_mod
from rnb_tpu_torch.stacksampler import DEFAULT_SAMPLE_HZ
from rnb_tpu_torch.memledger import MEM_OWNERS
from rnb_tpu_torch.trace import (_step_of, _strip_suffix, attribute_phases,
                                 phase_stats, validate_trace)

#: warm records a job-wide summary skips per table (runner.py)
NUM_SUMMARY_SKIPS = 10
#: the dead-letter detail cap (rnb_tpu_torch.control.FaultStats)
MAX_DEAD_LETTERS = 1000

#: the fault ledger's JSON lines, by the meta key each is read into
JSON_LINES = {"Failure reasons": "failure_reasons",
              "Shed sites": "shed_sites",
              "Queue overflows": "queue_overflows",
              "Deadline sites": "deadline_sites",
              "Shard steps": "shard_step_detail",
              "Health lanes": "health_lane_detail",
              "Handoff edges": "handoff_edge_detail",
              "Placement": "placement",
              "Lock edges": "lock_edge_detail"}
#: ``<device-label>-group<g>-<i>.txt`` (telemetry.logname)
TABLE_NAME = re.compile(r"^(?P<device>.+)-group(?P<group>\d+)-"
                        r"(?P<instance>\d+)\.txt$")
#: the suffix of every deadline shed site (rnb_tpu_torch.health)
DEADLINE_SUFFIX = ":deadline_expired"

#: kernel families of a profile, by a substring of the kernel's name;
#: the first family that matches takes the kernel
KERNEL_FAMILIES = (
    ("ingest", ("normalize_u8_kernel", "ragged_normalize_u8_kernel",
                "yuv420_kernel", "dct_unpack_kernel",
                "dct_convert_kernel", "dct_ingest_kernel")),
    ("gather", ("gather_rows_kernel",)),
    ("conv_f32", ("f32f32",)),
    ("conv", ("fprop", "conv")),
    ("elementwise", ("elementwise_kernel",)),
    ("layout", ("nhwcToNchw", "nchwToNhwc", "AddPadding")),
    ("copy", ("Memcpy", "Memset")),
)


def read_meta(path: str) -> dict:
    """``log-meta.txt`` -> args, the window's two wall-clock stamps, the
    device, the in-window kernel launches, the pixel path and decode
    backend, and the ``Key: k=v ...`` lines."""
    meta: dict = {"lines": {}}
    with open(path) as f:
        for line in f.read().splitlines():
            head, _, rest = line.partition(": ")
            if head == "Args":
                meta["args"] = json.loads(rest)
            elif head == "Kernels":
                meta["launches"] = json.loads(rest)
            elif head == "Pages arenas":
                meta["arenas"] = json.loads(rest)
            elif head == "Compiles":
                meta["compile_signatures"] = json.loads(rest)
            elif head == "Warmup":
                meta["warmup_s"] = json.loads(rest)
            elif head == "Graphs":
                meta["graphs"] = json.loads(rest)
            elif head == "Phases":
                meta["phases"] = json.loads(rest)
            elif head == "Autotune buckets":
                meta["autotune_buckets"] = json.loads(rest)
            elif head == "Critpath stages":
                meta["critpath_stages"] = json.loads(rest)
            elif head == "Compute stages":
                meta["compute_stage_detail"] = json.loads(rest)
            elif head == "Memory owners":
                meta["memory_owner_detail"] = json.loads(rest)
            elif head in JSON_LINES:
                meta[JSON_LINES[head]] = json.loads(rest)
            elif head == "Device":
                meta["device"] = json.loads(rest)
            elif head == "Termination flag":
                meta["termination_flag"] = int(rest)
            elif head in ("Pixel path", "Decode backend"):
                meta[head.lower().replace(" ", "_")] = rest
            elif rest and "=" in rest:
                meta["lines"][head] = {
                    k: float(v) for k, v in
                    (kv.split("=", 1) for kv in rest.split())}
                if head == "Staging":
                    # one line per loader: the footings sum them
                    meta.setdefault("staging", []).append(
                        {k: int(v) for k, v in meta["lines"][head].items()})
            elif not rest and len(line.split()) == 2:
                meta["window"] = tuple(float(t) for t in line.split())
    return meta


def read_table(path: str):
    """One timing table -> (event keys, rows of stamps per request); an
    instance that completed nothing (every request shed) has neither."""
    with open(path) as f:
        lines = [ln.split() for ln in f.read().splitlines()
                 if ln.strip() and not ln.startswith("#")]
    if not lines:
        return [], []
    keys = [k for k in lines[0] if not k.startswith("device")]
    rows = [[float(v) for v in ln[:len(keys)]] for ln in lines[1:]]
    return keys, rows


def read_trailers(path: str) -> Dict[str, Dict[str, int]]:
    """A timing table's ``# <kind> k=v ...`` trailers, by kind."""
    trailers: Dict[str, Dict[str, int]] = {}
    with open(path) as f:
        for line in f:
            tokens = line[1:].split() if line.startswith("#") else ()
            if tokens:
                trailers[tokens[0]] = {
                    k: int(v) for k, _, v in (t.partition("=")
                                              for t in tokens[1:])}
    return trailers


def load_metrics(log_dir: str) -> List[dict]:
    """A job's ``metrics.jsonl`` snapshots (empty without the file)."""
    path = os.path.join(log_dir, "metrics.jsonl")
    if not os.path.isfile(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _flight_dumps(log_dir: str) -> List[str]:
    return sorted(name for name in os.listdir(log_dir)
                  if name.startswith("flight-") and name.endswith(".json")
                  and name[7:-5].isdigit())


def _staging_totals(meta: dict) -> Dict[str, int]:
    totals: Dict[str, int] = {}
    for line in meta.get("staging", ()):
        for key, value in line.items():
            totals[key] = totals.get(key, 0) + value
    return totals


#: (final-snapshot counter, log-meta line, key) the final snapshot must
#: equal wherever the line is present
METRICS_FOOTING = (
    tuple(("staging." + k, "Staging", k) for k in (
        "acquires", "acquire_waits", "staged_batches", "copied_batches"))
    + tuple(("cache." + k, "Cache", k) for k in (
        "hits", "misses", "inserts", "evictions", "coalesced", "oversize"))
    + tuple(("pages." + k, "Pages", k) for k in (
        "allocs", "frees", "alloc_fails", "gathers", "gather_rows",
        "feature_lookups", "feature_hits", "feature_inserts",
        "feature_evictions", "feature_gathers", "feature_gather_rows",
        "feature_bytes_saved"))
    + tuple(("slo." + k, "Slo", k) for k in (
        "tracked", "within", "missed"))
    + tuple(("faults." + k, "Faults", k) for k in (
        "num_failed", "num_shed", "num_retries"))
    + (("deadline.expired", "Deadline", "expired"),))


def metrics_problems(log_dir: str, meta: dict) -> List[str]:
    """The live-metrics plane's invariants (the reference's --check)."""
    lines = meta["lines"]
    flights = _flight_dumps(log_dir)
    if "Metrics" not in lines:
        return (["metrics.jsonl present but log-meta has no 'Metrics:' "
                 "line"] if os.path.isfile(os.path.join(
                     log_dir, "metrics.jsonl")) else []) + (
            ["flight dump(s) %s but no 'Metrics:' line" % flights]
            if flights else [])
    problems = []
    snapshots = load_metrics(log_dir)
    if len(snapshots) != lines["Metrics"]["snapshots"]:
        problems.append("'Metrics:' line says snapshots=%d but "
                        "metrics.jsonl holds %d"
                        % (lines["Metrics"]["snapshots"], len(snapshots)))
    if "Slo" not in lines:
        problems.append("a 'Metrics:' line without its 'Slo:' line")
    last_seq, previous = 0, {}
    for idx, snap in enumerate(snapshots):
        if snap["seq"] <= last_seq:
            problems.append("snapshot %d: seq %d not increasing"
                            % (idx, snap["seq"]))
        last_seq = snap["seq"]
        for name, value in snap["counters"].items():
            if value < previous.get(name, 0):
                problems.append("snapshot %d: counter %r fell %s -> %s"
                                % (idx, name, previous[name], value))
        previous = snap["counters"]
        for name, hist in snap["histograms"].items():
            if sum(hist["buckets"]) != hist["count"]:
                problems.append("snapshot %d: histogram %r buckets sum to "
                                "%d, count %d" % (idx, name,
                                                  sum(hist["buckets"]),
                                                  hist["count"]))
    final = snapshots[-1]["counters"] if snapshots else {}
    staging = _staging_totals(meta)
    for counter, line, key in METRICS_FOOTING:
        want = (staging.get(key) if line == "Staging"
                else lines.get(line, {}).get(key))
        if want is not None and final.get(counter) != want:
            problems.append("final snapshot %s=%s does not foot %s: %s=%d"
                            % (counter, final.get(counter), line, key, want))
    slo = lines.get("Slo", {})
    if slo and slo["within"] + slo["missed"] != slo["tracked"]:
        problems.append("Slo: within + missed != tracked")
    if len(flights) != lines["Metrics"]["dumps"]:
        problems.append("'Metrics:' line says dumps=%d but the job holds "
                        "%s" % (lines["Metrics"]["dumps"], flights))
    if lines["Metrics"]["dumps"] > lines["Metrics"]["triggers"]:
        problems.append("more flight dumps than triggers")
    for name in flights:
        path = os.path.join(log_dir, name)
        problems.extend("%s: %s" % (name, issue)
                        for issue in validate_trace(path)[:3])
        with open(path) as f:
            if not json.load(f).get("otherData", {}).get("flight_trigger"):
                problems.append("%s names no flight_trigger" % name)
    if not os.path.isfile(os.path.join(log_dir, "metrics.prom")):
        problems.append("a metrics run wrote no metrics.prom")
    return problems


def critpath_problems(log_dir: str, meta: dict,
                      num_skips: int = NUM_SUMMARY_SKIPS) -> List[str]:
    """Every row's blocking chain partitions its end-to-end span (1 ms),
    and the ``Critpath:`` line and ``# critpath`` trailers re-derive
    from the tables (the reference's --check)."""
    problems, steady, trailers = [], [], 0
    for path in timing_tables(log_dir):
        keys, rows = read_table(path)
        name = os.path.basename(path)
        for row in rows:
            chain = critpath.blocking_chain(dict(zip(keys, row)))
            e2e = 1e3 * (max(row) - min(row))
            if abs(sum(ms for _c, _s, ms in chain) - e2e) > 1.0:
                problems.append("%s: a blocking chain does not sum to its "
                                "end-to-end latency" % name)
                break
        tail = [dict(zip(keys, row)) for row in rows[num_skips:]]
        steady.extend(tail)
        trailer = read_trailers(path).get("critpath")
        if trailer is None:
            continue
        trailers += 1
        n, totals = critpath.trailer_totals(tail)
        if trailer.get("n") != n:
            problems.append("%s: '# critpath' n=%s, the table gives %d"
                            % (name, trailer.get("n"), n))
        for key, want in sorted(totals.items()):
            got = trailer.get(key + "_us")
            if got is None or abs(got - want) > 1000:
                problems.append("%s: '# critpath' %s_us=%s, the table "
                                "gives %d" % (name, key, got, want))
    line = meta["lines"].get("Critpath")
    if line is None:
        return problems + (["'# critpath' trailers without a 'Critpath:' "
                            "line"] if trailers else [])
    if not trailers:
        problems.append("a 'Critpath:' line but no '# critpath' trailer")
    if line["residual_us_max"] > 1000:
        problems.append("Critpath: residual_us_max=%d over 1000"
                        % line["residual_us_max"])
    report = critpath.aggregate(((t, False, 0) for t in steady),
                                _config_lanes(meta))
    for key in ("requests", "segments", "bound_step"):
        if report is None or line[key] != report[key]:
            problems.append("Critpath: %s=%d, the tables give %s" % (
                key, line[key], None if report is None else report[key]))
    return problems


def _config(meta: dict):
    """The job's config as its Args line names it, or None."""
    path = meta.get("args", {}).get("config")
    if not path or not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def _config_lanes(meta: dict) -> Dict[int, int]:
    raw = _config(meta)
    if raw is None:
        return {}
    return {idx: sum(len(g.get("devices", ())) for g in step["queue_groups"])
            for idx, step in enumerate(raw["pipeline"])}


def autotune_problems(meta: dict) -> List[str]:
    """The ``Autotune:`` line's invariants (the reference's --check), and
    its emissions against the loaders' where only loaders are
    controlled."""
    line = meta["lines"].get("Autotune")
    if line is None:
        return []
    problems = []
    held, decisions = line["held"], line["decisions"]
    if line["immediate"] + held != decisions:
        problems.append("Autotune: immediate + held != decisions")
    if line["emissions"] > decisions:
        problems.append("Autotune: emissions exceed decisions")
    buckets = meta.get("autotune_buckets", {})
    if sum(buckets.values()) != line["emissions"]:
        problems.append("Autotune buckets sum to %d, emissions=%d"
                        % (sum(buckets.values()), line["emissions"]))
    d_min, d_max, d_sum = (line["deadline_us_min"], line["deadline_us_max"],
                           line["deadline_us_sum"])
    if held and not (d_min <= d_max and held * d_min <= d_sum
                     <= held * d_max):
        problems.append("Autotune: held deadlines min/max/sum disagree")
    if not held and d_sum:
        problems.append("Autotune: deadline_us_sum without a held decision")
    raw = _config(meta)
    if raw is None:
        return problems
    if "Ragged" in meta["lines"]:
        pool = meta["lines"]["Ragged"]["pool_rows"]
        rogue = [b for b in buckets if int(b) > pool]
    else:
        warmed = set((raw.get("autotune") or {}).get("buckets") or ())
        for step in raw["pipeline"]:
            for scope in [step] + step["queue_groups"]:
                warmed.update(scope.get("row_buckets") or ())
                warmed.update(scope[k] for k in ("max_clips", "max_rows")
                              if k in scope)
        rogue = [b for b in buckets if warmed and int(b) not in warmed]
    if rogue:
        problems.append("Autotune chose row bucket(s) %s the config never "
                        "warms" % sorted(rogue))
    controlled = {step["model"].rpartition(".")[2]
                  for step in raw["pipeline"] if step.get("autotune", True)
                  and step["model"].rpartition(".")[2] in (
                      "R2P1DFusingLoader", "Batcher")}
    staging = _staging_totals(meta)
    loader_emissions = (staging.get("staged_batches", 0)
                        + staging.get("copied_batches", 0))
    if controlled == {"R2P1DFusingLoader"} \
            and line["emissions"] != loader_emissions:
        problems.append("Autotune: emissions=%d but the loaders shipped %d"
                        % (line["emissions"], loader_emissions))
    return problems


def _stamp_pairs(keys: List[str], first: str, second: str):
    """``[(first_col, second_col)]``: the columns of two stamps of one
    request, one pair per segment where both carry the same sub_id
    suffix, and, where ``second`` is recorded once after the segments
    merged, each segment's ``first`` paired with it."""
    col = {k: i for i, k in enumerate(keys)}
    if first in col and second in col:
        return [(col[first], col[second])]
    subs = sorted(k[len(first) + 1:] for k in keys
                  if k.startswith(first + "-")
                  and k[len(first) + 1:].isdigit())
    if second in col:
        return [(col["%s-%s" % (first, sub)], col[second]) for sub in subs]
    return [(col["%s-%s" % (first, sub)], col["%s-%s" % (second, sub)])
            for sub in subs if "%s-%s" % (second, sub) in col]


def step_service_ms(keys: List[str], rows) -> Dict[int, List[float]]:
    """{step: [service ms per emission]}: ``inference{i}_finish`` less
    ``inference{i}_start``, one emission per distinct start stamp (a
    fused emission stamps all its requests at once; a segment is its own
    forward). Where the finish is stamped once after a merge, an
    emission is the merged request and its service starts at its last
    segment's start."""
    steps = sorted({s for s in (_step_of(_strip_suffix(k), "inference",
                                         "_start") for k in keys)
                    if s is not None})
    out: Dict[int, List[float]] = {}
    for step in steps:
        pairs = _stamp_pairs(keys, "inference%d_start" % step,
                             "inference%d_finish" % step)
        merged = len({f for _s, f in pairs}) == 1 and len(pairs) > 1
        emissions = {}
        for row in rows:
            if merged:
                begin = max(row[s] for s, _f in pairs)
                emissions[(begin, row[pairs[0][1]])] = None
            else:
                for s, f in pairs:
                    emissions[(row[s], row[f])] = None
        out[step] = [1e3 * (f - b) for b, f in emissions]
    return out


def attribute(log_dir: str, num_skips: int = NUM_SUMMARY_SKIPS) -> dict:
    """Per-request phases of one job over every timing table's rows past
    ``num_skips``: ``{"phases": {phase: {mean_ms, p99_ms, count}},
    "requests": n, "max_residual_ms": x}``, the residual being a
    request's end-to-end latency (first stamp to last) less the sum of
    its phases."""
    samples: Dict[str, List[float]] = {}
    residual, requests = 0.0, 0
    for phases, e2e in _job_phase_rows(log_dir, num_skips):
        residual = max(residual, abs(sum(phases.values()) - e2e))
        requests += 1
        for phase, ms in phases.items():
            samples.setdefault(phase, []).append(ms)
    return {"phases": phase_stats(samples), "requests": requests,
            "max_residual_ms": residual}


def trace_problems(log_dir: str, meta: dict) -> List[str]:
    """The ``Trace:`` line against ``trace.json`` (empty when they
    agree, or when the run was not traced and wrote neither)."""
    path = os.path.join(log_dir, "trace.json")
    line = meta["lines"].get("Trace")
    if line is None:
        return (["trace.json present but log-meta has no 'Trace:' line"]
                if os.path.isfile(path) else [])
    if not os.path.isfile(path):
        return ["log-meta carries a 'Trace:' line but trace.json is "
                "missing"]
    with open(path) as f:
        other = json.load(f).get("otherData", {})
    problems = []
    if other.get("num_events") != line["events"]:
        problems.append("'Trace:' line says events=%d but trace.json "
                        "records num_events=%s"
                        % (line["events"], other.get("num_events")))
    if other.get("dropped_events") != line["dropped"]:
        problems.append("'Trace:' line says dropped=%d but trace.json "
                        "records dropped_events=%s"
                        % (line["dropped"], other.get("dropped_events")))
    problems.extend("trace.json: %s" % issue
                    for issue in validate_trace(path)[:5])
    return problems


def timing_tables(job_dir: str) -> List[str]:
    """The job's timing tables, one per final-step instance
    (``<device>-group<g>-<i>.txt``), sorted."""
    return sorted(os.path.join(job_dir, name)
                  for name in os.listdir(job_dir) if TABLE_NAME.match(name))


def kernel_families(kernels: Dict[str, dict]) -> Dict[str, float]:
    """Share of device kernel time per family of :data:`KERNEL_FAMILIES`
    (``other`` for the rest)."""
    total = sum(k["device_us"] for k in kernels.values()) or 1.0
    shares: Dict[str, float] = {}
    for name, k in kernels.items():
        family = next((fam for fam, marks in KERNEL_FAMILIES
                       if any(m in name for m in marks)), "other")
        shares[family] = shares.get(family, 0.0) + k["device_us"] / total
    return shares


def read_dead_letters(log_dir: str) -> List[tuple]:
    """``failed-requests.txt`` -> ``[(request id, step, reason)]`` (empty
    without the file)."""
    path = os.path.join(log_dir, "failed-requests.txt")
    if not os.path.isfile(path):
        return []
    with open(path) as f:
        rows = [line.split() for line in f.read().splitlines()
                if line and not line.startswith("#")]
    return [(int(rid), int(step), reason) for rid, step, reason in rows]


def fault_problems(log_dir: str, meta: dict) -> List[str]:
    """The fault ledger's invariants (the reference's --check)."""
    lines = meta["lines"]
    problems = []
    faults = lines.get("Faults")
    if faults is None:
        return []  # a log from before the fault ledger
    failed, shed = int(faults["num_failed"]), int(faults["num_shed"])
    reasons = meta.get("failure_reasons", {})
    if sum(reasons.values()) != failed:
        problems.append("'Failure reasons:' sum to %d but num_failed=%d"
                        % (sum(reasons.values()), failed))
    sites = meta.get("shed_sites", {})
    if sum(sites.values()) != shed:
        problems.append("'Shed sites:' sum to %d but num_shed=%d"
                        % (sum(sites.values()), shed))
    completed = 0
    table_faults = {"num_failed": 0, "num_shed": 0}
    for path in timing_tables(log_dir):
        completed += len(read_table(path)[1])
        trailer = read_trailers(path).get("faults", {})
        for key in table_faults:
            table_faults[key] += trailer.get(key, 0)
    for key, total in (("num_failed", failed), ("num_shed", shed)):
        if table_faults[key] > total:
            problems.append("the tables' '# faults' trailers count %s=%d "
                            "but Faults: says %d"
                            % (key, table_faults[key], total))
    args = meta.get("args", {})
    if meta.get("termination_flag") == 0 and "num_videos" in args:
        disposed = completed + failed + shed
        want = args["num_videos"]
        if disposed < want or (args.get("mean_interval_ms") == 0
                               and disposed != want):
            problems.append(
                "completed %d + failed %d + shed %d = %d for a target of "
                "%d requests (%s)" % (completed, failed, shed, disposed,
                                      want, "bulk: every request ends "
                                      "once" if args.get(
                                          "mean_interval_ms") == 0
                                      else "open loop: at least"))
    letters = read_dead_letters(log_dir)
    if len(letters) != min(failed, MAX_DEAD_LETTERS):
        problems.append("failed-requests.txt lists %d dead letter(s) but "
                        "num_failed=%d" % (len(letters), failed))
    if len({rid for rid, _, _ in letters}) != len(letters):
        problems.append("failed-requests.txt lists a request twice")
    if failed <= MAX_DEAD_LETTERS:
        letter_reasons: Dict[str, int] = {}
        for _, _, reason in letters:
            letter_reasons[reason] = letter_reasons.get(reason, 0) + 1
        if letter_reasons != {k: int(v) for k, v in reasons.items()}:
            problems.append("failed-requests.txt reasons %s disagree with "
                            "'Failure reasons:' %s"
                            % (letter_reasons, reasons))
    deadline = lines.get("Deadline")
    deadline_sites = meta.get("deadline_sites")
    if deadline is None:
        if deadline_sites is not None:
            problems.append("a 'Deadline sites:' line without its "
                            "'Deadline:' line")
        return problems
    expired = int(deadline["expired"])
    if deadline["budget_ms"] <= 0:
        problems.append("Deadline: budget_ms=%d must be positive"
                        % deadline["budget_ms"])
    deadline_sites = {k: int(v) for k, v in (deadline_sites or {}).items()}
    if sum(deadline_sites.values()) != expired:
        problems.append("'Deadline sites:' sum to %d but expired=%d"
                        % (sum(deadline_sites.values()), expired))
    shed_deadline = {k: int(v) for k, v in sites.items()
                     if k.endswith(DEADLINE_SUFFIX)}
    if shed_deadline != deadline_sites:
        problems.append("'Deadline sites:' %s disagree with the "
                        "deadline entries of 'Shed sites:' %s"
                        % (deadline_sites, shed_deadline))
    if expired > shed:
        problems.append("Deadline: expired=%d exceeds num_shed=%d"
                        % (expired, shed))
    return problems


def _devobs_captures(log_dir: str) -> List[str]:
    return sorted(name for name in os.listdir(log_dir)
                  if re.fullmatch(r"devobs-capture-\d+\.txt", name))


def _check_capture_artifact(path: str) -> List[str]:
    """One capture file's structure (the reference's rule): the 4-column
    header, an ``ops_written`` bound the data rows honor, and every row
    two integer timestamps (t1 >= t0), a plane and an op name."""
    base = os.path.basename(path)
    problems: List[str] = []
    ops_written = None
    rows = 0
    with open(path) as f:
        first = f.readline()
        if not first.startswith("# t0_ns t1_ns plane op_name"):
            return ["%s: missing the '# t0_ns t1_ns plane op_name' "
                    "header" % base]
        for line in f:
            if line.startswith("#"):
                parts = line.split()
                if "ops_written" in parts:
                    ops_written = int(parts[parts.index("ops_written") + 1])
                continue
            rows += 1
            parts = line.rstrip("\n").split(" ", 3)
            if len(parts) != 4:
                problems.append("%s: malformed data row %r"
                                % (base, line.strip()[:60]))
                break
            try:
                t0, t1 = int(parts[0]), int(parts[1])
            except ValueError:
                problems.append("%s: non-integer timestamps in %r"
                                % (base, line.strip()[:60]))
                break
            if t1 < t0:
                problems.append("%s: interval ends before it starts "
                                "(%d > %d)" % (base, t0, t1))
                break
    if ops_written is None:
        problems.append("%s: missing the ops_total/ops_written bound "
                        "header" % base)
    elif rows != ops_written:
        problems.append("%s: header says ops_written=%d but the file "
                        "holds %d row(s)" % (base, ops_written, rows))
    return problems


def _devobs_meta(meta: dict) -> dict:
    """The devobs lines in the reference reader's flat keys
    (``compute_<k>``, ``memory_<k>``, the two detail objects and
    ``wall_time_s``)."""
    flat: dict = {}
    for head, prefix in (("Compute", "compute_"), ("Memory", "memory_")):
        for key, value in meta["lines"].get(head, {}).items():
            flat[prefix + key] = int(value)
    for key in ("compute_stage_detail", "memory_owner_detail"):
        if key in meta:
            flat[key] = meta[key]
    if "window" in meta:
        flat["wall_time_s"] = meta["window"][1] - meta["window"][0]
    return flat


def devobs_problems(log_dir: str, meta: dict) -> List[str]:
    """The device observability plane's invariants (the reference's
    --check, with its messages). Malformed detail values surface as a
    finding, never as a crash of the checker."""
    try:
        return _devobs_problems(log_dir, _devobs_meta(meta))
    except (ValueError, TypeError, KeyError) as e:
        return ["devobs Compute:/Memory: lines are malformed "
                "(%s: %s) — the detail JSON does not match the "
                "declared schema" % (type(e).__name__, e)]


def _devobs_problems(log_dir: str, meta: dict) -> List[str]:
    problems: List[str] = []
    captures = _devobs_captures(log_dir)
    if "compute_stages" not in meta and "memory_total_bytes" not in meta:
        if captures:
            problems.append("devobs capture artifact(s) %s present "
                            "but log-meta has no 'Compute:'/'Memory:' "
                            "line" % captures)
        return problems
    if "compute_stages" in meta and "memory_total_bytes" not in meta:
        problems.append("log-meta carries a 'Compute:' line but no "
                        "'Memory:' line (the devobs plane writes the "
                        "ledger totals on every enabled run)")
    if "compute_stages" in meta:
        problems.extend(_compute_problems(meta, captures))
    if "memory_total_bytes" in meta:
        problems.extend(_memory_problems(meta))
    for name in captures:
        problems.extend(_check_capture_artifact(os.path.join(log_dir,
                                                             name)))
    return problems


def _compute_problems(meta: dict, captures: List[str]) -> List[str]:
    problems: List[str] = []
    detail = {key: dict(val) for key, val
              in dict(meta.get("compute_stage_detail", {})).items()}
    if len(detail) != meta.get("compute_stages", 0):
        problems.append("'Compute stages:' names %d stage(s) but the "
                        "'Compute:' line says stages=%d"
                        % (len(detail), meta.get("compute_stages", 0)))
    for key in ("compute_dispatches", "compute_rows", "compute_flops_total",
                "compute_window_us", "compute_captures"):
        if meta.get(key, 0) < 0:
            problems.append("negative %s" % key)
    flops_sum = dispatches_sum = 0
    last_step = last_rows = None
    for key, entry in sorted(detail.items()):
        rows = int(entry.get("rows", 0))
        per_row = int(entry.get("flops_per_row", 0))
        flops = int(entry.get("flops", 0))
        if flops != per_row * rows:
            problems.append(
                "'Compute stages:' %s: flops=%d != flops_per_row=%d x "
                "rows=%d (achieved FLOPs are per-row counts times the rows "
                "actually dispatched)" % (key, flops, per_row, rows))
        if min(rows, per_row, int(entry.get("dispatches", 0)),
               int(entry.get("busy_us", 0))) < 0:
            problems.append("'Compute stages:' %s carries a negative "
                            "counter" % key)
        mfu_busy = entry.get("mfu_busy")
        if mfu_busy is not None and float(mfu_busy) > 1.0001:
            problems.append(
                "'Compute stages:' %s: mfu_busy=%s exceeds 1 — a stage "
                "cannot beat the device's peak; the declared FLOPs or the "
                "peak table is wrong" % (key, mfu_busy))
        flops_sum += flops
        dispatches_sum += int(entry.get("dispatches", 0))
        step = int(key[4:])
        if last_step is None or step > last_step:
            last_step, last_rows = step, rows
    if flops_sum != meta.get("compute_flops_total", 0):
        problems.append("'Compute stages:' flops sum to %d but the "
                        "'Compute:' line says flops_total=%d"
                        % (flops_sum, meta.get("compute_flops_total", 0)))
    if dispatches_sum != meta.get("compute_dispatches", 0):
        problems.append("'Compute stages:' dispatches sum to %d but the "
                        "'Compute:' line says dispatches=%d"
                        % (dispatches_sum, meta.get("compute_dispatches", 0)))
    if detail and last_rows != meta.get("compute_rows", 0):
        problems.append(
            "'Compute:' rows=%d but the last flops-bearing stage "
            "dispatched %d row(s) (the job row count is the final stage's "
            "— the completed clips)" % (meta.get("compute_rows", 0),
                                        last_rows))
    if meta.get("compute_mfu_e4", 0) > 10000:
        problems.append("compute_mfu_e4=%d exceeds 10000 (MFU > 1: the job "
                        "cannot beat the device peak)"
                        % meta.get("compute_mfu_e4", 0))
    window_s = meta.get("compute_window_us", 0) / 1e6
    if detail and window_s > 0:
        # rows/s x the summed per-row FLOPs in the writer's expression
        # order and rounding (±1 milli absorbs window_us's rounding)
        flops_per_clip = float(sum(int(entry.get("flops_per_row", 0))
                                   for entry in detail.values()))
        tflops = (meta.get("compute_rows", 0) / window_s) \
            * flops_per_clip / 1e12
        want_milli = int(round(round(tflops, 3) * 1000))
        if abs(int(meta.get("compute_tflops_milli", 0)) - want_milli) > 1:
            problems.append("'Compute:' tflops_milli=%s but rows/window x "
                            "per-row flops recompute to %d"
                            % (meta.get("compute_tflops_milli"), want_milli))
    if "wall_time_s" in meta and abs(
            meta.get("compute_window_us", 0) / 1e6
            - float(meta["wall_time_s"])) > 0.01:
        problems.append(
            "'Compute:' window_us=%d disagrees with the measured wall time "
            "%.6f s (the compute window IS the measured window)"
            % (meta.get("compute_window_us", 0), meta["wall_time_s"]))
    if len(captures) != meta.get("compute_captures", 0):
        problems.append("'Compute:' line says captures=%d but the job dir "
                        "holds %d capture artifact(s): %s"
                        % (meta.get("compute_captures", 0), len(captures),
                           captures))
    return problems


def _memory_problems(meta: dict) -> List[str]:
    problems: List[str] = []
    detail = {key: dict(val) for key, val
              in dict(meta.get("memory_owner_detail", {})).items()}
    if len(detail) != meta.get("memory_owners", 0):
        problems.append("'Memory owners:' names %d owner(s) but the "
                        "'Memory:' line says owners=%d"
                        % (len(detail), meta.get("memory_owners", 0)))
    rogue = sorted(set(detail) - set(MEM_OWNERS))
    if rogue:
        problems.append("'Memory owners:' names undeclared owner(s) %s — "
                        "owners are declared in "
                        "memledger.MEM_OWNER_REGISTRY" % rogue)
    owner_sum = 0
    for owner, entry in sorted(detail.items()):
        nbytes = int(entry.get("bytes", 0))
        peak = int(entry.get("peak_bytes", 0))
        if nbytes < 0 or peak < 0:
            problems.append("'Memory owners:' %s carries negative bytes"
                            % owner)
        if peak < nbytes:
            problems.append(
                "'Memory owners:' %s: peak_bytes=%d below final bytes=%d "
                "(the high-water mark covers every sample, the final one "
                "included)" % (owner, peak, nbytes))
        owner_sum += nbytes
    if owner_sum != meta.get("memory_total_bytes", 0):
        problems.append(
            "'Memory owners:' bytes sum to %d but the 'Memory:' line says "
            "total_bytes=%d (owner rows must foot to the ledger total)"
            % (owner_sum, meta.get("memory_total_bytes", 0)))
    if meta.get("memory_peak_bytes", 0) < meta.get("memory_total_bytes", 0):
        problems.append("memory_peak_bytes=%d below memory_total_bytes=%d "
                        "(peak >= final by construction)"
                        % (meta.get("memory_peak_bytes", 0),
                           meta.get("memory_total_bytes", 0)))
    if meta.get("memory_watermark_hits", 0) > 0:
        if meta.get("memory_watermark_bytes", 0) <= 0:
            problems.append("memory_watermark_hits=%d with no configured "
                            "watermark" % meta["memory_watermark_hits"])
        elif meta.get("memory_peak_bytes", 0) \
                < meta.get("memory_watermark_bytes", 0):
            problems.append(
                "memory_watermark_hits=%d but the peak %d never reached "
                "the %d-byte watermark"
                % (meta["memory_watermark_hits"],
                   meta.get("memory_peak_bytes", 0),
                   meta.get("memory_watermark_bytes", 0)))
    if meta.get("memory_reconciled", 0) not in (0, 1):
        problems.append("memory_reconciled must be 0 or 1, got %s"
                        % meta.get("memory_reconciled"))
    if meta.get("memory_reconciled", 0) == 1 \
            and meta.get("memory_live_bytes", 0) <= 0:
        problems.append("memory_reconciled=1 with live_bytes=0 (a "
                        "reconcile verdict needs the backend's live-buffer "
                        "total)")
    if meta.get("memory_live_bytes", 0) > 0 \
            and meta.get("memory_reconciled", 0) != 1:
        problems.append(
            "live_bytes=%d but reconciled=0 — the ledger's live-backed "
            "claims exceed the backend's own live buffers (the ledger is "
            "lying about device memory)" % meta.get("memory_live_bytes", 0))
    return problems


def shard_problems(log_dir: str, meta: dict) -> List[str]:
    """The ``Shard:`` ledger's invariants (the reference's --check, with
    its messages): the totals foot the per-step detail, a running stage
    sits inside its budget, each declared ring fits the config's devices
    and ran its degree, and the merge nests inside the inference spans
    it rides (traced collective wall <= traced model_call wall)."""
    problems: List[str] = []
    shard = meta["lines"].get("Shard")
    if shard is None:
        return problems
    detail = {str(k): dict(v) for k, v
              in dict(meta.get("shard_step_detail") or {}).items()}
    if len(detail) != shard["steps"]:
        problems.append(
            "'Shard:' says steps=%d but 'Shard steps:' details %d step(s)"
            % (shard["steps"], len(detail)))
    for key in ("gathers", "collective_us", "rows"):
        want = sum(int(d.get(key, 0)) for d in detail.values())
        if int(shard[key]) != want:
            problems.append("'Shard:' %s=%d but the per-step details sum "
                            "to %d" % (key, shard[key], want))
    if detail:
        want = max(int(d.get("degree", 0)) for d in detail.values())
        if int(shard["max_degree"]) != want:
            problems.append("'Shard:' max_degree=%d but the per-step "
                            "details max to %d"
                            % (shard["max_degree"], want))
    for step_key, d in sorted(detail.items()):
        for key in ("gathers", "collective_us", "rows"):
            if int(d.get(key, 0)) < 0:
                problems.append("negative shard %s on step %s"
                                % (key, step_key))
        if int(d.get("degree", 0)) < 1:
            problems.append(
                "'Shard steps:' step %s shows degree %s (a declared stage "
                "runs at least degree 1)" % (step_key, d.get("degree")))
        budget = float(d.get("budget_mb") or 0.0)
        projected = float(d.get("projected_mb") or 0.0)
        if budget and projected > budget:
            problems.append(
                "'Shard steps:' step %s projects %.1f MiB over its %.1f MiB "
                "budget — an over-budget stage is launch-rejected, so this "
                "line cannot come from a completed run"
                % (step_key, projected, budget))
    raw = _config(meta)
    for step_idx, step in enumerate((raw or {}).get("pipeline", ())):
        spec = step.get("shard") if isinstance(step, dict) else None
        if not isinstance(spec, dict):
            continue
        degree = int(spec.get("degree", 1))
        devs = sum(len(g.get("devices") or ())
                   for g in step.get("queue_groups") or ()
                   if isinstance(g, dict))
        if devs and degree > devs:
            problems.append(
                "pipeline step %d declares shard degree %d x 1 replica(s) "
                "but lists only %d device(s) — the ring exceeds the step's "
                "device budget" % (step_idx, degree, devs))
        d = detail.get(str(step_idx))
        if d is not None and int(d.get("degree", 0)) != degree:
            problems.append("'Shard steps:' says step %d ran degree %s but "
                            "the config declares %d"
                            % (step_idx, d.get("degree"), degree))
    trace_path = os.path.join(log_dir, "trace.json")
    if not os.path.isfile(trace_path) or meta["lines"].get(
            "Trace", {}).get("dropped", 0):
        return problems
    with open(trace_path) as f:
        doc = json.load(f)
    coll_us: Dict[int, float] = {}
    call_us: Dict[int, float] = {}
    span_re = re.compile(r"exec(\d+)\.(collective|model_call)$")
    for ev in doc.get("traceEvents", []):
        m = span_re.match(str(ev.get("name", ""))) \
            if ev.get("ph") == "X" else None
        if m:
            bucket = coll_us if m.group(2) == "collective" else call_us
            step = int(m.group(1))
            bucket[step] = bucket.get(step, 0.0) + float(ev.get("dur", 0.0))
    for step_idx, us in sorted(coll_us.items()):
        if us > call_us.get(step_idx, 0.0) + 1.0:
            problems.append(
                "step %d traced %.0f us of exec.collective spans but only "
                "%.0f us of model_call spans — the merge must nest inside "
                "the inference span it rides"
                % (step_idx, us, call_us.get(step_idx, 0.0)))
    return problems


def whatif_problems(log_dir: str, meta: dict) -> List[str]:
    """The ``Whatif:`` line's invariants (the reference's
    ``_check_whatif``)."""
    line = meta["lines"].get("Whatif")
    if line is None:
        return []
    problems = []
    if line.get("calibrated") not in (0, 1):
        problems.append("whatif_calibrated must be 0 or 1, got %s"
                        % line.get("calibrated"))
    if "Metrics" not in meta["lines"]:
        return problems + ["log-meta carries a 'Whatif:' line but no "
                           "'Metrics:' line — the what-if engine "
                           "calibrates from the metrics plane"]
    if line.get("calibrated") != 1:
        if line.get("pred_vps_milli", 0) != 0:
            problems.append("whatif_pred_vps_milli=%d with calibrated=0 (an "
                            "uncalibrated model must not predict)"
                            % line["pred_vps_milli"])
        return problems
    # the line must recompute from the artifacts alone
    want = whatif_mod.summary_counters(whatif_mod.calibrate_job(log_dir))
    for key in ("stages", "calibrated", "bottleneck_step"):
        if line.get(key) != want[key]:
            problems.append("'Whatif:' %s=%s but metrics.jsonl + the config "
                            "copy recompute %s" % (key, line.get(key),
                                                   want[key]))
    if abs(line.get("pred_vps_milli", 0) - want["pred_vps_milli"]) > 1:
        problems.append("'Whatif:' pred_vps_milli=%s but metrics.jsonl + the "
                        "config copy recompute %d"
                        % (line.get("pred_vps_milli"), want["pred_vps_milli"]))
    return problems


#: the sampler cadence's tolerance (the reference's): ticks may run a
#: little over sample_hz x the window (the drain to thread join) and far
#: under it on a loaded host
STACKS_UPPER_SLACK = 1.5
STACKS_LOWER_FRAC = 0.2
STACKS_ABS_SLACK = 25


def read_folded(path: str):
    """``(stacks, total count, roles, unparsable lines)`` of a
    ``stacks.folded``."""
    stacks = total = bad = 0
    roles = set()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            stack, _, count = line.rpartition(" ")
            if not stack or not count.lstrip("-").isdigit():
                bad += 1
                continue
            stacks += 1
            total += int(count)
            roles.add(stack.split(";", 1)[0])
    return stacks, total, roles, bad


def operator_problems(log_dir: str, meta: dict) -> List[str]:
    """The operator plane's invariants (the reference's
    ``_check_operator``): the ``Operator:`` ledger against
    ``operator.json`` both ways, ``stacks.folded`` against ``Stacks:``,
    and the sampler's cadence."""
    lines = meta["lines"]
    op_path = os.path.join(log_dir, "operator.json")
    folded_path = os.path.join(log_dir, "stacks.folded")
    problems = []
    if "Operator" not in lines:
        if os.path.isfile(op_path):
            problems.append("operator.json present but log-meta has no "
                            "'Operator:' line")
        if "Stacks" in lines:
            problems.append("log-meta carries a 'Stacks:' line but no "
                            "'Operator:' line (the sampler rides the "
                            "operator key)")
        if os.path.isfile(folded_path):
            problems.append("stacks.folded present but log-meta has no "
                            "'Stacks:' line")
        return problems
    problems.extend("negative operator_%s" % k
                    for k, v in sorted(lines["Operator"].items()) if v < 0)
    if not os.path.isfile(op_path):
        problems.append("log-meta carries an 'Operator:' line but "
                        "operator.json is missing")
    else:
        try:
            with open(op_path) as f:
                record = json.load(f)
        except (OSError, ValueError) as e:
            problems.append("operator.json unreadable: %s" % e)
            record = {}
        port = record.get("port")
        if record and (not isinstance(port, int) or not 1 <= port <= 65535):
            problems.append("operator.json carries no bound port (got %r)"
                            % (port,))
        if record and not record.get("host"):
            problems.append("operator.json names no host")
    stacks_line = lines.get("Stacks")
    if stacks_line is None:
        if os.path.isfile(folded_path):
            problems.append("stacks.folded present but log-meta has no "
                            "'Stacks:' line")
        return problems
    problems.extend("negative stacks_%s" % k
                    for k, v in sorted(stacks_line.items()) if v < 0)
    if not os.path.isfile(folded_path):
        problems.append("log-meta carries a 'Stacks:' line but "
                        "stacks.folded is missing")
    else:
        stacks, total, roles, bad = read_folded(folded_path)
        if bad:
            problems.append("stacks.folded holds %d unparsable line(s) "
                            "(want 'role;frame;... count')" % bad)
        if stacks != stacks_line.get("folded"):
            problems.append("stacks.folded holds %d folded stack(s) but the "
                            "'Stacks:' line says folded=%s"
                            % (stacks, stacks_line.get("folded")))
        if total != stacks_line.get("total"):
            problems.append("stacks.folded counts sum to %d but the "
                            "'Stacks:' line says total=%s (every sample must "
                            "fold exactly once)"
                            % (total, stacks_line.get("total")))
        if len(roles) != stacks_line.get("threads"):
            problems.append("stacks.folded names %d role(s) but the "
                            "'Stacks:' line says threads=%s"
                            % (len(roles), stacks_line.get("threads")))
    if stacks_line.get("folded", 0) > stacks_line.get("total", 0):
        problems.append("stacks_folded=%s exceeds stacks_total=%s"
                        % (stacks_line.get("folded"),
                           stacks_line.get("total")))
    operator = (whatif_mod.job_config(log_dir) or {}).get("operator")
    window = meta.get("window")
    if isinstance(operator, dict) and operator.get("enabled", True) \
            and window and window[1] > window[0]:
        hz = float(operator.get("sample_hz", DEFAULT_SAMPLE_HZ))
        expected = hz * (window[1] - window[0])
        upper = expected * STACKS_UPPER_SLACK + STACKS_ABS_SLACK
        lower = max(0.0, expected * STACKS_LOWER_FRAC - STACKS_ABS_SLACK)
        samples = stacks_line.get("samples", 0)
        if hz > 0 and samples > upper:
            problems.append("stacks_samples=%d far exceeds sample_hz x wall "
                            "= %.1f (upper tolerance %.1f)"
                            % (samples, expected, upper))
        if hz > 0 and samples < lower:
            problems.append("stacks_samples=%d falls far below sample_hz x "
                            "wall = %.1f (lower tolerance %.1f)"
                            % (samples, expected, lower))
    return problems


#: the ``Net:`` and ``Net errors:`` counters (rnb_tpu_torch.benchmark)
NET_KEYS = ("frames_sent", "frames_acked", "resent_pending", "resends",
            "beats", "reconnects", "remote", "local", "dedup_drops",
            "dup_arrivals", "wire_bytes", "frame_bytes", "window_stranded",
            "open_before_timeout")
NET_ERROR_CLASSES = ("refused", "reset", "timeout", "partial_frame",
                     "corrupt")


def netedge_problems(meta: dict) -> List[str]:
    """The network edge's ledger (the reference's ``_check_netedge``):
    sends foot against acks plus the unacked remainder, the error
    classes re-sum to the total, duplicate arrivals and dedup drops pair
    1:1, no remote dispatch lacks its REQ frame, and a run that reached
    its target strands nothing in the resend window."""
    lines = meta["lines"]
    net, errors = lines.get("Net"), lines.get("Net errors")
    if net is None:
        return (["log-meta carries a 'Net errors:' line but no 'Net:' "
                 "totals line"] if errors is not None else [])
    if errors is None:
        return ["log-meta carries a 'Net:' line but no 'Net errors:' line"]
    problems = ["negative net_%s" % k for k in NET_KEYS if net.get(k, 0) < 0]
    problems += ["negative net_err_%s" % k for k in ("total",)
                 + NET_ERROR_CLASSES if errors.get(k, 0) < 0]
    sent, acked = net.get("frames_sent", 0), net.get("frames_acked", 0)
    pending = net.get("resent_pending", 0)
    if sent != acked + pending:
        problems.append("net_frames_sent=%d != net_frames_acked=%d + "
                        "net_resent_pending=%d — the send/ack ledger does "
                        "not foot at teardown" % (sent, acked, pending))
    class_sum = sum(errors.get(k, 0) for k in NET_ERROR_CLASSES)
    if class_sum != errors.get("total", 0):
        problems.append("per-class net error counts sum to %d but the 'Net "
                        "errors:' line says total=%d — a fault class "
                        "escaped classification"
                        % (class_sum, errors.get("total", 0)))
    if net.get("dedup_drops", 0) != net.get("dup_arrivals", 0):
        problems.append("net_dedup_drops=%d != net_dup_arrivals=%d — a "
                        "duplicate arrival escaped the receiver-side dedup "
                        "ledger (exactly-once violated)"
                        % (net.get("dedup_drops", 0),
                           net.get("dup_arrivals", 0)))
    if sent < net.get("remote", 0):
        problems.append("net_remote=%d exceeds net_frames_sent=%d — a "
                        "remote dispatch that never produced a REQ frame"
                        % (net.get("remote", 0), sent))
    if meta.get("termination_flag") == 0 \
            and net.get("window_stranded", 0) != 0:
        problems.append("net_window_stranded=%d on a target-reached run — "
                        "requests left in the resend window were neither "
                        "rerouted nor settled" % net["window_stranded"])
    return problems


def lock_problems(meta: dict) -> List[str]:
    """The lock-order witness's ledger (the reference's ``_check_locks``):
    the counts foot against the detail, no violation, and every observed
    edge lies in the port's static lock-order graph
    (:func:`rnb_tpu_torch.analysis.concurrency.static_lock_order_edges`)."""
    locks = meta["lines"].get("Locks")
    detail = meta.get("lock_edge_detail")
    if locks is None:
        return (["log-meta carries a 'Lock edges:' line but no 'Locks:' "
                 "totals line"] if detail is not None else [])
    if detail is None:
        return ["log-meta carries a 'Locks:' line but no 'Lock edges:' "
                "detail line"]
    edges = [tuple(e) for e in detail.get("edges", [])]
    violations = detail.get("violations", [])
    problems = ["negative locks_%s" % k for k in (
        "tracked", "acquires", "edges", "violations") if locks.get(k, 0) < 0]
    if len(edges) != locks.get("edges", 0):
        problems.append("'Lock edges:' lists %d edge(s) but the Locks: line "
                        "says edges=%d" % (len(edges), locks.get("edges", 0)))
    if len(violations) != locks.get("violations", 0):
        problems.append("'Lock edges:' lists %d violation(s) but the Locks: "
                        "line says violations=%d"
                        % (len(violations), locks.get("violations", 0)))
    if violations:
        problems.append("lock-order witness recorded %d discipline "
                        "violation(s): %s" % (len(violations), "; ".join(
                            str(v) for v in violations[:5])))
    if locks.get("edges", 0) > locks.get("acquires", 0):
        problems.append("locks_edges=%d exceeds locks_acquires=%d — an order "
                        "edge with no acquisition behind it"
                        % (locks.get("edges", 0), locks.get("acquires", 0)))
    named = {name for edge in edges for name in edge}
    if len(named) > locks.get("tracked", 0):
        problems.append("%d distinct lock name(s) appear in edges but only "
                        "locks_tracked=%d were witnessed"
                        % (len(named), locks.get("tracked", 0)))
    if edges:
        try:
            from rnb_tpu_torch.analysis.concurrency import \
                static_lock_order_edges
            declared = static_lock_order_edges()
        except Exception as e:
            problems.append("static lock-order graph unavailable "
                            "(%s) — observed edges unverified" % e)
        else:
            for a, b in edges:
                if (a, b) not in declared:
                    problems.append(
                        "observed lock-order edge %s -> %s is not in "
                        "the static RNB-C lock-order graph — an "
                        "undeclared runtime lock dependency" % (a, b))
    return problems


def health_problems(meta: dict) -> List[str]:
    """The lane boards' invariants (the reference's ``_check_health``):
    every lane's transition path is a legal walk of the automaton that
    ends in its state, the ``Health:`` counters re-derive from the
    paths, no route landed on an open or evicted lane, and only an
    evicted lane moved work off itself. (That every request terminated
    is :func:`fault_problems`' footing.)"""
    from rnb_tpu_torch.health import EVICTED, OPEN, legal_path
    health = meta["lines"].get("Health")
    detail = meta.get("health_lane_detail")
    if health is None:
        return (["log-meta carries a 'Health lanes:' line but no "
                 "'Health:' totals line"] if detail is not None else [])
    problems = ["negative health_%s" % k for k, v in sorted(health.items())
                if v < 0]
    if health.get("routes_after_open", 0) != 0:
        problems.append("health_routes_after_open=%d — a route landed on "
                        "an open/evicted lane (circuit containment "
                        "violated)" % health["routes_after_open"])
    if detail is None:
        if health.get("lanes", 0):
            problems.append("'Health:' counts %d lane(s) but no 'Health "
                            "lanes:' detail line exists" % health["lanes"])
        return problems
    if len(detail) != health.get("lanes", 0):
        problems.append("'Health lanes:' names %d lane(s) but the "
                        "'Health:' line says lanes=%d"
                        % (len(detail), health.get("lanes", 0)))
    want = dict.fromkeys(("transitions", "opens", "evictions",
                          "redispatches", "routes_after_open"), 0)
    for lane, entry in sorted(detail.items()):
        path = list(entry.get("path", []))
        if not legal_path(path):
            problems.append("lane %s transition path %s is not a legal walk "
                            "of the health automaton (healthy start, "
                            "declared edges only)" % (lane, path))
        if path and entry.get("state") != path[-1]:
            problems.append("lane %s final state %r disagrees with its path "
                            "%s" % (lane, entry.get("state"), path))
        moved = int(entry.get("redispatched_from", 0))
        want["transitions"] += max(0, len(path) - 1)
        want["opens"] += path.count(OPEN)
        want["evictions"] += path.count(EVICTED)
        want["redispatches"] += moved
        want["routes_after_open"] += int(entry.get("routes_after_open", 0))
        if moved and entry.get("state") != EVICTED:
            problems.append("lane %s reports %d redispatched item(s) but was "
                            "never evicted — only an evicted lane's drain "
                            "moves work" % (lane, moved))
    for key, value in want.items():
        if health.get(key, 0) != value:
            problems.append("'Health lanes:' detail recomputes %s=%d but the "
                            "'Health:' line says %d"
                            % (key, value, health.get(key, 0)))
    return problems


def hedge_problems(meta: dict) -> List[str]:
    """The ``Hedge:`` line's invariants (the reference's
    ``_check_hedge``): every fired hedge resolved exactly once, and no
    waste without a hedge."""
    hedge = meta["lines"].get("Hedge")
    if hedge is None:
        return []
    problems = ["negative hedges_%s" % k for k, v in sorted(hedge.items())
                if v < 0]
    fired, won, lost = (int(hedge.get(k, 0)) for k in ("fired", "won",
                                                        "lost"))
    if won + lost != fired:
        problems.append("hedges_won=%d + hedges_lost=%d != hedges_fired=%d "
                        "(every fired hedge resolves exactly once)"
                        % (won, lost, fired))
    if fired == 0 and hedge.get("wasted_ms", 0) > 0:
        problems.append("hedges_wasted_ms=%d with no hedge fired"
                        % hedge["wasted_ms"])
    return problems


def _config_handoff_mode(log_dir: str):
    """The handoff mode the job's config copy declares, or None."""
    for name in sorted(os.listdir(log_dir)):
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(log_dir, name)) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(raw, dict) or "pipeline" not in raw:
            continue
        handoff = raw.get("handoff")
        if isinstance(handoff, dict) and handoff.get("enabled", True):
            return handoff.get("mode", "device")
        return None
    return None


def handoff_problems(log_dir: str, meta: dict) -> List[str]:
    """The ``Handoff:`` ledger's invariants (the reference's
    ``_check_handoff``): every take has one class, the per-edge detail
    sums to the totals, and a device config moved no host bytes."""
    handoff = meta["lines"].get("Handoff")
    if handoff is None:
        return (["log-meta carries a 'Handoff edges:' line but no "
                 "'Handoff:' totals line"]
                if "handoff_edge_detail" in meta else [])
    problems = ["negative handoff_%s" % k
                for k, v in sorted(handoff.items()) if v < 0]
    d2d, host = int(handoff["d2d_edges"]), int(handoff["host_edges"])
    if d2d + host != int(handoff["edges"]):
        problems.append("handoff_d2d_edges=%d + handoff_host_edges=%d != "
                        "handoff_edges=%d (every edge take has exactly one "
                        "class)" % (d2d, host, handoff["edges"]))
    detail = meta.get("handoff_edge_detail") or {}
    if detail:
        for key in ("d2d_edges", "host_edges", "d2d_bytes", "host_bytes"):
            summed = sum(int(e.get(key, 0)) for e in detail.values())
            if summed != int(handoff[key]):
                problems.append("'Handoff edges:' %s sums to %d but the "
                                "'Handoff:' line says %d"
                                % (key, summed, handoff[key]))
    if _config_handoff_mode(log_dir) == "device" and handoff["host_bytes"]:
        problems.append("handoff_host_bytes=%d on a device-resident config "
                        "(handoff.mode \"device\" promises zero host-hop "
                        "bytes on every edge)" % handoff["host_bytes"])
    return problems


#: the predicted-against-traced occupancy tolerance (the reference's):
#: relative, with an absolute floor for near-idle stages
OCCUPANCY_REL_TOL = 0.25
OCCUPANCY_ABS_TOL = 0.05


def placement_problems(log_dir: str, meta: dict) -> List[str]:
    """The ``Placement:`` report's invariants (the reference's
    ``_check_placement``): every recommended step gets a replica, and on
    a complete trace each step's predicted occupancy lies within
    tolerance of its traced busy fraction (``exec{i}.model_call`` +
    ``device_sync`` spans over the window, per instance)."""
    report = meta.get("placement")
    if not report:
        return []
    problems = ["'Placement:' plan for %s names %r replicas (must be >= 1)"
                % (key, entry.get("replicas"))
                for key, entry in sorted(report.get("plan", {}).items())
                if int(entry.get("replicas", 0)) < 1]
    path = os.path.join(log_dir, "trace.json")
    trace_line = meta["lines"].get("Trace", {})
    if not os.path.isfile(path) or trace_line.get("dropped", 0) \
            or "window" not in meta:
        return problems
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    except ValueError:
        return problems  # trace_problems reports it
    busy_us: Dict[int, float] = {}
    span = re.compile(r"exec(\d+)\.(model_call|device_sync)$")
    for ev in events:
        m = span.match(str(ev.get("name", ""))) if ev.get("ph") == "X" \
            else None
        if m:
            step = int(m.group(1))
            busy_us[step] = busy_us.get(step, 0.0) + float(ev.get("dur", 0))
    start, end = meta["window"]
    wall = end - start
    for key, entry in sorted(report.get("steps", {}).items()):
        step = int(key[4:])
        if step not in busy_us or wall <= 0:
            continue
        pred = float(entry.get("occupancy", 0.0))
        traced = (busy_us[step] / 1e6 / wall
                  / max(1, int(entry.get("instances", 1))))
        tol = max(OCCUPANCY_REL_TOL * traced, OCCUPANCY_ABS_TOL)
        if abs(pred - traced) > tol:
            problems.append(
                "'Placement:' %s predicts occupancy %.4f but the trace "
                "records a %.4f busy fraction (tolerance max(%d%%, %.2f)) — "
                "the planner's cost model drifted from what the executors "
                "measured" % (key, pred, traced,
                              int(OCCUPANCY_REL_TOL * 100),
                              OCCUPANCY_ABS_TOL))
    return problems


def footing_problems(meta: dict) -> List[str]:
    """The footings of the ``Compiles:`` and ``Pages:`` lines that do
    not hold (empty when they all hold)."""
    problems = []
    for step, sigs in sorted(meta.get("compile_signatures", {}).items()):
        if int(sigs.get("steady_new", 0)) > 0:
            problems.append(
                "%s compiled %d new signature(s) inside the measured "
                "window (Compiles: steady_new) — warmup must cover the "
                "full shape vocabulary" % (step, int(sigs["steady_new"])))
    pages = meta["lines"].get("Pages")
    if pages is None:
        return problems
    if pages["allocs"] != pages["frees"] + pages["live"]:
        problems.append("Pages: allocs=%d != frees=%d + live=%d (a page "
                        "leaked or was freed twice)"
                        % (pages["allocs"], pages["frees"], pages["live"]))
    if pages["feature_hits"] > pages["feature_lookups"]:
        problems.append("Pages: feature_hits=%d > feature_lookups=%d"
                        % (pages["feature_hits"], pages["feature_lookups"]))
    hit_rows = meta["lines"].get("Ragged", {}).get("cache_hit_rows", 0)
    if pages["gather_rows"] > hit_rows:
        problems.append("Pages: gather_rows=%d > Ragged cache_hit_rows=%d "
                        "(gathered rows are cache-hit rows)"
                        % (pages["gather_rows"], hit_rows))
    return problems


def summarize(log_dir: str) -> dict:
    meta = read_meta(os.path.join(log_dir, "log-meta.txt"))
    start, end = meta["window"]
    out = dict(log_dir=log_dir, config=meta["args"]["config"],
               mean_interval_ms=meta["args"]["mean_interval_ms"],
               window_s=end - start, launches=meta.get("launches", {}),
               pixel_path=meta.get("pixel_path"),
               decode_backend=meta.get("decode_backend"),
               compile_signatures=meta.get("compile_signatures"),
               warmup_s=meta.get("warmup_s"), graphs=meta.get("graphs"))
    requests, wait_ms = 0, []
    by_step: Dict[int, List[float]] = {}
    for path in timing_tables(log_dir):
        keys, rows = read_table(path)
        for step, values in step_service_ms(keys, rows).items():
            by_step.setdefault(step, []).extend(values)
        step = max(by_step, default=0)
        if step > 0:
            for arrive, leave in _stamp_pairs(
                    keys, "inference%d_finish" % (step - 1),
                    "runner%d_start" % step):
                wait_ms.extend(1e3 * (row[leave] - row[arrive])
                               for row in rows)
        requests += len(rows)
    service_ms = by_step[max(by_step)] if by_step else []
    lines = meta["lines"]
    # clip rows served: the final step's own count; in logs written
    # before that line existed, the pools' valid rows or the buckets'
    # shipped rows less their padding
    if "Completed" in lines:
        clips = lines["Completed"]["clips"]
    elif "Ragged" in lines:
        clips = lines["Ragged"]["rows"]
    else:
        clips = (lines["Padding"]["total_rows"]
                 - lines["Padding"]["pad_rows"])
    out.update(requests=requests, videos_per_s=requests / out["window_s"],
               clips_per_s=clips / out["window_s"],
               emissions=len(service_ms),
               runner_service_ms=_mean(service_ms),
               runner_wait_ms=_mean(wait_ms),
               service_ms_by_step={str(step): _mean(values)
                                   for step, values in sorted(
                                       by_step.items())},
               emissions_by_step={str(step): len(values)
                                  for step, values in sorted(
                                      by_step.items())})
    if "Trace" in lines:
        out.update(trace_events=int(lines["Trace"]["events"]),
                   trace_dropped=int(lines["Trace"]["dropped"]))
    for head in ("Metrics", "Slo", "Critpath", "Autotune", "Faults",
                 "Deadline", "Compute", "Memory", "Shard", "Whatif",
                 "Operator", "Stacks", "Health", "Net", "Net errors",
                 "Locks"):
        if head in lines:
            out[head.lower().replace(" ", "_")] = {
                k: int(v) for k, v in lines[head].items()}
    if "Profile" in lines:
        out["profile"] = dict(lines["Profile"])
    if "autotune_buckets" in meta:
        out["autotune_buckets"] = meta["autotune_buckets"]
    if "Cache" in lines:
        cache = lines["Cache"]
        lookups = cache["hits"] + cache["misses"]
        out.update(cache_hits=int(cache["hits"]),
                   cache_coalesced=int(cache["coalesced"]),
                   cache_hit_rate=cache["hits"] / lookups if lookups
                   else None)
    if "Pages" in lines:
        pages = lines["Pages"]
        out.update({"pages_" + k: int(pages[k]) for k in (
            "gathers", "gather_rows", "feature_lookups", "feature_hits",
            "feature_gathers", "bypassed_batches")})
        out["arenas"] = meta.get("arenas")
    out["footing_problems"] = check_job(log_dir)
    profile = os.path.join(log_dir, "profile.json")
    if os.path.exists(profile):
        with open(profile) as f:
            kernels = json.load(f)["kernels"]
        kernel_ms = sum(k["device_us"] for k in kernels.values()) / 1e3
        # per forward of the last network step: its graph replays (None
        # in a log without a Graphs: line)
        graphs = out.get("graphs") or {}
        forwards = (graphs[max(graphs, key=lambda k: int(k[4:]))]["replays"]
                    if graphs else 0)
        out.update(kernel_ms=kernel_ms,
                   device_launches=sum(k["count"] for k in kernels.values()),
                   busy_share=kernel_ms / (1e3 * out["window_s"]),
                   kernel_ms_per_emission=(kernel_ms / forwards
                                           if forwards else None),
                   kernel_ms_per_request=kernel_ms / requests,
                   kernel_families=kernel_families(kernels))
    return out


#: the timing-table columns this reader knows, as stamp templates (the
#: ``%d`` is the step; a merged segment card suffixes ``-<sub_id>``):
#: telemetry.STAMP_REGISTRY's, which rnb-lint's RNB-T002 holds to this
#: reader. A column outside them is a stamp no report reads.
TABLE_STAMPS = ("enqueue_filename", "runner%d_start", "inference%d_start",
                "inference%d_finish", "decode%d_done", "transfer%d_start",
                "transfer%d_done")
_TABLE_COLUMN = re.compile("^(%s)(-\\d+)?$" % "|".join(
    stamp.replace("%d", "\\d+") for stamp in TABLE_STAMPS))


def table_problems(path: str) -> List[str]:
    """One timing table as the reference's reader parses it: a header,
    then rows whose stamp columns are all numbers; the stamp columns are
    stamps this reader knows. Empty when it parses."""
    base = os.path.basename(path)
    with open(path) as f:
        lines = [ln.split() for ln in f.read().splitlines()
                 if ln.strip() and not ln.startswith("#")]
    if not lines:
        return []
    header = lines[0]
    keys = [k for k in header if not k.startswith("device")]
    problems = ["%s: column %r is no stamp the reader knows (%s)"
                % (base, k, ", ".join(TABLE_STAMPS))
                for k in keys if not _TABLE_COLUMN.match(k)]
    for idx, row in enumerate(lines[1:], 2):
        if len(row) != len(header):
            problems.append("%s unparsable: line %d has %d fields for %d "
                            "columns" % (base, idx, len(row), len(header)))
            break
        try:
            [float(v) for v in row[:len(keys)]]
        except ValueError as e:
            problems.append("%s unparsable: line %d: %s" % (base, idx, e))
            break
    return problems


def _trailer_sums(tables: List[str]) -> Dict[str, int]:
    """The tables' ``# cache`` and ``# padding`` trailers summed, with
    ``saw_cache``/``saw_padding`` set where any table carries one."""
    sums = dict.fromkeys(("num_hits", "num_tracked", "pad_rows", "rows",
                          "saw_cache", "saw_padding"), 0)
    for path in tables:
        trailers = read_trailers(path)
        sums["rows"] += len(read_table(path)[1])
        if "cache" in trailers:
            sums["saw_cache"] = 1
            sums["num_hits"] += trailers["cache"].get("num_hits", 0)
            sums["num_tracked"] += trailers["cache"].get("num_tracked", 0)
        if "padding" in trailers:
            sums["saw_padding"] = 1
            sums["pad_rows"] += trailers["padding"].get("pad_rows", 0)
    return sums


def _negatives(line: dict, prefix: str) -> List[str]:
    return ["negative %s%s" % (prefix, k) for k, v in sorted(line.items())
            if v < 0]


def ledger_problems(log_dir: str, meta: dict) -> List[str]:
    """The reference's ledger invariants the port's other checks do not
    hold: the cache (its ``# cache`` trailers against the ``Cache:``
    line, inserts within misses), the staging pools (waits within
    acquires), the pager's remaining identities, the autotune counters'
    signs, padding (pads within shipped rows, the trailers within the
    line) and the ragged pool (valid rows within emissions x pool rows,
    hit rows within valid rows, no pad row on a fully ragged run)."""
    lines = meta["lines"]
    sums = _trailer_sums(timing_tables(log_dir))
    problems = []
    cache = lines.get("Cache")
    if sums["saw_cache"] and cache is None:
        problems.append("tables carry a '# cache' trailer but log-meta has "
                        "no 'Cache:' line")
    if cache is not None:
        if sums["num_hits"] > cache["hits"] + cache.get("coalesced", 0):
            problems.append("tables count %d completed cache hits but "
                            "log-meta records only %d lookup hits (+%d "
                            "coalesced)" % (sums["num_hits"], cache["hits"],
                                            cache.get("coalesced", 0)))
        if sums["num_tracked"] > sums["rows"]:
            problems.append("cache trailer tracks %d completions but tables "
                            "hold %d rows" % (sums["num_tracked"],
                                              sums["rows"]))
        if cache.get("inserts", 0) > cache.get("misses", 0):
            problems.append("cache_inserts=%d exceeds cache_misses=%d "
                            "(inserts happen only after a miss decoded)"
                            % (cache["inserts"], cache["misses"]))
        if cache.get("bytes_resident", 0) < 0:
            problems.append("negative cache_bytes_resident")
    staging = _staging_totals(meta)
    if staging:
        problems += _negatives(staging, "staging_")
        if staging.get("acquire_waits", 0) > staging.get("acquires", 0):
            problems.append("staging_acquire_waits=%d exceeds "
                            "staging_acquires=%d (every wait is part of an "
                            "acquire)" % (staging["acquire_waits"],
                                          staging["acquires"]))
    pages = lines.get("Pages")
    if pages is not None:
        problems += _negatives(pages, "pages_")
        if pages.get("limbo", 0) > pages.get("live", 0):
            problems.append("pages_limbo=%d exceeds pages_live=%d (limbo "
                            "pages are off the free list)"
                            % (pages["limbo"], pages["live"]))
        if pages.get("feature_inserts", 0) != pages.get(
                "feature_entries", 0) + pages.get("feature_evictions", 0):
            problems.append("pages_feature_inserts=%d != "
                            "pages_feature_entries=%d + "
                            "pages_feature_evictions=%d (entries leave only "
                            "by eviction)" % (pages["feature_inserts"],
                                              pages["feature_entries"],
                                              pages["feature_evictions"]))
        if pages.get("feature_gathers", 0) > pages.get("feature_hits", 0):
            problems.append("pages_feature_gathers=%d exceeds "
                            "pages_feature_hits=%d (a gather needs a hit "
                            "plan; shed hits release without gathering)"
                            % (pages["feature_gathers"],
                               pages["feature_hits"]))
    if "Autotune" in lines:
        problems += _negatives(lines["Autotune"], "autotune_")
    padding = lines.get("Padding")
    if padding is not None:
        if padding["pad_rows"] > padding.get("total_rows", 0):
            problems.append("pad_rows=%d exceeds total_rows=%d (pads are "
                            "part of the shipped rows)"
                            % (padding["pad_rows"], padding["total_rows"]))
        if sums["saw_padding"] and sums["pad_rows"] > padding["pad_rows"]:
            problems.append("tables count pad_rows=%d but log-meta says %d "
                            "(the job-wide counter covers every emission)"
                            % (sums["pad_rows"], padding["pad_rows"]))
    ragged = lines.get("Ragged")
    if ragged is not None:
        problems += _negatives(ragged, "ragged_")
        capacity = ragged.get("emissions", 0) * ragged.get("pool_rows", 0)
        if ragged.get("rows", 0) > capacity:
            problems.append("ragged_rows=%d exceeds emissions*pool_rows=%d "
                            "— an emission carried more valid rows than the "
                            "pool holds" % (ragged["rows"], capacity))
        if ragged.get("cache_hit_rows", 0) > ragged.get("rows", 0):
            problems.append("ragged_cache_hit_rows=%d exceeds ragged_rows=%d "
                            "(hit rows ship inside pool emissions)"
                            % (ragged["cache_hit_rows"], ragged["rows"]))
        if padding is not None \
                and padding.get("pad_emissions") == ragged.get("emissions") \
                and padding["pad_rows"] > 0:
            problems.append("pad_rows=%d on a fully ragged run (every "
                            "emission ragged) — the ragged path must compute "
                            "no pad rows" % padding["pad_rows"])
    return problems


def phase_problems(log_dir: str, meta: dict,
                   num_skips: int = NUM_SUMMARY_SKIPS) -> List[str]:
    """The phase attribution's invariants (the reference's
    ``_check_phases``): every row's phases partition its end-to-end span
    within 1 ms, every steady row gives one sample per phase, and the
    ``# phases`` trailers and the ``Phases:`` line re-derive from the
    tables."""
    problems: List[str] = []
    merged: Dict[str, List[float]] = {}
    tables = timing_tables(log_dir)
    saw_trailer = False
    for path in tables:
        base = os.path.basename(path)
        keys, rows = read_table(path)
        for row in rows:
            if len(row) < 2:
                continue
            total = sum(attribute_phases(dict(zip(keys, row))).values())
            e2e_ms = (max(row) - min(row)) * 1e3
            if abs(total - e2e_ms) > 1.0:
                problems.append("%s: a request's phases sum to %.3f ms but "
                                "its end-to-end latency is %.3f ms "
                                "(attribution must partition the span)"
                                % (base, total, e2e_ms))
                break
        samples: Dict[str, List[float]] = {}
        for row in rows[num_skips:]:
            for phase, ms in attribute_phases(dict(zip(keys, row))).items():
                samples.setdefault(phase, []).append(ms)
        steady = max(0, len(rows) - num_skips)
        if samples:
            counts = {len(vals) for vals in samples.values()}
            if counts != {steady}:
                problems.append("%s: phase sample counts %s != steady row "
                                "count %d (every completed request "
                                "contributes exactly one sample per phase)"
                                % (base, sorted(counts), steady))
            for phase, vals in samples.items():
                merged.setdefault(phase, []).extend(vals)
        trailer = read_trailers(path).get("phases")
        if trailer is None:
            continue
        saw_trailer = True
        stats = phase_stats(samples)
        n = max((s["count"] for s in stats.values()), default=0)
        if trailer.get("n") != n:
            problems.append("%s: '# phases' trailer says n=%s but the table "
                            "holds %d steady rows" % (base, trailer.get("n"),
                                                      n))
        for phase, s in sorted(stats.items()):
            for stat_key, fmt in (("mean_ms", "%s_mean_us"),
                                  ("p99_ms", "%s_p99_us")):
                want = round(s[stat_key] * 1000)
                got = trailer.get(fmt % phase)
                if got is None or abs(got - want) > 1:
                    problems.append("%s: '# phases' trailer %s=%s but the "
                                    "table's rows recompute to %d"
                                    % (base, fmt % phase, got, want))
    if "phases" in meta:
        if not saw_trailer and tables:
            problems.append("log-meta carries a 'Phases:' line but no table "
                            "carries a '# phases' trailer")
        stats = phase_stats(merged)
        line = meta["phases"]
        if set(line) != set(stats):
            problems.append("'Phases:' line names phases %s but the tables "
                            "recompute %s" % (sorted(line), sorted(stats)))
        else:
            for phase, s in sorted(stats.items()):
                if line[phase].get("count") != s["count"]:
                    problems.append("'Phases:' %s count=%s but tables hold "
                                    "%d steady samples"
                                    % (phase, line[phase].get("count"),
                                       s["count"]))
                for stat_key in ("mean_ms", "p99_ms"):
                    got = line[phase].get(stat_key)
                    if got is None or abs(got - s[stat_key]) > 0.005:
                        problems.append("'Phases:' %s %s=%s but tables "
                                        "recompute %.6f" % (
                                            phase, stat_key, got,
                                            s[stat_key]))
    elif saw_trailer:
        problems.append("tables carry a '# phases' trailer but log-meta has "
                        "no 'Phases:' line")
    return problems


def job_problems(log_dir: str, meta: dict) -> List[str]:
    """Every invariant over one job's parsable files that does not hold."""
    return (footing_problems(meta)
            + ledger_problems(log_dir, meta)
            + phase_problems(log_dir, meta)
            + trace_problems(log_dir, meta)
            + metrics_problems(log_dir, meta)
            + critpath_problems(log_dir, meta)
            + autotune_problems(meta)
            + fault_problems(log_dir, meta)
            + devobs_problems(log_dir, meta)
            + shard_problems(log_dir, meta)
            + whatif_problems(log_dir, meta)
            + operator_problems(log_dir, meta)
            + health_problems(meta)
            + netedge_problems(meta)
            + lock_problems(meta)
            + handoff_problems(log_dir, meta)
            + hedge_problems(meta)
            + placement_problems(log_dir, meta))


def check_job_detail(log_dir: str) -> Tuple[List[str], bool]:
    """``(problems, parse_failed)`` of one job (the reference's
    ``check_job_detail``): ``parse_failed`` marks files the reader cannot
    read (a missing or corrupt ``log-meta.txt``, an unparsable timing
    table), as against an invariant that does not hold over readable
    ones; the CLI exits 2 for the first and 1 for the second."""
    try:
        meta = read_meta(os.path.join(log_dir, "log-meta.txt"))
    except (OSError, ValueError) as e:
        return ["log-meta.txt unreadable: %s" % e], True
    problems = []
    if "termination_flag" not in meta:
        problems.append("log-meta.txt carries no 'Termination flag:'")
    if "window" not in meta:
        problems.append("log-meta.txt carries no start/end timestamps")
    tables = timing_tables(log_dir)
    if not tables:
        problems.append("no timing tables (<device>-group<g>-<i>.txt)")
    parse_failed = False
    for path in tables:
        issues = table_problems(path)
        problems += issues
        parse_failed = parse_failed or any(" unparsable: " in issue
                                           for issue in issues)
    if parse_failed:
        # the invariants below read every table
        return problems, True
    return problems + job_problems(log_dir, meta), False


def check_job(log_dir: str) -> List[str]:
    """Every invariant of one job's logs that does not hold (the
    reference's ``check_job``, for the files the port writes)."""
    return check_job_detail(log_dir)[0]


# -- per-request rows over job directories (the reference's DataFrames) ------
#
# A frame is a dict of equal-length numpy arrays, one per column, in the
# order the reference's DataFrame keeps them: a timing table's header,
# then the producing instance (``final_device``, ``final_group``,
# ``final_instance``), then the job's ``job_id``, ``mean_interval_ms``,
# ``batch_size``, ``videos`` and ``queue_size``. Stamps are float64 (NaN
# where a row of another schema has none), ``device*`` and string columns
# object arrays. Frames of several tables or jobs concatenate over the
# union of their columns in order of first appearance, as ``pd.concat``
# does.

#: ``Args: Namespace(mean_interval_ms=3, ...)``, the JAX package's form
_NAMESPACE_ARG = re.compile(r"(\w+)=('[^']*'|\"[^\"]*\"|[^,)]+)")
#: the port's ``Args:`` JSON keys under the reference's names
_ARG_NAMES = {"num_videos": "videos", "config": "config_file_path"}
#: ``Key: k=v ...`` lines of log-meta.txt, by the prefix the reference's
#: ``parse_meta`` gives their keys
_META_PREFIXES = {
    "Faults": "", "Padding": "", "Cache": "cache_", "Staging": "staging_",
    "Pages": "pages_", "Autotune": "autotune_", "Ragged": "ragged_",
    "Shard": "shard_", "Trace": "trace_", "Metrics": "metrics_",
    "Slo": "slo_", "Compute": "compute_", "Memory": "memory_",
    "Critpath": "critpath_", "Whatif": "whatif_", "Operator": "operator_",
    "Stacks": "stacks_", "Net errors": "net_err_", "Net": "net_",
    "Locks": "locks_", "Handoff": "handoff_", "Health": "health_",
    "Deadline": "deadline_", "Hedge": "hedges_"}
#: the JSON lines of log-meta.txt, by the key the reference's
#: ``parse_meta`` reads each into
_META_JSON = {
    "Compiles": "compile_signatures", "Warmup": "warmup_s",
    "Autotune buckets": "autotune_bucket_counts",
    "Shard steps": "shard_step_detail",
    "Compute stages": "compute_stage_detail",
    "Memory owners": "memory_owner_detail",
    "Critpath stages": "critpath_stage_detail",
    "Lock edges": "lock_edge_detail", "Phases": "phases",
    "Handoff edges": "handoff_edge_detail",
    "Health lanes": "health_lane_detail", "Deadline sites": "deadline_sites",
    "Placement": "placement", "Failure reasons": "failure_reasons",
    "Shed sites": "shed_sites", "Queue overflows": "queue_overflows"}
#: the job's meta keys every request row carries (reference get_data)
JOB_COLUMNS = ("job_id", "mean_interval_ms", "batch_size", "videos",
               "queue_size")
#: columns of a timing table that name its instance, not a time
IDENTITY_COLUMNS = ("final_device", "final_group", "final_instance")


def _scalar(raw: str):
    try:
        return int(raw)
    except ValueError:
        try:
            return float(raw)
        except ValueError:
            return raw


def parse_meta(job_dir: str) -> Dict[str, object]:
    """One job's ``log-meta.txt`` as the reference's ``parse_meta`` flattens
    it: the arguments (either package's ``Args:`` form, under the
    reference's names), ``time_start``/``time_end``, ``wall_time_s``,
    ``termination_flag``, ``throughput_vps`` (videos over the wall time),
    each ``Key: k=v`` counter line under the reference's prefix and each
    JSON line under the reference's key."""
    meta: Dict[str, object] = {"job_id": os.path.basename(
        job_dir.rstrip("/"))}
    with open(os.path.join(job_dir, "log-meta.txt")) as f:
        lines = f.read().splitlines()
    for line in lines:
        head, sep, rest = line.partition(":")
        if head == "Args" and rest.strip().startswith("{"):
            args = json.loads(rest)
            args.setdefault("batch_size", 1)
            meta.update((_ARG_NAMES.get(k, k), v) for k, v in args.items())
        elif head == "Args":
            for key, raw in _NAMESPACE_ARG.findall(line):
                raw = raw.strip()
                meta[key] = (raw[1:-1] if raw[:1] in "'\""
                             else _scalar(raw))
        elif head == "Termination flag":
            meta["termination_flag"] = int(rest)
        elif sep and head in _META_JSON:
            value = json.loads(rest)
            if head == "Autotune buckets":
                value = {key: int(n) for key, n in value.items()}
            meta[_META_JSON[head]] = value
        elif sep and head in _META_PREFIXES:
            prefix = _META_PREFIXES[head]
            for part in rest.split():
                key, _, val = part.partition("=")
                meta[prefix + key] = _scalar(val)
        elif len(line.split()) == 2 and not sep:
            meta["time_start"], meta["time_end"] = map(float, line.split())
    if "time_start" in meta and "time_end" in meta:
        meta["wall_time_s"] = meta["time_end"] - meta["time_start"]
        videos = meta.get("videos")
        if videos and meta["wall_time_s"] > 0:
            meta["throughput_vps"] = videos / meta["wall_time_s"]
    return meta


def frame_rows(frame: Dict[str, np.ndarray]) -> int:
    return len(next(iter(frame.values()))) if frame else 0


def parse_timing_table(path: str) -> Dict[str, np.ndarray]:
    """One timing table -> a frame: stamps float64, ``device*`` columns
    strings, and the producing instance from the file's name. ``#``
    trailer lines are not rows."""
    with open(path) as f:
        header = f.readline().split()
        rows = [line.split() for line in f
                if line.strip() and not line.startswith("#")]
    for row in rows:
        if len(row) != len(header):
            raise ValueError("%s: a row of %d fields under a header of %d"
                             % (path, len(row), len(header)))
    frame = {}
    for idx, col in enumerate(header):
        values = [row[idx] for row in rows]
        frame[col] = (np.array(values, dtype=object)
                      if col.startswith("device")
                      else np.array([float(v) for v in values], dtype=float))
    m = TABLE_NAME.match(os.path.basename(path))
    if m:
        frame["final_device"] = np.array([m.group("device")] * len(rows),
                                         dtype=object)
        frame["final_group"] = np.full(len(rows), int(m.group("group")))
        frame["final_instance"] = np.full(len(rows),
                                          int(m.group("instance")))
    return frame


def concat_frames(frames: List[Dict[str, np.ndarray]]
                  ) -> Dict[str, np.ndarray]:
    """Rows of every frame over the union of their columns, in order of
    first appearance; a column a frame lacks is NaN there (None in a
    string column), and an integer column with gaps turns float."""
    columns: List[str] = []
    for frame in frames:
        columns.extend(c for c in frame if c not in columns)
    out = {}
    for col in columns:
        parts = [f.get(col) for f in frames]
        text = any(p is not None and p.dtype == object for p in parts)
        filled = [p if p is not None else
                  np.full(frame_rows(f), None if text else np.nan,
                          dtype=object if text else float)
                  for p, f in zip(parts, frames)]
        out[col] = np.concatenate(filled) if filled else np.array([])
    return out


def select_rows(frame: Dict[str, np.ndarray], mask
                ) -> Dict[str, np.ndarray]:
    """The rows of ``frame`` where ``mask`` holds, every column kept."""
    return {col: values[mask] for col, values in frame.items()}


def get_data(job_dir: str):
    """One job -> (its :func:`parse_meta` dict, its request frame: every
    final instance's table, each row carrying the job's
    :data:`JOB_COLUMNS`)."""
    meta = parse_meta(job_dir)
    tables = [parse_timing_table(p) for p in timing_tables(job_dir)]
    frame = concat_frames(tables) if tables else {}
    rows = frame_rows(frame)
    for key in JOB_COLUMNS:
        if key in meta:
            value = meta[key]
            frame[key] = (np.array([value] * rows, dtype=object)
                          if isinstance(value, str)
                          else np.full(rows, value))
    return meta, frame


def job_dirs(log_base: str, recursive: bool = False) -> List[str]:
    """The job directories (each holding ``log-meta.txt``) right under
    ``log_base``, or, ``recursive``, anywhere below it, sorted."""
    if not recursive:
        return [os.path.join(log_base, name)
                for name in sorted(os.listdir(log_base))
                if os.path.isfile(os.path.join(log_base, name,
                                               "log-meta.txt"))]
    found = []
    for dirpath, dirnames, filenames in os.walk(log_base):
        dirnames.sort()
        if "log-meta.txt" in filenames and dirpath != log_base:
            found.append(dirpath)
    return sorted(found)


def get_data_from_all_logs(log_base: str = "logs", recursive: bool = False):
    """Every job under ``log_base`` -> (one :func:`parse_meta` dict per
    job, one request frame over all of them), the reference's two-frame
    contract; a job whose files do not parse is left out."""
    metas, frames = [], []
    for job_dir in job_dirs(log_base, recursive):
        try:
            meta, frame = get_data(job_dir)
        except (OSError, ValueError):
            continue
        metas.append(meta)
        if frame_rows(frame):
            frames.append(frame)
    return metas, (concat_frames(frames) if frames else {})


#: the standard 2-stage schema's gaps under their semantic names (the
#: reference's scripts/latency_summary.py decomposition)
STANDARD_COMPONENTS = [
    ("enqueue_filename", "runner0_start", "filename_queue_wait"),
    ("runner0_start", "inference0_start", "runner0_dispatch"),
    ("inference0_start", "inference0_finish", "decode"),
    ("inference0_finish", "runner1_start", "frame_queue_wait"),
    ("runner1_start", "inference1_start", "device_comm"),
    ("inference1_start", "inference1_finish", "neural_net"),
]
#: the trace refinement of the loader span (decode{step}_done,
#: transfer{step}_start/_done); absent columns are skipped
REFINED_COMPONENTS = [
    ("inference0_start", "decode0_done", "decode_only"),
    ("decode0_done", "transfer0_start", "batch_hold"),
    ("transfer0_start", "transfer0_done", "transfer"),
    ("transfer0_done", "inference0_finish", "publish_drain"),
]
_FINISH = re.compile(r"inference(\d+)_finish")
_SUFFIXED_FINISH = re.compile(r"inference(\d+)_finish-\d+")


def dispatch_batch_sizes(frame: Dict[str, np.ndarray],
                         step=None) -> Dict[int, int]:
    """{requests a dispatch carried: dispatches}, sorted by size: the
    constituents of one fused dispatch share their
    ``inference{step}_finish`` stamp, so grouping by it recovers each
    dispatch's size. ``step`` defaults to the last inference step with
    data; a segmented job (suffixed finishes past it) gives {} rather
    than mislabel a loader's stamps."""
    finish_cols = sorted(
        (c for c in frame if _FINISH.fullmatch(c)
         and not np.isnan(frame[c]).all()),
        key=lambda c: int(_FINISH.fullmatch(c).group(1)))
    if step is not None:
        col = "inference%d_finish" % step
        if col not in frame or np.isnan(frame[col]).all():
            raise ValueError("no data for %r; columns with data: %r"
                             % (col, finish_cols))
    else:
        if not finish_cols:
            return {}
        last = int(_FINISH.fullmatch(finish_cols[-1]).group(1))
        if any(_SUFFIXED_FINISH.fullmatch(c)
               and int(_SUFFIXED_FINISH.fullmatch(c).group(1)) > last
               for c in frame):
            return {}
        col = finish_cols[-1]
    values = frame[col][~np.isnan(frame[col])]
    _stamps, per_dispatch = np.unique(values, return_counts=True)
    sizes, dispatches = np.unique(per_dispatch, return_counts=True)
    return {int(s): int(n) for s, n in zip(sizes, dispatches)}


def time_columns(frame: Dict[str, np.ndarray]) -> List[str]:
    """The frame's float columns that are times: not ``device*`` and not
    an instance's group or index (the reference's rule)."""
    return [c for c in frame if frame[c].dtype == float
            and not c.startswith("device")
            and c not in ("final_group", "final_instance")]


def decompose_latency(frame: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
    """The frame with per-request latency components (ms) added: the
    standard and refined gaps under their names, and every other pair
    of adjacent time columns as ``gap:<prev>-><next>``."""
    cols = time_columns(frame)
    named = set()
    out = dict(frame)
    for prv, nxt, name in STANDARD_COMPONENTS + REFINED_COMPONENTS:
        if prv in cols and nxt in cols:
            out[name] = (frame[nxt] - frame[prv]) * 1000.0
            named.update((prv, nxt))
    for prv, nxt in zip(cols[:-1], cols[1:]):
        if prv in named and nxt in named:
            continue
        out["gap:%s->%s" % (prv, nxt)] = (frame[nxt] - frame[prv]) * 1000.0
    return out


def _row_timings(frame: Dict[str, np.ndarray], num_skips: int = 0):
    """{stamp: time} of each row of one table's frame past ``num_skips``
    (NaN holes dropped), rows with fewer than two stamps left out."""
    cols = [c for c in frame if not c.startswith("device")
            and c not in IDENTITY_COLUMNS]
    for idx in range(num_skips, frame_rows(frame)):
        timings = {c: float(frame[c][idx]) for c in cols
                   if frame[c][idx] == frame[c][idx]}
        if len(timings) >= 2:
            yield timings


def _phase_rows(frame: Dict[str, np.ndarray], num_skips: int = 0):
    """``(phases, e2e_ms)`` per row of :func:`_row_timings` (the
    reference's ``_df_phase_rows``)."""
    for timings in _row_timings(frame, num_skips):
        e2e_ms = (max(timings.values()) - min(timings.values())) * 1e3
        yield attribute_phases(timings), e2e_ms


def table_phase_samples(path: str, num_skips: int = 0
                        ) -> Dict[str, List[float]]:
    """{phase: [ms a request]} over one timing table's rows past
    ``num_skips``: the stamp-only decomposition, so any past log works."""
    samples: Dict[str, List[float]] = {}
    for phases, _e2e in _phase_rows(parse_timing_table(path), num_skips):
        for phase, ms in phases.items():
            samples.setdefault(phase, []).append(ms)
    return samples


def _job_phase_rows(job_dir: str, num_skips: int):
    """:func:`_phase_rows` of every table of a job, each table's first
    ``num_skips`` rows left out."""
    for path in timing_tables(job_dir):
        yield from _phase_rows(parse_timing_table(path), num_skips)


def job_phase_samples(job_dir: str, num_skips: int = 0):
    """(per-phase samples, per-request end-to-end ms) over every table of
    a job; each request's end-to-end from its own row."""
    merged: Dict[str, List[float]] = {}
    e2e: List[float] = []
    for phases, e2e_ms in _job_phase_rows(job_dir, num_skips):
        for phase, ms in phases.items():
            merged.setdefault(phase, []).append(ms)
        e2e.append(e2e_ms)
    return merged, e2e


def attribute_job(job_dir: str, num_skips=None
                  ) -> Dict[str, Dict[str, float]]:
    """{phase: {mean_ms, p99_ms, count}} over every table's rows past
    ``num_skips`` (default :data:`NUM_SUMMARY_SKIPS`): the ``Phases:``
    line's rule, from the tables alone (the reference's name for
    :func:`attribute`'s phases)."""
    return attribute(job_dir, NUM_SUMMARY_SKIPS if num_skips is None
                     else num_skips)["phases"]


# -- critical-path explanation (--explain) ------------------------------------

def _job_lanes(job_dir: str) -> Dict[int, int]:
    """{step: instances} from the config copy in the job directory, by
    whatif's reader and lane rule; {} without a copy."""
    raw = whatif_mod.job_config(job_dir)
    if raw is None:
        return {}
    return {step: int(info["lanes"]) for step, info
            in whatif_mod.steps_info_from_config(raw).items()}


def recompute_critpath(job_dir: str, num_skips: int):
    """The ``Critpath:`` aggregation over every table's rows past
    ``num_skips``, from the files alone (hedge and redispatch stamps are
    not in the tables); None where no row decomposes."""
    def rows():
        for path in timing_tables(job_dir):
            try:
                frame = parse_timing_table(path)
            except (OSError, ValueError):
                continue
            for timings in _row_timings(frame, num_skips):
                yield (timings, False, 0)
    return critpath.aggregate(rows(), _job_lanes(job_dir))


def print_explanation(job_dir: str, out=None) -> int:
    """``--explain``: the ranked blocked time per (class, step), each
    stage's critical-path bound and the stage that caps, and, where the
    job streamed metrics, the calibrated what-if counterfactuals, all
    from the job's files (the reference's text). 0, or 1 where a chain
    misses its request's latency by over 1 ms or nothing decomposes."""
    out = out or sys.stdout
    report = recompute_critpath(job_dir, NUM_SUMMARY_SKIPS)
    if report is None:
        report = recompute_critpath(job_dir, 0)
        if report is None:
            out.write("%s: no completed request decomposes into a "
                      "blocking chain\n" % job_dir)
            return 1
        out.write("%s: fewer rows than the steady-state skip — "
                  "explaining over every completed request\n" % job_dir)
    out.write("%s: blocking-chain attribution over %d request(s)\n"
              % (job_dir, report["requests"]))
    out.write("  ranked blocked time (segment = <class><step>):\n")
    ranked = critpath.ranking(report["stage_detail"])
    total_all = sum(total for _seg, total, _mean in ranked) or 1.0
    for seg, total, mean in ranked:
        out.write("    %-18s %10.2f ms total  %8.3f ms/req  (%4.1f%%)\n"
                  % (seg, total, mean, 100.0 * total / total_all))
    out.write("  per-stage critical-path throughput bound "
              "(lanes x requests / occupied s):\n")
    for step_key in sorted(report["stage_detail"]):
        entry = report["stage_detail"][step_key]
        out.write("    %-8s lanes=%d occupied=%.1f ms  bound=%.3f "
                  "videos/s%s\n"
                  % (step_key, entry["lanes"], entry["occupied_ms"],
                     entry["bound_vps"],
                     "  <- binding" if "step%d" % report["bound_step"]
                     == step_key else ""))
    out.write("  partition residual: worst %d us per request "
              "(must stay <= 1000)\n" % report["residual_us_max"])
    meta = parse_meta(job_dir)
    status = 0
    if "critpath_requests" in meta \
            and meta["critpath_requests"] != report["requests"]:
        out.write("  WARNING: log-meta 'Critpath:' counts %s request(s) "
                  "but the tables recompute %d\n"
                  % (meta["critpath_requests"], report["requests"]))
        status = 1
    model = whatif_mod.calibrate_job(job_dir)
    if model is not None and model.calibrated:
        vps, bottleneck = model.predict_throughput()
        out.write("  what-if (calibrated from metrics.jsonl + config "
                  "copy):\n")
        out.write("    self-predicted %.3f videos/s, bottleneck step%d\n"
                  % (vps, bottleneck))
        for label, spec in (
                ("replicas+1 on the bottleneck",
                 {"replicas": {bottleneck: "+1"}}),
                ("service x0.5 on the bottleneck",
                 {"service_scale": {bottleneck: 0.5}}),
                ("arrival x1.5", {"arrival_scale": 1.5})):
            answer = model.query(spec)
            out.write("    %-32s -> %.3f videos/s (%.2fx)\n"
                      % (label, answer["pred_vps"], answer["vps_ratio"]))
    return max(status, 0 if report["residual_us_max"] <= 1000 else 1)


def print_stamp_registry(out=None) -> None:
    """``--stamps``: the port's telemetry schema (stamps, content stamps,
    log-meta lines, table trailers, trace events, live-metric series and
    memory owners), in the reference's layout."""
    from rnb_tpu_torch.memledger import MEM_OWNER_REGISTRY
    from rnb_tpu_torch.telemetry import (CONTENT_STAMPS, META_LINE_REGISTRY,
                                         METRIC_REGISTRY, STAMP_REGISTRY,
                                         TABLE_TRAILER_REGISTRY,
                                         TRACE_EVENT_REGISTRY)
    out = out or sys.stdout
    out.write("# Telemetry schema reference (generated by "
              "parse_utils.py --stamps)\n")
    out.write("# Source of truth: rnb_tpu_torch/telemetry.py registries; "
              "cross-checked by the port's rnb-lint.\n\n")
    out.write("## TimeCard stamps ({step} = pipeline step index; merged "
              "segment\n## cards suffix post-fork stamps with -{sub_id})\n")
    for spec in STAMP_REGISTRY:
        out.write("%-26s %-22s %s\n" % (spec.pattern, spec.producer,
                                        spec.description))
    out.write("\n## Content stamps (TimeCard attributes that survive "
              "fork/merge)\n")
    out.write("%s\n" % " ".join(CONTENT_STAMPS))
    out.write("\n## log-meta.txt lines (plus one bare '<start> <end>' "
              "timestamp line)\n")
    for spec in META_LINE_REGISTRY:
        out.write("%-26s %-22s %s\n" % (spec.pattern, spec.producer,
                                        spec.description))
    out.write("\n## Timing-table trailers ('# <kind> ...')\n")
    for spec in TABLE_TRAILER_REGISTRY:
        out.write("%-26s %-22s %s\n" % (spec.pattern, spec.producer,
                                        spec.description))
    out.write("\n## Trace events (logs/<job>/trace.json, trace-enabled "
              "runs only;\n## {step} = pipeline-step or queue index)\n")
    for spec in TRACE_EVENT_REGISTRY:
        out.write("%-26s %-22s %s\n" % (spec.pattern, spec.producer,
                                        spec.description))
    out.write("\n## Live-metric series (logs/<job>/metrics.jsonl + "
              "metrics.prom,\n## metrics-enabled runs only; kind/source "
              "per rnb_tpu_torch.telemetry.MetricSpec)\n")
    for spec in METRIC_REGISTRY:
        out.write("%-26s %-10s %-7s %s\n" % (spec.pattern, spec.kind,
                                              spec.source, spec.description))
    out.write("\n## HBM-ledger owners (the 'Memory owners:' line's keys,\n"
              "## devobs-enabled runs only; declared in "
              "rnb_tpu_torch.memledger)\n")
    for spec in MEM_OWNER_REGISTRY:
        out.write("%-26s %-22s %s\n" % (spec.name, spec.producer,
                                        spec.description))


def _mean(values: List[float]):
    return sum(values) / len(values) if values else None


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if "--stamps" in args:
        print_stamp_registry()
        return 0
    check = "--check" in args
    explain = "--explain" in args
    log_dirs = [a for a in args if a not in ("--check", "--explain")]
    if "--attribute" in log_dirs:
        log_dirs.remove("--attribute")
        for log_dir in log_dirs:
            print(json.dumps(dict(log_dir=log_dir, **attribute(log_dir))))
        return 0 if log_dirs else 2
    if not log_dirs:
        print(__doc__)
        return 2
    status = 0
    if explain:
        for log_dir in log_dirs:
            status = max(status, print_explanation(log_dir))
        if not check:
            # the reference's flags compose: --explain alone runs no check
            return status
    failed = unreadable = False
    for log_dir in log_dirs:
        problems, parse_failed = check_job_detail(log_dir)
        if not parse_failed and "window" in read_meta(
                os.path.join(log_dir, "log-meta.txt")):
            print(json.dumps(summarize(log_dir)))
        for problem in problems:
            print("%s: %s" % (log_dir, problem), file=sys.stderr)
        failed = failed or bool(problems)
        unreadable = unreadable or parse_failed
    # 2: the checker could not read a job; 1: an invariant does not hold
    return max(status, 2 if unreadable else 1 if failed else 0)


if __name__ == "__main__":
    sys.exit(main())
