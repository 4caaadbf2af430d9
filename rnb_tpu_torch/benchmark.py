"""Benchmark controller: build the pipeline, drive it, report.

Counterpart of ``rnb_tpu/benchmark.py``. ``run_benchmark`` reads one
of the repo's pipeline configs, starts a client thread and one
executor thread per (step, group, device), opens the measured window
at the start barrier (after every stage built its weights and warmed
up), and closes it when the final step has completed ``num_videos``
requests. It writes ``logs/<job>/log-meta.txt`` and one timing table
per final-step instance, and returns a :class:`BenchmarkResult`.

With the root ``trace`` key the run is traced (:mod:`rnb_tpu_torch.trace`):
the tracer is installed at the start barrier, its sampler reads the
queue depths and the loaders' occupancy, and ``trace.json`` is written
into the job's log directory beside a ``Trace: events=N dropped=M`` and a
``Phases:`` log-meta line. With ``RNB_HOST_PROFILE`` set, the host
profiler's sections over the window go to ``hostprof.txt`` with the
process's CPU share of the window (``host_cpu_frac``).

With the root ``metrics`` key the live-metrics plane runs
(:mod:`rnb_tpu_torch.metrics`): its registry takes the queue depths, the
page allocator and every stage's cache and staging pool as sources, its
SpanBridge takes the tracer's place in the trace hooks at the start
barrier (forwarding to the tracer on a traced run), and its flusher
writes ``metrics.jsonl``, ``metrics.prom`` and any ``flight-<n>.json``
into the job's directory, with ``Metrics:`` and ``Slo:`` lines. The root
``critpath`` key adds ``Critpath:``/``Critpath stages:`` and the
``# critpath`` table trailer (:mod:`rnb_tpu_torch.critpath`); the root
``autotune`` key gives every supporting stage a batch controller
(:mod:`rnb_tpu_torch.autotune`) and adds ``Autotune:``/``Autotune
buckets:``. The root ``devobs`` key runs the device observability plane
(:mod:`rnb_tpu_torch.devobs`): bounded ``devobs-capture-<n>.txt``
windows merged into ``trace.json`` as ``device:<plane>`` tracks, the
per-stage compute meters behind ``Compute:``/``Compute stages:`` and the
footprint ledger (:mod:`rnb_tpu_torch.memledger`) behind
``Memory:``/``Memory owners:``. The root ``whatif`` key calibrates the
queueing what-if model (:mod:`rnb_tpu_torch.whatif`) from the final
metrics snapshot into ``Whatif:``; the root ``operator`` key serves the
live registries over a loopback HTTP server (:mod:`rnb_tpu_torch.statusz`,
its address in ``operator.json``, its request ledger in ``Operator:``)
and samples the pipeline threads' stacks (:mod:`rnb_tpu_torch.stacksampler`:
``stacks.folded``, ``Stacks:``, ``stacks:<role>`` tracks in a traced
run's ``trace.json``); either key drops a copy of the config into the
job directory, which ``parse_utils`` recomputes ``Whatif:`` from.
Without those keys none of it runs and no line or file is added. Every
exit path, an aborted run included, leaves no hook installed, no flusher
running and no server bound.

Fault containment (:mod:`rnb_tpu_torch.faults`, the reference's wiring):
every run keeps a :class:`~rnb_tpu_torch.control.FaultStats` ledger shared
by the client and the executors and writes ``Faults:`` (with ``Failure
reasons:``, ``Shed sites:`` and ``Queue overflows:`` when they have
entries, and ``failed-requests.txt``, one line per dead letter). The root
``fault_plan`` key (or the ``RNB_FAULT_PLAN`` env JSON, which wins) is
the injection schedule; the root ``deadline`` key stamps each request's
deadline and adds ``Deadline:``/``Deadline sites:``. Latency percentiles
and throughput count successes only.

The root ``netedge`` key puts the network ingest edge in front of step 0
(:mod:`rnb_tpu_torch.netedge`): a spawned peer process serves step 0 over
TCP on the run's platform, its dispatcher takes the filename queue, the
local step-0 executors serve the fallback off an interposed queue, and
the receiver injects the peer's rows into step 0's out queue. The edge's
lane board takes the root ``health`` key's thresholds (the defaults
without it). log-meta gains ``Net:``, ``Net errors:``, ``Health:`` and
``Health lanes:``; the metrics plane polls ``net.*`` and ``health.*``.
With ``netedge.enabled: false`` nothing of it runs and the logs are those
of the config without the key. The peer is stopped on every exit path.

Replica lanes (a step's ``replicas`` key, or an apply-mode ``placement``
plan): each replicated step gets one shared
:class:`~rnb_tpu_torch.handoff.InflightDepths` for its producers'
``ReplicaSelector``, and, under the root ``health`` key, one
:class:`~rnb_tpu_torch.health.LaneHealthBoard` (``Health:``, ``Health
lanes:``, served on ``/healthz``); a step's ``hedge_ms`` adds a
:class:`~rnb_tpu_torch.health.HedgeGovernor` (``Hedge:``). The root
``handoff`` key accounts every consumer take (``Handoff:``, ``Handoff
edges:``), and the root ``placement`` key turns the executors' measured
costs into ``Placement:`` over the run's device budget, its card count
(one device on the CPU).

Runs on ``cuda:0`` (the config's devices) unless ``platform="cpu"``.

CLI::

    python -m rnb_tpu_torch.benchmark -c configs/rnb-fused-yuv-big.json \\
        -mi 0 -v 48            # bulk mode, 48 requests, on the card
    python -m rnb_tpu_torch.benchmark --check -c CONFIG   # posture only
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import resource
import shutil
import sys
import threading
import time
from dataclasses import asdict, dataclass, field
from datetime import datetime
from typing import Any, Dict, Optional

import torch

from rnb_tpu_torch import devobs as devobs_mod
from rnb_tpu_torch import hostprof
from rnb_tpu_torch import lockwitness
from rnb_tpu_torch import memledger as memledger_mod
from rnb_tpu_torch import metrics as metrics_mod
from rnb_tpu_torch import profiler as profiler_mod
from rnb_tpu_torch import trace as trace_mod
from rnb_tpu_torch import whatif as whatif_mod
from rnb_tpu_torch.arg_utils import nonnegative_int, positive_int
from rnb_tpu_torch.autotune import AutotuneSettings
from rnb_tpu_torch.autotune import aggregate_snapshots as aggregate_autotune
from rnb_tpu_torch.cache import aggregate_snapshots
from rnb_tpu_torch.critpath import CritpathSettings
from rnb_tpu_torch.critpath import aggregate as critpath_aggregate
from rnb_tpu_torch.critpath import ranking as critpath_ranking
from rnb_tpu_torch.client import bulk_client, poisson_client
from rnb_tpu_torch.compilestats import aggregate_compile_records
from rnb_tpu_torch.config import load_config
from rnb_tpu_torch.control import (NUM_EXIT_MARKERS, EdgeTracker,
                                   FaultStats, InferenceCounter,
                                   RingCredits, TerminationState)
from rnb_tpu_torch.devices import probe_busy_devices
from rnb_tpu_torch.faults import LANE_KINDS, FaultPlan
from rnb_tpu_torch.handoff import HandoffSettings, InflightDepths
from rnb_tpu_torch.handoff import aggregate_snapshots as aggregate_handoff
from rnb_tpu_torch.health import (DeadlineSettings, DeadlineStats,
                                  HealthSettings, HedgeGovernor,
                                  LaneHealthBoard, aggregate_board_snapshots,
                                  aggregate_hedge_snapshots)
from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.ops.ragged import RaggedSettings
from rnb_tpu_torch.netedge import (NET_LANE, PEER_EXIT_S, NetEdgeClient,
                                   NetEdgeSettings, NetStats, spawn_peer,
                                   stop_peer)
from rnb_tpu_torch.pager import Pager, PagerSettings
from rnb_tpu_torch.parallel import distributed
from rnb_tpu_torch.placement import PlacementSettings, build_report
from rnb_tpu_torch.runner import (NUM_SUMMARY_SKIPS, RunnerContext,
                                  finish_outputs, runner)
from rnb_tpu_torch.stacksampler import StackSampler
from rnb_tpu_torch.statusz import OperatorServer, OperatorSettings
from rnb_tpu_torch.telemetry import latency_percentiles, logmeta, logroot
from rnb_tpu_torch.utils.class_utils import load_class

#: the JSON files a job writes itself, which its config copy must not
#: replace
JOB_FILES = ("operator.json", "trace.json", "profile.json")
#: a stage that has not reached a barrier after this long is hung
BARRIER_TIMEOUT_S = 1800.0
#: the ``Pages:`` line's counters, in the reference's order
PAGES_LINE_KEYS = ("arenas", "pages", "page_rows", "live", "limbo", "bytes",
                   "allocs", "frees", "alloc_fails", "gathers",
                   "gather_rows", "feature_lookups", "feature_hits",
                   "feature_inserts", "feature_evictions",
                   "feature_gathers", "feature_gather_rows",
                   "feature_bytes_saved", "feature_entries",
                   "bypassed_batches")
#: the ``Ragged:`` line's counters, in the reference's order
RAGGED_LINE_KEYS = ("pool_rows", "emissions", "rows", "pad_rows_eliminated",
                    "cache_hit_rows")


@dataclass
class BenchmarkResult:
    job_id: str
    total_time_s: float
    num_videos: int
    termination_flag: int
    throughput_vps: float
    log_dir: str
    #: device name (torch.cuda.get_device_name) or "cpu"
    device: str = "cpu"
    p50_latency_ms: Optional[float] = None
    p99_latency_ms: Optional[float] = None
    clips_completed: int = 0
    num_completed: int = 0
    pad_rows: int = 0
    total_rows: int = 0
    pad_emissions: int = 0
    #: kernel launches inside the measured window, by kernel name
    window_launches: Dict[str, int] = field(default_factory=dict)
    #: sum of device kernel time in the window (profiled runs only)
    kernel_ms: Optional[float] = None
    #: clip-cache counters summed over the loaders (all zero without
    #: ``cache_mb``): the ``Cache:`` log-meta line
    cache_hits: int = 0
    cache_misses: int = 0
    cache_inserts: int = 0
    cache_evictions: int = 0
    cache_coalesced: int = 0
    cache_oversize: int = 0
    cache_bytes_resident: int = 0
    #: the ``Ragged:`` line over every ragged batching stage (all zero
    #: without the root ``ragged`` key): the largest pool, emissions,
    #: valid rows, pad rows a bucket would have shipped, and rows ragged
    #: cache hits served into pools
    ragged_pool_rows: int = 0
    ragged_emissions: int = 0
    ragged_rows: int = 0
    ragged_pad_rows_eliminated: int = 0
    ragged_cache_hit_rows: int = 0
    #: the ``Pages:`` log-meta line's counters (empty without ``pager``)
    pages: Dict[str, int] = field(default_factory=dict)
    #: ``{step: {warmup, steady_new, steady_calls}}``: input signatures
    #: per step (the ``Compiles:`` line)
    compiles: Dict[str, dict] = field(default_factory=dict)
    #: ``{step: seconds}`` of stage construction (the ``Warmup:`` line)
    warmup_s: Dict[str, float] = field(default_factory=dict)
    #: ``{step: {graphs, capture_s, replays}}``: captured forwards (the
    #: ``Graphs:`` line; empty off the card)
    graphs: Dict[str, dict] = field(default_factory=dict)
    #: events written to ``trace.json`` and dropped at the cap (0 and 0
    #: on an untraced run): the ``Trace:`` line
    trace_events: int = 0
    trace_dropped: int = 0
    #: ``{phase: {mean_ms, p99_ms, count}}`` on traced runs (``Phases:``)
    phases: Optional[Dict[str, dict]] = None
    #: process CPU seconds (user + system) over the measured window
    host_cpu_s: float = 0.0
    #: requests the client created (an open-loop client may create more
    #: than complete before the run stops)
    num_requests: int = 0
    #: the ``Metrics:`` and ``Slo:`` lines (zero without ``metrics``)
    metrics_snapshots: int = 0
    metrics_series: int = 0
    metrics_dumps: int = 0
    metrics_triggers: int = 0
    slo_tracked: int = 0
    slo_within: int = 0
    slo_missed: int = 0
    slo_burn_max_milli: int = 0
    #: the ``Critpath:`` and ``Critpath stages:`` lines (zero and empty
    #: without ``critpath``)
    critpath_requests: int = 0
    critpath_segments: int = 0
    critpath_residual_us_max: int = 0
    critpath_hedged: int = 0
    critpath_redispatched: int = 0
    critpath_bound_step: int = 0
    critpath_bound_vps_milli: int = 0
    critpath_stage_detail: Dict[str, Any] = field(default_factory=dict)
    #: the ``Autotune:`` and ``Autotune buckets:`` lines (zero and empty
    #: without ``autotune``)
    autotune_decisions: int = 0
    autotune_immediate: int = 0
    autotune_held: int = 0
    autotune_emissions: int = 0
    autotune_deadline_us_min: int = 0
    autotune_deadline_us_max: int = 0
    autotune_deadline_us_sum: int = 0
    autotune_bucket_counts: Dict[str, int] = field(default_factory=dict)
    #: the fault ledger (the ``Faults:``, ``Failure reasons:``, ``Shed
    #: sites:`` and ``Queue overflows:`` lines): dead-lettered and shed
    #: requests, transient retries, per-reason and per-site counts
    num_failed: int = 0
    num_shed: int = 0
    num_retries: int = 0
    failure_reasons: Dict[str, int] = field(default_factory=dict)
    shed_sites: Dict[str, int] = field(default_factory=dict)
    queue_overflows: Dict[str, int] = field(default_factory=dict)
    #: the ``Deadline:`` and ``Deadline sites:`` lines (zero and empty
    #: without ``deadline``)
    deadline_budget_ms: int = 0
    deadline_expired: int = 0
    deadline_sites: Dict[str, int] = field(default_factory=dict)
    #: the ``Compute:`` line (zero without ``devobs``): metered stages,
    #: dispatches, valid rows, achieved FLOPs, the window in us, the job
    #: TFLOP/s and MFU in milli / 1e-4 units (mfu_e4 -1 where the card's
    #: peak is unknown) and the capture windows taken
    compute_stages: int = 0
    compute_dispatches: int = 0
    compute_rows: int = 0
    compute_flops_total: int = 0
    compute_window_us: int = 0
    compute_tflops_milli: int = 0
    compute_mfu_e4: int = 0
    compute_captures: int = 0
    #: capture windows refused: over the budget, or another profiler
    #: session (``--profile``, ``--xprof``) held the profiler
    compute_captures_skipped: int = 0
    #: the ``Compute stages:`` line: per-stage rows, dispatches,
    #: flops_per_row, busy_us, tflops_busy, mfu_busy, ai_flops_per_byte
    compute_stage_detail: Dict[str, Any] = field(default_factory=dict)
    #: the ``Memory:`` line (zero without ``devobs``): owners and devices
    #: seen, final and peak bytes, the watermark and its crossings, the
    #: allocator's bytes and the reconcile verdict
    memory_owners: int = 0
    memory_devices: int = 0
    memory_total_bytes: int = 0
    memory_peak_bytes: int = 0
    memory_watermark_bytes: int = 0
    memory_watermark_hits: int = 0
    memory_live_bytes: int = 0
    memory_reconciled: int = 0
    #: the ``Memory owners:`` line: {owner: {bytes, peak_bytes}}
    memory_owner_detail: Dict[str, Any] = field(default_factory=dict)
    #: intra-stage shard accounting (the step ``shard`` key), summed over
    #: every declared-degree stage (the ``Shard:`` line): steps, the
    #: largest degree, the merge gathers, their host-timed microseconds
    #: and the valid rows that crossed a sharded stage
    shard_steps: int = 0
    shard_max_degree: int = 0
    shard_gathers: int = 0
    shard_collective_us: int = 0
    shard_rows: int = 0
    #: per-step shard detail (the ``Shard steps:`` line): degree, axis,
    #: merge counters, projected and budget MiB, smallest feasible degree
    shard_step_detail: Dict[str, Any] = field(default_factory=dict)
    #: the ``Whatif:`` line (zero and -1 without ``whatif``): stages the
    #: model calibrated, whether it calibrated, its predicted throughput
    #: in milli videos/s and its bottleneck step
    whatif_stages: int = 0
    whatif_calibrated: int = 0
    whatif_pred_vps_milli: int = 0
    whatif_bottleneck_step: int = 0
    #: the ``Operator:`` line (zero without ``operator``): GET requests
    #: served, POST actions accepted, POST actions denied by the
    #: ``allow_actions`` gate, request errors
    operator_scrapes: int = 0
    operator_actions: int = 0
    operator_denied: int = 0
    operator_errors: int = 0
    #: the ``Stacks:`` line (zero without ``operator.sample_hz`` > 0):
    #: sampling ticks, thread roles, distinct folded stacks, samples
    stacks_samples: int = 0
    stacks_threads: int = 0
    stacks_folded: int = 0
    stacks_total: int = 0
    #: the edge contract's ledger (the ``Handoff:`` and ``Handoff
    #: edges:`` lines; zero without ``handoff``): every consumer take,
    #: d2d or through host memory, and the bytes each class moved
    handoff_edges: int = 0
    handoff_d2d_edges: int = 0
    handoff_host_edges: int = 0
    handoff_d2d_bytes: int = 0
    handoff_host_bytes: int = 0
    handoff_edge_detail: Dict[str, Dict[str, int]] = field(
        default_factory=dict)
    #: the ``Placement:`` line's report (empty without ``placement``)
    placement: Dict[str, Any] = field(default_factory=dict)
    #: lane health accounting (the ``Health:`` and ``Health lanes:``
    #: lines): every replica step's board and the network edge's;
    #: routes_after_open must stay 0
    health_lanes: int = 0
    health_transitions: int = 0
    health_opens: int = 0
    health_evictions: int = 0
    health_probes: int = 0
    health_redispatches: int = 0
    health_routes_after_open: int = 0
    health_lane_detail: Dict[str, Any] = field(default_factory=dict)
    #: hedged re-dispatch (the ``Hedge:`` line; zero without
    #: ``hedge_ms``): fired, won by the hedge copy, lost to the original,
    #: and the losers' service in ms; won + lost == fired
    hedges_fired: int = 0
    hedges_won: int = 0
    hedges_lost: int = 0
    hedges_wasted_ms: int = 0
    #: the network edge's ledger (the ``Net:`` and ``Net errors:`` lines;
    #: zero without ``netedge``)
    net_frames_sent: int = 0
    net_frames_acked: int = 0
    net_resent_pending: int = 0
    net_resends: int = 0
    net_beats: int = 0
    net_reconnects: int = 0
    net_remote: int = 0
    net_local: int = 0
    net_dedup_drops: int = 0
    net_dup_arrivals: int = 0
    net_wire_bytes: int = 0
    net_frame_bytes: int = 0
    net_window_stranded: int = 0
    net_open_before_timeout: int = 0
    net_err_total: int = 0
    net_err_refused: int = 0
    net_err_reset: int = 0
    net_err_timeout: int = 0
    net_err_partial_frame: int = 0
    net_err_corrupt: int = 0
    #: the lock-order witness's ledger (the ``Locks:`` line; zero
    #: without the root ``lint: {"lock_witness": true}`` key): witnessed
    #: locks, acquisitions, distinct order edges, violations
    locks_tracked: int = 0
    locks_acquires: int = 0
    locks_edges: int = 0
    locks_violations: int = 0


def aggregate_shard(shard_sink) -> Dict[str, Any]:
    """The ``Shard:`` totals and the ``Shard steps:`` detail from the
    stages' ``(step_idx, shard_stats)``, as the reference sums them:
    instances of one step add their counters, the static facts (degree,
    axis, budgets) are the step's."""
    per_step: Dict[int, Dict[str, Any]] = {}
    for step_idx, snap in shard_sink:
        row = per_step.setdefault(step_idx, {
            "degree": int(snap.get("degree", 1)),
            "axis": str(snap.get("axis", "")),
            "gathers": 0, "collective_us": 0, "rows": 0,
            "budget_mb": round(float(snap.get("budget_mb") or 0.0), 3),
            "projected_mb": round(float(snap.get("projected_mb", 0.0)), 3),
            "min_degree": int(snap.get("min_degree", 0)),
        })
        row["gathers"] += int(snap.get("gathers", 0))
        row["collective_us"] += int(round(
            float(snap.get("collective_ms", 0.0)) * 1e3))
        row["rows"] += int(snap.get("rows", 0))
    return {
        "steps": len(per_step),
        "max_degree": max(r["degree"] for r in per_step.values()),
        "gathers": sum(r["gathers"] for r in per_step.values()),
        "collective_us": sum(r["collective_us"] for r in per_step.values()),
        "rows": sum(r["rows"] for r in per_step.values()),
        "step_detail": {str(k): per_step[k] for k in sorted(per_step)},
    }


def _resolve_fault_plan(config, netedge: bool, boards: bool,
                        print_progress: bool):
    """The run's fault plan (the ``RNB_FAULT_PLAN`` env JSON over the
    config's ``fault_plan``), or None; a plan no path of the run can
    contain (lane faults without a replica step's health board, net
    faults without an enabled ``netedge``) is refused with the
    reference's messages."""
    plan = FaultPlan.resolve(config.fault_plan)
    if plan is None:
        return None
    # an env plan bypassed the config reader's step check
    plan.check_steps(config.num_steps)
    if not boards and any(f["kind"] in LANE_KINDS for f in plan.faults):
        raise ValueError(
            "the fault plan injects replica_crash/replica_stall but the "
            "config has no enabled root 'health' key (or no replica "
            "lanes) — lane deaths need the health layer's eviction/drain "
            "machinery to stay contained")
    if plan.has_net_faults() and not netedge:
        raise ValueError(
            "the fault plan injects net_* faults but the config has no "
            "enabled root 'netedge' key — there is no network edge to "
            "address")
    if print_progress:
        print("[rnb-tpu-torch] fault plan active: %s" % plan.describe())
    return plan


def device_budget(platform: str) -> int:
    """The placement planner's device budget: the cards this process
    sees (the reference's ``len(jax.devices())``), one on the CPU."""
    return torch.cuda.device_count() if platform == "cuda" else 1


def _bulk_queue_size(config, num_videos: int) -> int:
    """A bulk run's queue capacity: every request pre-enqueued, times
    the segments each step fans an item into, plus the exit markers
    that share the queues (the reference's rule)."""
    seg_factor = 1
    for step in config.steps:
        seg_factor *= step.num_segments
    return (num_videos * seg_factor + config.num_runners
            + max(NUM_EXIT_MARKERS, config.num_runners) + 1)


def _start_tracer(config, filename_queue, queues):
    """The job's tracer (None untraced), with the queue-depth counters
    it samples: the filename queue and every inter-stage queue, keyed by
    its edge ordinal in step order."""
    settings = trace_mod.TraceSettings.from_config(config.trace)
    if settings is None:
        return None
    tracer = trace_mod.Tracer(settings)
    tracer.add_counter_source(trace_mod.name("queue.filename.depth"),
                              filename_queue.qsize)
    edge_idx = 0
    for step_idx in sorted(queues):
        for q_idx in sorted(queues[step_idx]):
            tracer.add_counter_source(
                trace_mod.name("queue.e%d.depth", edge_idx),
                queues[step_idx][q_idx].qsize)
            edge_idx += 1
    return tracer


def _start_metrics(config, job_id: str, log_base: str, queue_probes, pager,
                   tracer, slo_budget_ms, fault_stats, deadline_stats,
                   governors, boards):
    """The job's live-metrics registry and its SpanBridge (None, None
    without the root ``metrics`` key). Its gauge sources are the queue
    depths of ``queue_probes`` (each armed for the saturation trigger at
    the queue's capacity); the fault ledger, the deadline ledger, the
    hedge governors, the replica steps' health boards and the page
    allocator are poll sources. The bridge forwards to ``tracer`` on a
    traced run."""
    settings = metrics_mod.MetricsSettings.from_config(config.metrics)
    if settings is None:
        return None, None
    registry = metrics_mod.MetricsRegistry(
        settings, job_dir=logroot(job_id, base=log_base), job_id=job_id,
        slo_budget_ms=slo_budget_ms)
    for probe_name, qsize, capacity in queue_probes:
        registry.add_gauge_source(probe_name, qsize, capacity=capacity)
    registry.add_poll(metrics_mod.snapshot_poll(
        "faults", fault_stats.snapshot,
        counters=("num_failed", "num_shed", "num_retries")))
    if deadline_stats is not None:
        registry.add_poll(metrics_mod.snapshot_poll(
            "deadline", deadline_stats.snapshot, counters=("expired",)))
    for gov in governors:
        # live_counters: snapshot() resolves leftover hedges, which a
        # per-tick poll must never do
        registry.add_poll(metrics_mod.snapshot_poll(
            "hedge", gov.live_counters, counters=("fired", "won", "lost")))
    for board in boards:
        registry.add_poll(metrics_mod.snapshot_poll(
            "health", board.snapshot,
            counters=("transitions", "opens", "evictions", "probes",
                      "redispatches")))
    if pager is not None:
        registry.add_poll(metrics_mod.snapshot_poll(
            "pages", pager.snapshot,
            counters=("allocs", "frees", "alloc_fails", "gathers",
                      "gather_rows", "feature_lookups", "feature_hits",
                      "feature_inserts", "feature_evictions",
                      "feature_gathers", "feature_gather_rows",
                      "feature_bytes_saved"),
            gauges=("live", "limbo", "bytes")))
    bridge = metrics_mod.SpanBridge(
        registry, forward=tracer,
        ring_events=settings.ring_events if settings.flight_enabled else 0)
    registry.bridge = bridge
    return registry, bridge


def _start_devobs(config, job_id: str, log_base: str, registry):
    """The job's device observability plane (None without the root
    ``devobs`` key): a poll source and trigger hook of the metrics
    registry where there is one."""
    settings = devobs_mod.DevObsSettings.from_config(config.devobs)
    if settings is None:
        return None
    plane = devobs_mod.DevObsPlane(
        settings, job_dir=logroot(job_id, base=log_base), job_id=job_id)
    if registry is not None:
        registry.add_poll(plane.metrics_poll)
        registry.trigger_hooks.append(plane.on_trigger)
    return plane


def _warn_if_no_stage_autotunes(config) -> None:
    """Autotune on with no participating stage (every step opted out or
    none supports it) reads like a static run: say so, as the reference
    does."""
    def may_participate(step):
        try:
            return getattr(load_class(step.model), "SUPPORTS_AUTOTUNE",
                           False)
        except Exception:
            return True  # the runner thread reports a bad class path
    if not any(step.autotune and may_participate(step)
               for step in config.steps):
        print("[rnb-tpu-torch] WARNING: autotune is enabled but no "
              "pipeline stage participates (every step opted out or "
              "unsupported) — batching stays static and no Autotune: "
              "telemetry will be emitted", file=sys.stderr)


def _write_xprof(path: str, ops, time_start: float, time_end: float,
                 flush_epoch: float) -> None:
    """The ``--xprof`` artifact in the reference's 4-column format: one
    ``t0_ns t1_ns plane op_name`` line per op (timestamps comparable
    within one plane), after a header that carries the measured window
    in host epoch seconds and the flush epoch the last op maps to."""
    with open(path, "w") as f:
        f.write("# t0_ns t1_ns plane op_name\n")
        f.write("# window_epoch %f %f flush_epoch %f\n"
                % (time_start, time_end, flush_epoch))
        for name, t0, t1, plane in ops:
            f.write("%d %d %s %s\n" % (t0, t1, plane.replace(" ", "_") or "-",
                                       name))


def _pipeline_queues(config, queue_size: int):
    """``{step_idx: {queue_idx: Queue}}`` for every inter-step edge, and
    one EdgeTracker per edge counting its producers."""
    queues, trackers = {}, {}
    for step_idx, step in enumerate(config.steps[:-1]):
        queues[step_idx], trackers[step_idx] = {}, {}
        for group in step.groups:
            for q_idx in group.out_queues:
                queues[step_idx].setdefault(q_idx, queue.Queue(queue_size))
        for q_idx in queues[step_idx]:
            producers = sum(len(g.devices) for g in step.groups
                            if q_idx in g.out_queues)
            consumers = sum(len(g.devices)
                            for g in config.steps[step_idx + 1].groups
                            if g.in_queue == q_idx)
            trackers[step_idx][q_idx] = EdgeTracker(
                producers, max(NUM_EXIT_MARKERS, consumers))
    return queues, trackers


def run_benchmark(config_path: str,
                  mean_interval_ms: int = 3,
                  num_videos: int = 2000,
                  queue_size: int = 50000,
                  log_base: str = "logs",
                  print_progress: bool = True,
                  seed: Optional[int] = None,
                  platform: Optional[str] = None,
                  outputs_sink: Optional[dict] = None,
                  profile: bool = False,
                  stages_sink: Optional[list] = None,
                  xprof: bool = False,
                  batch_size: int = 1,
                  net_rows_sink: Optional[dict] = None) -> BenchmarkResult:
    """Programmatic entry used by the CLI, the tests and chip_smoke.py.
    ``outputs_sink``, when given, receives every request's output rows
    (request id -> (video, float32 array, its cache stamps)).
    ``stages_sink``, when given, receives ``(step_idx, stage)`` for every
    stage built. ``profile`` traces the measured window with
    ``torch.profiler`` (card runs): the sum of
    kernel time lands in the result, each kernel's time and launches in
    ``profile.json``, and the profiler's table in ``profile.txt``.
    ``xprof`` writes the window's device ops to ``xprof-ops.txt`` in the
    reference's 4-column format (``scripts/device_busy.py`` reads it).
    The two hold the one profiler session: pass one of them.
    ``batch_size`` is the reference's ``-b``: recorded in the ``Args:``
    line when it is not 1, read by no stage (as in the reference).
    ``net_rows_sink``, on a netedge run, receives the valid rows of every
    DATA frame whose request id is already a key of it (request id ->
    CPU tensor)."""
    if profile and xprof:
        raise ValueError("profile and xprof each hold the one profiler "
                         "session; pass one of them")
    # stop() of the operator server and the stack sampler, run on every
    # exit path (both are idempotent)
    closers: list = []
    witness_was_on = lockwitness.enabled()
    try:
        return _run_benchmark(
            config_path, mean_interval_ms, num_videos, queue_size, log_base,
            print_progress, seed, platform, outputs_sink, profile,
            stages_sink, xprof, batch_size, net_rows_sink, closers)
    finally:
        for close in closers:
            close()
        if not witness_was_on:
            # a config-armed witness ends with its run: the next run in
            # this process builds plain locks again
            lockwitness.disable()
        # every exit path, an aborted or failed run included: no trace,
        # metrics or devobs hook stays installed, no flusher, worker or
        # profiler session keeps running
        trace_mod.ACTIVE = None
        memledger_mod.ACTIVE = None
        plane, devobs_mod.ACTIVE = devobs_mod.ACTIVE, None
        if plane is not None:
            plane.stop()
        if profile or xprof:
            profiler_mod.flush()
        registry, metrics_mod.ACTIVE = metrics_mod.ACTIVE, None
        if registry is not None:
            registry.stop()


def _queue_probes(filename_queue, queues, queue_size: int):
    """``[(name, qsize, capacity)]`` of the filename queue and every
    inter-stage queue, keyed by edge ordinal in step order: the metrics
    plane's depth gauges and the depths ``/statusz`` shows."""
    probes = [(metrics_mod.name("queue.filename.depth"),
               filename_queue.qsize, queue_size)]
    edge_idx = 0
    for step_idx in sorted(queues):
        for q_idx in sorted(queues[step_idx]):
            probes.append((metrics_mod.name("queue.e%d.depth", edge_idx),
                           queues[step_idx][q_idx].qsize, queue_size))
            edge_idx += 1
    return probes


def _start_operator(config, job_id: str, log_base: str, registry,
                    devobs_plane, queue_probes, termination, window: dict,
                    closers: list, print_progress: bool, boards: dict):
    """The operator plane's server and stack sampler (None, None without
    the root ``operator`` key). The server binds and writes
    ``operator.json`` now; the sampler starts with the measured window.
    ``/healthz`` serves the replica steps' lane boards (``boards``), as
    the reference's does (the network edge's board is not among
    them)."""
    settings = OperatorSettings.from_config(config.operator)
    if settings is None:
        return None, None
    sampler = (StackSampler(settings.sample_hz) if settings.sample_hz > 0
               else None)
    topology = {"steps": [
        {"step": step_idx, "model": step.model, "groups": len(step.groups),
         "instances": sum(len(g.devices) for g in step.groups),
         "replica_lanes": list(step.replica_queues or [])}
        for step_idx, step in enumerate(config.steps)]}
    server = OperatorServer(
        settings, job_dir=logroot(job_id, base=log_base), job_id=job_id,
        metrics_registry=registry, boards=boards, devobs_plane=devobs_plane,
        config_raw=config.raw, topology=topology,
        queue_probes=queue_probes,
        termination=termination, window=window, sampler=sampler)
    if sampler is not None:
        closers.append(sampler.stop)
    closers.append(server.stop)
    server.start()
    if print_progress:
        print("[rnb-tpu-torch] operator server on http://127.0.0.1:%d "
              "(actions %s)" % (server.port, "enabled"
                                if settings.allow_actions else "disabled"))
    return server, sampler


class _NetEdge:
    """One run's network ingest edge: the spawned peer, the lane board,
    the ledger, the local fallback queue and the client."""

    def __init__(self, config_path, config, settings, *, queue_size,
                 inject_queue, filename_queue, num_markers, seed, counter,
                 termination, fault_plan, fault_stats, deadline_stats,
                 num_videos, rows_sink, closers):
        self.peer = None
        closers.append(self.close)
        if settings.spawn:
            self.peer, settings.connect = spawn_peer(
                config_path, settings, config.platform, seed=seed or 0)
        self.board = LaneHealthBoard(
            (NET_LANE,), HealthSettings.from_config(config.health)
            or HealthSettings())
        self.stats = NetStats()
        self.local_queue: "queue.Queue" = queue.Queue(queue_size)
        self.client = NetEdgeClient(
            settings, board=self.board, stats=self.stats,
            fault_plan=fault_plan, fault_stats=fault_stats,
            deadline_stats=deadline_stats, counter=counter,
            num_videos=num_videos, termination=termination,
            filename_queue=filename_queue, local_queue=self.local_queue,
            inject_queue=inject_queue, num_markers=num_markers,
            seed=seed or 0, peer_proc=self.peer, rows_sink=rows_sink)

    def add_polls(self, registry) -> None:
        """The ``net.*`` and ``health.*`` poll sources of the metrics
        plane, as the reference registers them."""
        registry.add_poll(metrics_mod.snapshot_poll(
            "net", self.stats.snapshot,
            counters=("frames_sent", "frames_acked", "resends", "beats",
                      "reconnects", "remote", "local", "dedup_drops",
                      "dup_arrivals", "wire_bytes", "frame_bytes",
                      "err_total"),
            gauges=("peer_depth",)))
        registry.add_poll(metrics_mod.snapshot_poll(
            "health", self.board.snapshot,
            counters=("transitions", "opens", "evictions", "probes",
                      "redispatches")))

    def finish(self, pad_sink: list) -> None:
        """After the stages joined: drain and stop the client (its
        counters are then final), count the shipped emissions' pad rows
        (the peer's own count died with it) and stop the peer, which
        exits by itself after the EOS."""
        self.client.stop()
        pads = self.client.pad_snapshot()
        if pads["emissions"]:
            pad_sink.append(pads)
        if self.peer is not None:
            stop_peer(self.peer, wait_s=(PEER_EXIT_S if self.client.eos_sent
                                         else 0.0))

    def close(self) -> None:
        """Every exit path: no transport thread runs on and no peer
        outlives the run (both are no-ops after :meth:`finish`)."""
        if hasattr(self, "client"):
            self.client.stop(timeout_s=0.0)
        if self.peer is not None:
            stop_peer(self.peer, wait_s=0.0)


def _run_benchmark(config_path, mean_interval_ms, num_videos, queue_size,
                   log_base, print_progress, seed, platform, outputs_sink,
                   profile, stages_sink, xprof, batch_size, net_rows_sink,
                   closers) -> BenchmarkResult:
    # a multi-process launch (RNB_TPU_COORDINATOR ...) is joined here,
    # before the first device touch, and every process serves the whole
    # config, as the reference does; a join that fails raises
    distributed.maybe_initialize()
    config = load_config(config_path, platform)
    # the reference's contention probe, a warning (never an abort): a
    # card another process already holds memory on serves slower
    for warning in probe_busy_devices(config.all_devices()):
        print("[rnb-tpu-torch] WARNING: %s" % warning, file=sys.stderr)
    # the lock-order witness (root lint key) wraps locks as they are
    # made, so it is armed before any stage, plane or board exists
    witness_armed = bool(config.lint
                         and config.lint.get("lock_witness", False))
    if witness_armed:
        lockwitness.enable()
        lockwitness.reset()
    job_id = "%s-mi%d-v%d-qs%d" % (
        datetime.today().strftime("%y%m%d_%H%M%S"), mean_interval_ms,
        num_videos, queue_size)
    if distributed.process_count() > 1:
        # the processes of a launch share a machine here, and a disk: each
        # writes its own job directory (a TPU pod's hosts each have theirs)
        job_id += "-p%d" % distributed.process_index()

    ragged = RaggedSettings.from_config(config.ragged)
    # one page allocator per job, handed to every SUPPORTS_PAGER stage
    pager_settings = PagerSettings.from_config(config.pager)
    pager = Pager(pager_settings) if pager_settings is not None else None
    bar_total = config.num_runners + 2  # runners + client + controller
    sta_bar = threading.Barrier(bar_total, timeout=BARRIER_TIMEOUT_S)
    fin_bar = threading.Barrier(bar_total, timeout=BARRIER_TIMEOUT_S)
    counter = InferenceCounter()
    termination = TerminationState()
    summary_sink, pad_sink, ragged_sink, staging_sink = [], [], [], []
    ingest_sink, cache_sink, compile_sink, graph_sink = [], [], [], []
    autotune_sink, requests_sink, shard_sink = [], [], []
    autotune_settings = AutotuneSettings.from_config(config.autotune)
    if autotune_settings is not None:
        _warn_if_no_stage_autotunes(config)
    critpath_settings = CritpathSettings.from_config(config.critpath)
    netedge_settings = NetEdgeSettings.from_config(config.netedge)
    # the edge contract of every consumer take, and the planner's cost
    # sink (apply-mode replica counts were expanded at parse time)
    handoff_settings = HandoffSettings.from_config(config.handoff)
    handoff_sink: list = []
    placement_settings = PlacementSettings.from_config(config.placement)
    placement_sink = [] if placement_settings is not None else None
    # per replica step: the lanes' shared depths, their health board
    # (root health key) and the hedge governor of its edge (hedge_ms)
    depths_by_step = {step_idx: InflightDepths(step.replica_queues)
                      for step_idx, step in enumerate(config.steps)
                      if step.replica_queues}
    health_settings = HealthSettings.from_config(config.health)
    boards_by_step: Dict[int, LaneHealthBoard] = {}
    if health_settings is not None:
        boards_by_step = {
            step_idx: LaneHealthBoard(step.replica_queues, health_settings)
            for step_idx, step in enumerate(config.steps)
            if step.replica_queues}
        if not boards_by_step and netedge_settings is None:
            print("[rnb-tpu-torch] WARNING: health is enabled but no step "
                  "declares replica lanes — there is nothing to "
                  "circuit-break and no Health: telemetry will be emitted",
                  file=sys.stderr)
    governors_by_step = {step_idx: HedgeGovernor(step.hedge_ms)
                         for step_idx, step in enumerate(config.steps)
                         if step.replica_queues and step.hedge_ms is not None}
    fault_plan = _resolve_fault_plan(config, netedge_settings is not None,
                                     bool(boards_by_step), print_progress)
    fault_stats = FaultStats()
    deadline_settings = DeadlineSettings.from_config(config.deadline,
                                                     config.autotune)
    deadline_stats = (DeadlineStats() if deadline_settings is not None
                      else None)
    if mean_interval_ms == 0:
        # bulk mode pre-enqueues everything (plus the exit markers)
        queue_size = _bulk_queue_size(config, num_videos)
    filename_queue: "queue.Queue" = queue.Queue(queue_size)
    queues, trackers = _pipeline_queues(config, queue_size)
    # a run that died mid-trace must not leave its hooks installed
    trace_mod.ACTIVE = None
    metrics_mod.ACTIVE = None
    devobs_mod.ACTIVE = None
    memledger_mod.ACTIVE = None
    tracer = _start_tracer(config, filename_queue, queues)
    # the SLO budget: the deadline's, else the controller's
    slo_budget_ms = (deadline_settings.budget_ms if deadline_settings
                     else autotune_settings.slo_ms if autotune_settings
                     else None)
    queue_probes = _queue_probes(filename_queue, queues, queue_size)
    registry, bridge = _start_metrics(
        config, job_id, log_base, queue_probes, pager, tracer,
        slo_budget_ms, fault_stats, deadline_stats,
        list(governors_by_step.values()), list(boards_by_step.values()))
    devobs_plane = _start_devobs(config, job_id, log_base, registry)
    # installed before the stages are built: they register their poll
    # sources, compute profiles and byte owners before the start barrier
    metrics_mod.ACTIVE = registry
    if devobs_plane is not None:
        devobs_mod.ACTIVE = devobs_plane
        memledger_mod.ACTIVE = devobs_plane.ledger
    whatif_settings = whatif_mod.WhatifSettings.from_config(config.whatif)
    # the measured window's clock for /whatif and /statusz, stamped at
    # the start barrier
    operator_window: Dict[str, Any] = {"t0": None}
    operator_server, stack_sampler = _start_operator(
        config, job_id, log_base, registry, devobs_plane, queue_probes,
        termination, operator_window, closers, print_progress,
        boards_by_step)
    num_markers = max(NUM_EXIT_MARKERS,
                      sum(len(g.devices) for g in config.steps[0].groups))
    edge = None
    if netedge_settings is not None:
        # the peer binds before any stage of this process is built; a
        # peer that cannot build its stage raises here
        edge = _NetEdge(
            config_path, config, netedge_settings, queue_size=queue_size,
            inject_queue=queues[0][config.steps[0].groups[0].out_queues[0]],
            filename_queue=filename_queue, num_markers=num_markers,
            seed=seed, counter=counter, termination=termination,
            fault_plan=fault_plan, fault_stats=fault_stats,
            deadline_stats=deadline_stats, num_videos=num_videos,
            rows_sink=net_rows_sink, closers=closers)
        if registry is not None:
            edge.add_polls(registry)

    client_args = (config.video_path_iterator, filename_queue,
                   mean_interval_ms if mean_interval_ms > 0 else num_videos,
                   termination, sta_bar, fin_bar, seed, num_markers)
    client_kwargs = dict(
        popularity=config.popularity, requests_sink=requests_sink,
        overload_policy=config.overload_policy,
        fault_stats=fault_stats, counter=counter,
        target_num_videos=num_videos,
        deadline_budget_s=(deadline_settings.budget_ms / 1000.0
                           if deadline_settings is not None else None))
    threads = [threading.Thread(
        target=poisson_client if mean_interval_ms > 0 else bulk_client,
        args=client_args, kwargs=client_kwargs, name="client", daemon=True)]
    for step_idx, step in enumerate(config.steps):
        is_final = step_idx == config.num_steps - 1
        for group_idx, group in enumerate(step.groups):
            kwargs = step.kwargs_for_group(group_idx)
            if ragged is not None and getattr(load_class(step.model),
                                              "SUPPORTS_RAGGED", False):
                kwargs.update(ragged=True,
                              ragged_pool_rows=ragged.pool_rows)
            # under netedge the dispatcher takes the filename queue and
            # step 0 serves the local fallback off the interposed queue
            in_queue = (queues[step_idx - 1][group.in_queue] if step_idx
                        else edge.local_queue if edge is not None
                        else filename_queue)
            out_queues = (None if is_final else
                          [queues[step_idx][q] for q in group.out_queues])
            # this group's lane of a replica step, if it is one
            lane = (group.in_queue if step.replica_queues
                    and group.in_queue in step.replica_queues else None)
            for instance_idx, device in enumerate(group.devices):
                ctx = RunnerContext(
                    in_queue=in_queue, out_queues=out_queues,
                    job_id=job_id, device=device, group_idx=group_idx,
                    instance_idx=instance_idx, counter=counter,
                    num_videos=num_videos, termination=termination,
                    step_idx=step_idx, sta_bar=sta_bar, fin_bar=fin_bar,
                    model_class_path=step.model, model_kwargs=kwargs,
                    sync_outputs=not step.async_dispatch,
                    upstream_async=(step_idx > 0 and config.steps[
                        step_idx - 1].async_dispatch),
                    queue_selector_path=group.queue_selector,
                    credits=(None if is_final
                             else RingCredits(step.num_shared_tensors)),
                    out_trackers=(None if is_final else
                                  [trackers[step_idx][q]
                                   for q in group.out_queues]),
                    print_progress=(print_progress and is_final
                                    and group_idx == 0
                                    and instance_idx == 0),
                    log_base=log_base,
                    summary_sink=summary_sink if is_final else None,
                    pad_sink=pad_sink, ragged_sink=ragged_sink,
                    staging_sink=staging_sink, ingest_sink=ingest_sink,
                    cache_sink=cache_sink, compile_sink=compile_sink,
                    graph_sink=graph_sink, stage_sink=stages_sink,
                    shard_sink=shard_sink, pager=pager,
                    outputs_sink=outputs_sink if is_final else None,
                    num_segments=step.num_segments, tracer=tracer,
                    autotune=autotune_settings if step.autotune else None,
                    autotune_sink=autotune_sink,
                    critpath=critpath_settings is not None,
                    containment=config.fault_containment,
                    overload_policy=config.overload_policy,
                    max_retries=step.max_retries,
                    retry_backoff_ms=step.retry_backoff_ms,
                    fault_plan=fault_plan, fault_stats=fault_stats,
                    deadline=deadline_settings,
                    deadline_stats=deadline_stats,
                    handoff_settings=handoff_settings,
                    handoff_edge=("step%d->step%d" % (step_idx - 1, step_idx)
                                  if step_idx > 0 else ""),
                    handoff_sink=handoff_sink,
                    placement_sink=placement_sink,
                    out_depths=depths_by_step.get(step_idx + 1),
                    out_queue_indices=(list(group.out_queues)
                                       if group.out_queues else None),
                    in_depths=(depths_by_step.get(step_idx)
                               if lane is not None else None),
                    in_queue_idx=group.in_queue,
                    health_board=(boards_by_step.get(step_idx)
                                  if lane is not None else None),
                    out_health_board=boards_by_step.get(step_idx + 1),
                    sibling_queues=(
                        {q: queues[step_idx - 1][q]
                         for q in step.replica_queues}
                        if lane is not None else None),
                    out_hedges=governors_by_step.get(step_idx + 1),
                    in_hedges=(governors_by_step.get(step_idx)
                               if lane is not None else None))
                threads.append(threading.Thread(
                    target=runner, args=(ctx,), daemon=True,
                    name="runner-s%d-g%d-i%d" % (step_idx, group_idx,
                                                 instance_idx)))
    for t in threads:
        t.start()
    if edge is not None:
        # transport threads, not stages: they join no barrier
        edge.client.start()

    profiler = None
    if profile or xprof or registry is not None \
            or devobs_plane is not None:
        # the profiler, the metrics flusher and the devobs worker cover
        # the measured window only: wait until every other party is
        # parked on the start barrier (built, warm, its graphs captured
        # and its poll sources registered; no profiler session may
        # start during a graph capture)
        while sta_bar.n_waiting < bar_total - 1 and not any(
                not t.is_alive() for t in threads):
            time.sleep(0.01)
    if profile:
        # through the profiler's one-session guard: a devobs capture in
        # this window is skipped and counted, never opened twice
        profiler = profiler_mod.initialize([
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
    if xprof:
        # the card's ops (every thread's CPU operators on the CPU)
        profiler_mod.initialize()
    if hostprof.ENABLED:
        # the sections of this window only, not the warm-ups
        hostprof.reset()
    if tracer is not None:
        # installed at the barrier: every stage is built and warm, so no
        # warm-up lands in the timeline; no runner passes the barrier
        # before this thread reaches it
        trace_mod.ACTIVE = tracer
        tracer.start_sampler()
    if registry is not None:
        # the bridge takes the hooks at the same point, forwarding to the
        # tracer on a traced run; the flusher covers the window
        trace_mod.ACTIVE = bridge
        registry.start()
    if devobs_plane is not None:
        # the worker is up before the barrier (every source registered);
        # its capture windows wait for note_run_started below
        devobs_plane.start()
    sta_bar.wait()
    if devobs_plane is not None:
        devobs_plane.note_run_started()
    ru_start = resource.getrusage(resource.RUSAGE_SELF)
    launches_start = _kernels.launch_counts()
    time_start = time.time()
    operator_window["t0"] = time_start
    if stack_sampler is not None:
        # the window only: no warm-up or capture lands in the folded
        # stacks, and the ticks track sample_hz x the window
        stack_sampler.start()
    if print_progress:
        print("START! %f" % time_start)
    fin_bar.wait()
    time_end = time.time()
    if stack_sampler is not None:
        # the ticks track sample_hz x the window: the reads of a --profile
        # or --xprof session below take seconds
        stack_sampler.stop()
    ru_end = resource.getrusage(resource.RUSAGE_SELF)
    host_cpu_s = ((ru_end.ru_utime + ru_end.ru_stime)
                  - (ru_start.ru_utime + ru_start.ru_stime))
    total_time = time_end - time_start
    kernel_ms = None
    if xprof:
        if config.platform == "cuda":
            torch.cuda.synchronize()
        # anchored before the stop: device_busy.py maps the last device
        # op to this instant
        flush_epoch = time.time()
        profiler_mod.flush()
        _write_xprof(os.path.join(logroot(job_id, base=log_base),
                                  "xprof-ops.txt"),
                     profiler_mod.report(include_plane=True), time_start,
                     time_end, flush_epoch)
    if profiler is not None:
        if config.platform == "cuda":
            torch.cuda.synchronize()
        profiler_mod.flush()
        averages = profiler.key_averages()
        profiler_mod.discard(profiler)
        root = logroot(job_id, base=log_base)
        if config.platform == "cuda":
            # device-side events only: an operator's own event repeats
            # the time of the kernels it launched
            kernels = {e.key: {"device_us": e.self_device_time_total,
                               "count": e.count}
                       for e in averages
                       if e.device_type != torch.autograd.DeviceType.CPU
                       and e.self_device_time_total > 0}
            kernel_ms = sum(k["device_us"] for k in kernels.values()) / 1e3
            with open(os.path.join(root, "profile.json"), "w") as f:
                json.dump({"kernels": kernels}, f, indent=1)
        with open(os.path.join(root, "profile.txt"), "w") as f:
            f.write(averages.table(sort_by="self_device_time_total",
                                   row_limit=40))
    window_launches = {name: count - launches_start[name]
                       for name, count in _kernels.launch_counts().items()}
    for t in threads:
        t.join(timeout=60)
    if outputs_sink is not None:
        finish_outputs(outputs_sink)
    if edge is not None:
        edge.finish(pad_sink)
    # every thread has drained: uninstall the tracer (or the bridge)
    # first, so a later run in this process never writes into this job's
    # collector
    trace_mod.ACTIVE = None
    if devobs_plane is not None:
        # stop the capture worker (a still-armed capture is drained with
        # a zero-length window) and clear the hooks; the captured device
        # ops join the tracer as device:<plane> tracks, rid-correlated to
        # the model_call spans, before trace.json is written
        devobs_mod.ACTIVE = None
        memledger_mod.ACTIVE = None
        devobs_plane.stop()
        if tracer is not None:
            tracer.extend(devobs_plane.device_events(
                devobs_mod.model_call_spans(tracer.snapshot_events())))
    stacks_summary = None
    if stack_sampler is not None:
        # written and merged into the tracer as stacks:<role> tracks
        # before trace.json is written
        stack_sampler.write_folded(os.path.join(
            logroot(job_id, base=log_base), "stacks.folded"))
        if tracer is not None:
            tracer.extend(stack_sampler.trace_events())
        stacks_summary = stack_sampler.summary()
    trace_events = trace_dropped = 0
    if tracer is not None:
        tracer.stop_sampler()
        trace_events = tracer.export(
            os.path.join(logroot(job_id, base=log_base), "trace.json"),
            job_id)
        trace_dropped = tracer.dropped

    latencies, clips, completed = [], 0, 0
    for summary in summary_sink:
        latencies.extend(summary.latencies_ms(NUM_SUMMARY_SKIPS))
        clips += summary.total_clips()
        completed += summary.num_records()
    pct = latency_percentiles(latencies)
    pad_rows = sum(p["pad_rows"] for p in pad_sink)
    total_rows = sum(p["total_rows"] for p in pad_sink)
    pad_emissions = sum(p["emissions"] for p in pad_sink)
    device = (torch.cuda.get_device_name(0) if config.platform == "cuda"
              else "cpu")
    cache_stats = aggregate_snapshots(cache_sink) if cache_sink else None
    ragged_totals = dict.fromkeys(RAGGED_LINE_KEYS, 0)
    if ragged_sink:
        ragged_totals.update(
            {k: sum(r[k] for r in ragged_sink) for k in RAGGED_LINE_KEYS},
            pool_rows=max(r["pool_rows"] for r in ragged_sink))
    pages_summary = None
    if pager is not None:
        # every thread has joined: occupancy is settled, so the
        # teardown footing allocs == frees + live holds from the line
        pages_summary = pager.snapshot()
        pages_summary["bypassed_batches"] = sum(
            s.get("bypassed_batches", 0) for s in staging_sink)
    compiles, warmup = aggregate_compile_records(compile_sink)
    graphs: Dict[str, dict] = {}
    for step_idx, stats in graph_sink:
        agg = graphs.setdefault("step%d" % step_idx, {
            "graphs": 0, "capture_s": 0.0, "replays": 0})
        for key in agg:
            agg[key] += stats[key]
    for agg in graphs.values():
        agg["capture_s"] = round(agg["capture_s"], 3)
    phases = None
    if tracer is not None:
        samples: Dict[str, list] = {}
        for summary in summary_sink:
            for phase, values in summary.phase_samples(
                    NUM_SUMMARY_SKIPS).items():
                samples.setdefault(phase, []).extend(values)
        phases = trace_mod.phase_stats(samples) or None
    critpath_report = None
    if critpath_settings is not None and summary_sink:
        lanes = {step_idx: sum(len(g.devices) for g in step.groups)
                 for step_idx, step in enumerate(config.steps)}
        # each row carries its hedge-won flag and redispatch count
        critpath_report = critpath_aggregate(
            (row for summary in summary_sink
             for row in summary.steady_rows(NUM_SUMMARY_SKIPS)), lanes)
    autotune_stats = (aggregate_autotune(autotune_sink) if autotune_sink
                      else None)
    faults = fault_stats.snapshot()
    deadline_snap = (deadline_stats.snapshot() if deadline_stats is not None
                     else None)
    health_stats = net_snap = None
    # every pipeline thread joined: the witness's edges are settled
    lock_snap = lockwitness.summary() if witness_armed else None
    board_snapshots = [b.snapshot() for b in boards_by_step.values()]
    if edge is not None:
        board_snapshots.append(edge.board.snapshot())
        net_snap = edge.stats.snapshot()
    if board_snapshots:
        health_stats = aggregate_board_snapshots(board_snapshots)
    handoff_stats = (aggregate_handoff(handoff_sink) if handoff_sink
                     else None)
    # the governors' final counters (unresolved hedges resolve as lost),
    # before the metrics plane's final snapshot so the two foot
    hedge_stats = (aggregate_hedge_snapshots(
        [g.snapshot() for g in governors_by_step.values()])
        if governors_by_step else None)
    placement_report = None
    if placement_sink is not None:
        placement_report = build_report(
            placement_sink, total_time, device_budget(config.platform),
            placement_settings.mode)
    shard_stats = aggregate_shard(shard_sink) if shard_sink else None
    compute_summary = memory_summary = None
    if devobs_plane is not None:
        # the job figures over the same measured window; the ledger
        # re-samples after every thread joined
        compute_summary = devobs_plane.compute_summary(
            total_time, devobs_mod.devices_used(config.raw))
        memory_summary = devobs_plane.memory_summary()
    metrics_summary = None
    if registry is not None:
        # the final footing snapshot: every thread joined and every
        # ledger above settled, so its counters equal the log-meta lines
        # exactly; also services RNB_FLIGHT_FORCE and writes metrics.prom
        registry.stop()
        metrics_mod.ACTIVE = None
        metrics_summary = registry.summary()
    operator_summary = None
    if operator_server is not None:
        # stopped after the final snapshot (a scraper may read the
        # settled /metrics) and before log-meta, so the ledger is final
        operator_server.stop()
        operator_summary = operator_server.summary()
    whatif_counters = None
    if whatif_settings is not None:
        # from the final snapshot, the last record of metrics.jsonl, so
        # parse_utils recomputes the line from the artifacts alone
        model = None
        final = registry.final_snapshot() if registry is not None else None
        if final is not None:
            model = whatif_mod.calibrate_from_snapshot(
                final, whatif_mod.steps_info_from_config(config.raw),
                wall_s=total_time,
                arrival_hz=whatif_mod.arrival_hz_from_snapshot(final))
        whatif_counters = whatif_mod.summary_counters(model)
    result = BenchmarkResult(
        job_id=job_id, total_time_s=total_time, num_videos=num_videos,
        termination_flag=int(termination.value),
        throughput_vps=completed / total_time if total_time > 0 else 0.0,
        log_dir=logroot(job_id, base=log_base), device=device,
        p50_latency_ms=pct.get(50.0), p99_latency_ms=pct.get(99.0),
        clips_completed=clips, num_completed=completed,
        pad_rows=pad_rows, total_rows=total_rows,
        pad_emissions=pad_emissions,
        window_launches=window_launches, kernel_ms=kernel_ms,
        **{"ragged_" + k: v for k, v in ragged_totals.items()},
        pages=dict(pages_summary) if pages_summary else {},
        compiles=compiles, warmup_s=warmup, graphs=graphs,
        trace_events=trace_events, trace_dropped=trace_dropped,
        phases=phases, host_cpu_s=host_cpu_s,
        num_requests=sum(requests_sink),
        num_failed=faults["num_failed"], num_shed=faults["num_shed"],
        num_retries=faults["num_retries"],
        failure_reasons=faults["failure_reasons"],
        shed_sites=faults["shed_sites"],
        queue_overflows=faults["overflow_sites"])
    if deadline_snap is not None:
        result.deadline_budget_ms = round(deadline_settings.budget_ms)
        result.deadline_expired = deadline_snap["expired"]
        result.deadline_sites = deadline_snap["sites"]
    if metrics_summary is not None:
        for key, value in metrics_summary.items():
            if key == "burn_max_milli":
                key = "slo_" + key
            elif not key.startswith("slo_"):
                key = "metrics_" + key
            setattr(result, key, value)
    if critpath_report is not None:
        for key, value in critpath_report.items():
            setattr(result, "critpath_" + key, value)
    for prefix, summary in (("whatif_", whatif_counters),
                            ("operator_", operator_summary),
                            ("stacks_", stacks_summary)):
        for key, value in (summary or {}).items():
            setattr(result, prefix + key, value)
    if shard_stats is not None:
        for key, value in shard_stats.items():
            setattr(result, "shard_" + key, value)
    if health_stats is not None:
        for key, value in health_stats.items():
            setattr(result, "health_" + key, value)
    if handoff_stats is not None:
        for key, value in handoff_stats.items():
            setattr(result, "handoff_" + key, value)
    if hedge_stats is not None:
        for key, value in hedge_stats.items():
            setattr(result, "hedges_" + key, value)
    if placement_report is not None:
        result.placement = placement_report
    if net_snap is not None:
        for key in NetStats.COUNTERS:
            setattr(result, "net_" + key, int(net_snap[key]))
    if lock_snap is not None:
        result.locks_tracked = lock_snap["locks"]
        result.locks_acquires = lock_snap["acquires"]
        result.locks_edges = len(lock_snap["edges"])
        result.locks_violations = len(lock_snap["violations"])
    if autotune_stats is not None:
        for key, value in autotune_stats.items():
            setattr(result, "autotune_" + key, value)
    if cache_stats is not None:
        for key in ("hits", "misses", "inserts", "evictions", "coalesced",
                    "oversize", "bytes_resident"):
            setattr(result, "cache_" + key, cache_stats[key])
    if compute_summary is not None:
        for key, value in compute_summary.items():
            setattr(result, "compute_" + key, value)
        result.compute_captures_skipped = devobs_plane.captures_skipped
        for key, value in memory_summary.items():
            if key == "owners":
                result.memory_owners = len(value)
                result.memory_owner_detail = value
            elif key == "devices":
                result.memory_devices = len(value)
            else:
                setattr(result, "memory_" + key, value)

    args = dict(config=config_path, mean_interval_ms=mean_interval_ms,
                num_videos=num_videos, queue_size=queue_size, seed=seed,
                platform=config.platform)
    if batch_size != 1:
        args["batch_size"] = batch_size
    with open(logmeta(job_id, base=log_base), "w") as f:
        f.write("Args: %s\n" % json.dumps(args))
        f.write("%f %f\n" % (time_start, time_end))
        f.write("Termination flag: %d\n" % termination.value)
        # the reference's fault lines, byte for byte
        f.write("Faults: num_failed=%d num_shed=%d num_retries=%d\n"
                % (faults["num_failed"], faults["num_shed"],
                   faults["num_retries"]))
        if faults["failure_reasons"]:
            f.write("Failure reasons: %s\n" % json.dumps(
                faults["failure_reasons"], sort_keys=True))
        if faults["shed_sites"]:
            f.write("Shed sites: %s\n" % json.dumps(faults["shed_sites"],
                                                    sort_keys=True))
        if faults["overflow_sites"]:
            f.write("Queue overflows: %s\n" % json.dumps(
                faults["overflow_sites"], sort_keys=True))
        if deadline_snap is not None:
            # parse_utils cross-foots the sites with the deadline-suffixed
            # entries of Shed sites:
            f.write("Deadline: budget_ms=%d expired=%d\n"
                    % (result.deadline_budget_ms, deadline_snap["expired"]))
            if deadline_snap["sites"]:
                f.write("Deadline sites: %s\n" % json.dumps(
                    deadline_snap["sites"], sort_keys=True))
        if health_stats is not None:
            # the reference's format; parse_utils replays every lane's
            # path against the legal automaton, routes_after_open 0
            f.write("Health: lanes=%d transitions=%d opens=%d evictions=%d "
                    "probes=%d redispatches=%d routes_after_open=%d\n"
                    % tuple(health_stats[k] for k in (
                        "lanes", "transitions", "opens", "evictions",
                        "probes", "redispatches", "routes_after_open")))
            if health_stats["lane_detail"]:
                f.write("Health lanes: %s\n" % json.dumps(
                    health_stats["lane_detail"], sort_keys=True))
        # JSON, never two words: the reference's reader takes a line of
        # exactly two words for the window's timestamps
        f.write("Device: %s\n" % json.dumps(
            {"name": device, "platform": config.platform}, sort_keys=True))
        for ingest in ingest_sink:
            # no "=" in these lines: they are names, not counters; a
            # loader that decoded nothing (every request served remotely)
            # names "none", never an empty value of two words
            f.write("Pixel path: %s\n" % ingest["pixel_path"])
            f.write("Decode backend: %s\n"
                    % (",".join(sorted(ingest["backends"])) or "none"))
        # the clip rows the final step completed: every batching stage
        # counts its own rows into Padding: and Ragged:, so a loader
        # followed by a batcher counts a clip twice there
        f.write("Completed: requests=%d clips=%d\n" % (completed, clips))
        f.write("Padding: pad_rows=%d total_rows=%d pad_emissions=%d\n"
                % (pad_rows, total_rows, pad_emissions))
        if ragged_sink:
            # one line over every ragged batching stage (a loader, a
            # batcher), as the reference writes it
            f.write("Ragged: pool_rows=%d emissions=%d rows=%d "
                    "pad_rows_eliminated=%d cache_hit_rows=%d\n"
                    % tuple(ragged_totals[k] for k in RAGGED_LINE_KEYS))
        if handoff_stats is not None:
            # handoff runs only; the reference's format: d2d + host ==
            # edges, and host_bytes 0 on a device config
            f.write("Handoff: edges=%d d2d_edges=%d host_edges=%d "
                    "d2d_bytes=%d host_bytes=%d\n" % tuple(
                        handoff_stats[k] for k in (
                            "edges", "d2d_edges", "host_edges",
                            "d2d_bytes", "host_bytes")))
            if handoff_stats["edge_detail"]:
                f.write("Handoff edges: %s\n" % json.dumps(
                    handoff_stats["edge_detail"], sort_keys=True))
        if placement_report is not None:
            # the executed plan's predicted occupancy (parse_utils holds
            # it to the traced busy fraction) and the recommendation
            f.write("Placement: %s\n" % json.dumps(placement_report,
                                                   sort_keys=True))
        if hedge_stats is not None:
            # hedge_ms runs only; won + lost == fired
            f.write("Hedge: fired=%d won=%d lost=%d wasted_ms=%d\n"
                    % tuple(hedge_stats[k] for k in (
                        "fired", "won", "lost", "wasted_ms")))
        if shard_stats is not None:
            # declared-shard runs only, so unsharded logs keep their
            # bytes; the reference's format (its --check foots the
            # totals and nests collective_us in the model_call spans)
            f.write("Shard: steps=%d max_degree=%d gathers=%d "
                    "collective_us=%d rows=%d\n" % tuple(
                        shard_stats[k] for k in (
                            "steps", "max_degree", "gathers",
                            "collective_us", "rows")))
            f.write("Shard steps: %s\n" % json.dumps(
                shard_stats["step_detail"], sort_keys=True))
        if cache_stats is not None:
            # the reference's format, byte for byte
            f.write("Cache: hits=%d misses=%d inserts=%d evictions=%d "
                    "coalesced=%d oversize=%d bytes_resident=%d\n"
                    % (cache_stats["hits"], cache_stats["misses"],
                       cache_stats["inserts"], cache_stats["evictions"],
                       cache_stats["coalesced"], cache_stats["oversize"],
                       cache_stats["bytes_resident"]))
        for snap in staging_sink:
            f.write("Staging: %s\n" % " ".join(
                "%s=%d" % kv for kv in sorted(snap.items())))
        if pages_summary is not None:
            # the reference's format, byte for byte; then each arena's
            # size (the feature arena's depends on which stage attached
            # first)
            f.write("Pages: %s\n" % " ".join(
                "%s=%d" % (k, pages_summary[k]) for k in PAGES_LINE_KEYS))
            f.write("Pages arenas: %s\n" % json.dumps(pager.arena_sizes(),
                                                       sort_keys=True))
        if autotune_stats is not None:
            # the reference's format; autotune runs only
            f.write("Autotune: decisions=%d immediate=%d held=%d "
                    "emissions=%d deadline_us_min=%d deadline_us_max=%d "
                    "deadline_us_sum=%d\n" % tuple(autotune_stats[k] for k in (
                        "decisions", "immediate", "held", "emissions",
                        "deadline_us_min", "deadline_us_max",
                        "deadline_us_sum")))
            if autotune_stats["bucket_counts"]:
                f.write("Autotune buckets: %s\n" % json.dumps(
                    autotune_stats["bucket_counts"], sort_keys=True))
        if compiles:
            # the reference's format: per step, the warm-up vocabulary
            # and the signatures first seen in the measured window
            # (steady_new > 0 is a mid-run capture; parse_utils fails it)
            f.write("Compiles: %s\n" % json.dumps(compiles, sort_keys=True))
        if warmup:
            f.write("Warmup: %s\n" % json.dumps(warmup, sort_keys=True))
        if graphs:
            f.write("Graphs: %s\n" % json.dumps(graphs, sort_keys=True))
        if tracer is not None:
            # parse_utils checks the count against trace.json
            f.write("Trace: events=%d dropped=%d\n"
                    % (trace_events, trace_dropped))
        if phases is not None:
            f.write("Phases: %s\n" % json.dumps(phases, sort_keys=True))
        if metrics_summary is not None:
            # the reference's format; parse_utils holds the final
            # snapshot of metrics.jsonl to the ledger lines above
            f.write("Metrics: snapshots=%d series=%d dumps=%d triggers=%d\n"
                    % tuple(metrics_summary[k] for k in (
                        "snapshots", "series", "dumps", "triggers")))
            f.write("Slo: tracked=%d within=%d missed=%d "
                    "burn_max_milli=%d\n" % tuple(metrics_summary[k] for k in (
                        "slo_tracked", "slo_within", "slo_missed",
                        "burn_max_milli")))
        if compute_summary is not None:
            # the reference's format; every devobs run carries it (zero
            # flops with no metered stage), parse_utils cross-foots it
            f.write("Compute: stages=%d dispatches=%d rows=%d "
                    "flops_total=%d window_us=%d tflops_milli=%d "
                    "mfu_e4=%d captures=%d\n" % tuple(
                        compute_summary[k] for k in (
                            "stages", "dispatches", "rows", "flops_total",
                            "window_us", "tflops_milli", "mfu_e4",
                            "captures")))
            f.write("Compute stages: %s\n" % json.dumps(
                compute_summary["stage_detail"], sort_keys=True))
        if memory_summary is not None:
            # the reference's format: owner rows sum to total_bytes,
            # peak >= final, reconciled=1 where the allocator holds the
            # ledger's live-backed claims
            f.write("Memory: owners=%d devices=%d total_bytes=%d "
                    "peak_bytes=%d watermark_bytes=%d watermark_hits=%d "
                    "live_bytes=%d reconciled=%d\n" % (
                        len(memory_summary["owners"]),
                        len(memory_summary["devices"]),
                        memory_summary["total_bytes"],
                        memory_summary["peak_bytes"],
                        memory_summary["watermark_bytes"],
                        memory_summary["watermark_hits"],
                        memory_summary["live_bytes"],
                        memory_summary["reconciled"]))
            if memory_summary["owners"]:
                f.write("Memory owners: %s\n" % json.dumps(
                    memory_summary["owners"], sort_keys=True))
        if critpath_report is not None:
            # the reference's format; parse_utils re-derives it from the
            # timing tables
            f.write("Critpath: requests=%d segments=%d residual_us_max=%d "
                    "hedged=%d redispatched=%d bound_step=%d "
                    "bound_vps_milli=%d\n" % tuple(critpath_report[k] for k in (
                        "requests", "segments", "residual_us_max", "hedged",
                        "redispatched", "bound_step", "bound_vps_milli")))
            f.write("Critpath stages: %s\n" % json.dumps(
                critpath_report["stage_detail"], sort_keys=True))
        if whatif_counters is not None:
            # the reference's format; parse_utils recomputes it from
            # metrics.jsonl and the config copy within 1 milli-vps
            f.write("Whatif: stages=%d calibrated=%d pred_vps_milli=%d "
                    "bottleneck_step=%d\n" % tuple(whatif_counters[k] for k in (
                        "stages", "calibrated", "pred_vps_milli",
                        "bottleneck_step")))
        if operator_summary is not None:
            # the reference's format; parse_utils holds it to
            # operator.json both ways
            f.write("Operator: scrapes=%d actions=%d denied=%d errors=%d\n"
                    % tuple(operator_summary[k] for k in (
                        "scrapes", "actions", "denied", "errors")))
        if stacks_summary is not None:
            # the reference's format; stacks.folded re-sums to total
            f.write("Stacks: samples=%d threads=%d folded=%d total=%d\n"
                    % tuple(stacks_summary[k] for k in (
                        "samples", "threads", "folded", "total")))
        if net_snap is not None:
            # the reference's format; parse_utils foots frames_sent ==
            # frames_acked + resent_pending, dedup_drops == dup_arrivals,
            # the error classes to the total, no strands on a reached
            # target; NetStats.COUNTERS is the reference's order
            f.write("Net: frames_sent=%d frames_acked=%d resent_pending=%d "
                    "resends=%d beats=%d reconnects=%d remote=%d local=%d "
                    "dedup_drops=%d dup_arrivals=%d wire_bytes=%d "
                    "frame_bytes=%d window_stranded=%d "
                    "open_before_timeout=%d\n" % tuple(
                        net_snap[k] for k in NetStats.COUNTERS
                        if not k.startswith("err_")))
            f.write("Net errors: total=%d refused=%d reset=%d timeout=%d "
                    "partial_frame=%d corrupt=%d\n" % tuple(
                        net_snap[k] for k in NetStats.COUNTERS
                        if k.startswith("err_")))
        if lock_snap is not None:
            # the reference's lines; parse_utils holds violations to 0
            # and the counts to the detail
            f.write("Locks: tracked=%d acquires=%d edges=%d "
                    "violations=%d\n"
                    % (lock_snap["locks"], lock_snap["acquires"],
                       len(lock_snap["edges"]),
                       len(lock_snap["violations"])))
            f.write("Lock edges: %s\n"
                    % lockwitness.format_edges(lock_snap))
        f.write("Kernels: %s\n" % json.dumps(window_launches,
                                             sort_keys=True))
        if kernel_ms is not None:
            f.write("Profile: kernel_ms=%.3f window_ms=%.3f busy_share=%.4f\n"
                    % (kernel_ms, total_time * 1e3,
                       kernel_ms / (total_time * 1e3)))
    if whatif_settings is not None or operator_server is not None \
            or handoff_settings is not None:
        # the config copy whatif recomputes from (and parse_utils reads
        # the sampler's rate and the handoff mode from), as the
        # reference drops it; a config named like one of the job's own
        # files keeps it whole
        name = os.path.basename(config_path)
        if name in JOB_FILES:
            name = "config-" + name
        shutil.copyfile(config_path, os.path.join(
            logroot(job_id, base=log_base), name))
    if faults["dead_letters"]:
        # one line per dead letter (the detail is capped, the counters
        # above are exact)
        with open(os.path.join(logroot(job_id, base=log_base),
                               "failed-requests.txt"), "w") as f:
            f.write("# request_id step reason\n")
            for rid, step_idx, reason in faults["dead_letters"]:
                f.write("%s %d %s\n" % (rid, step_idx, reason))
    if hostprof.ENABLED:
        lines = hostprof.report_lines(total_time)
        with open(os.path.join(logroot(job_id, base=log_base),
                               "hostprof.txt"), "w") as f:
            f.write("# wall_s %.3f host_cpu_s %.3f host_cpu_frac %.3f\n"
                    % (total_time, host_cpu_s,
                       host_cpu_s / total_time if total_time else 0.0))
            f.write("\n".join(lines) + "\n")
    recompiled = sorted(step for step, sigs in compiles.items()
                        if sigs["steady_new"] > 0)
    if recompiled:
        print("[rnb-tpu-torch] WARNING: mid-run capture signature(s) on %s "
              "(Compiles: steady_new > 0)" % ", ".join(recompiled),
              file=sys.stderr)
    if print_progress:
        print("FINISH! %f" % time_end)
        print("Result: %s" % json.dumps(dict(
            videos_per_s=round(result.throughput_vps, 3),
            p50_ms=result.p50_latency_ms, p99_ms=result.p99_latency_ms,
            completed=completed, termination_flag=result.termination_flag,
            device=device, kernel_launches=window_launches,
            kernel_ms=kernel_ms)))
        if faults["num_failed"] or faults["num_shed"] \
                or faults["num_retries"]:
            print("Faults: %d failed, %d shed, %d retries (%s)"
                  % (faults["num_failed"], faults["num_shed"],
                     faults["num_retries"], ", ".join(
                         "%s=%d" % kv for kv in sorted(
                             faults["failure_reasons"].items())) or "-"))
        if handoff_stats is not None:
            print("Handoff: %d edge take(s) — %d d2d (%.1f MiB on-device) "
                  "/ %d host (%.1f MiB through host memory)"
                  % (handoff_stats["edges"], handoff_stats["d2d_edges"],
                     handoff_stats["d2d_bytes"] / (1 << 20),
                     handoff_stats["host_edges"],
                     handoff_stats["host_bytes"] / (1 << 20)))
        if placement_report is not None:
            print("Placement plan (predicted occupancy over %d devices): %s"
                  % (placement_report["device_budget"],
                     json.dumps(placement_report["plan"], sort_keys=True)))
        if hedge_stats is not None:
            print("Hedge: %d fired, %d won by the hedge / %d by the "
                  "original, %d ms of loser service wasted"
                  % tuple(hedge_stats[k] for k in (
                      "fired", "won", "lost", "wasted_ms")))
        if health_stats is not None:
            print("Health: %d lane(s), %d transition(s), %d open(s), %d "
                  "eviction(s), %d probe(s), %d redispatch(es)"
                  % tuple(health_stats[k] for k in (
                      "lanes", "transitions", "opens", "evictions",
                      "probes", "redispatches")))
        if net_snap is not None:
            print("Net: %d frame(s) sent / %d acked, %d resend(s), %d "
                  "reconnect(s), %d remote / %d local route(s), %d error(s)"
                  % tuple(net_snap[k] for k in (
                      "frames_sent", "frames_acked", "resends",
                      "reconnects", "remote", "local", "err_total")))
        if lock_snap is not None:
            print("Locks: %d witnessed lock(s), %d acquisition(s), %d order "
                  "edge(s), %d violation(s)"
                  % (lock_snap["locks"], lock_snap["acquires"],
                     len(lock_snap["edges"]), len(lock_snap["violations"])))
        if deadline_snap is not None:
            print("Deadline: budget %d ms, %d expired request(s) shed (%s)"
                  % (result.deadline_budget_ms, deadline_snap["expired"],
                     ", ".join("%s=%d" % kv for kv in sorted(
                         deadline_snap["sites"].items())) or "-"))
        if cache_stats is not None:
            print("Cache: %s" % json.dumps(cache_stats, sort_keys=True))
        if pages_summary is not None:
            print("Pages: %s" % json.dumps(pages_summary, sort_keys=True))
        if autotune_stats is not None:
            print("Autotune: %d decision(s) (%d immediate / %d held), %d "
                  "emission(s), buckets %s"
                  % (autotune_stats["decisions"], autotune_stats["immediate"],
                     autotune_stats["held"], autotune_stats["emissions"],
                     json.dumps(autotune_stats["bucket_counts"],
                                sort_keys=True)))
        if metrics_summary is not None:
            print("Metrics: %s" % json.dumps(metrics_summary, sort_keys=True))
        if compute_summary is not None:
            print("Compute: %d stage(s), %d dispatch(es), %d row(s), %.3f "
                  "achieved TFLOP/s over the window (mfu %s), %d capture(s)"
                  % (compute_summary["stages"],
                     compute_summary["dispatches"], compute_summary["rows"],
                     compute_summary["tflops_milli"] / 1000.0,
                     ("%.4f" % (compute_summary["mfu_e4"] / 10000.0)
                      if compute_summary["mfu_e4"] >= 0
                      else "n/a: unknown device peak"),
                     compute_summary["captures"]))
            print("Memory: %.2f MiB resident (peak %.2f MiB) across %d "
                  "owner(s); allocator reconcile: %s"
                  % (memory_summary["total_bytes"] / (1 << 20),
                     memory_summary["peak_bytes"] / (1 << 20),
                     len(memory_summary["owners"]),
                     "ok" if memory_summary["reconciled"] else
                     ("%.2f MiB allocated"
                      % (memory_summary["live_bytes"] / (1 << 20))
                      if memory_summary["live_bytes"] else "unavailable")))
        if critpath_report is not None:
            ranked = critpath_ranking(critpath_report["stage_detail"])
            print("Critpath: %d request(s), top blockers %s; bound step%d at "
                  "%.3f videos/s"
                  % (critpath_report["requests"], ", ".join(
                      "%s %.1f ms" % (seg, total)
                      for seg, total, _mean in ranked[:3]),
                     critpath_report["bound_step"],
                     critpath_report["bound_vps_milli"] / 1000.0))
    return result


def check_config(path: str) -> int:
    """``--check -c <config>``: validate the config as the port reads it
    and print the reference's posture lines (``rnb_tpu/benchmark.py``
    ``main``), the knobs to know before pointing traffic at the pipeline.
    Validation only: no stage is built, no kernel compiled, no device
    touched. A config the port does not read yet is refused with the
    reader's "not yet ported" error (exit 1)."""
    from rnb_tpu_torch import client, control, runner  # noqa: F401
    from rnb_tpu_torch.config import ConfigError
    from rnb_tpu_torch.models.r2p1d import model  # noqa: F401
    try:
        cfg = load_config(path, platform="cpu")
        plan = FaultPlan.resolve(cfg.fault_plan)
        if plan is not None:
            plan.check_steps(cfg.num_steps)
    except (ConfigError, ValueError) as e:
        print("config %s: %s" % (path, e), file=sys.stderr)
        return 1

    def spec(value) -> str:
        return json.dumps(value, sort_keys=True) if value else "none"

    retries = ", ".join(
        "step%d: %d@%gms" % (i, s.max_retries, s.retry_backoff_ms)
        for i, s in enumerate(cfg.steps) if s.max_retries) or "none"
    print("config %s: %d step(s), overload_policy=%s, "
          "fault_containment=%s, retries: %s"
          % (path, cfg.num_steps, cfg.overload_policy,
             cfg.fault_containment, retries))
    print("fault plan: %s" % (plan.describe() if plan is not None
                              else "none"))
    caches = ", ".join(
        "step%d: %g MB" % (i, s.kwargs["cache_mb"])
        for i, s in enumerate(cfg.steps)
        if s.kwargs.get("cache_mb")) or "none"
    print("clip cache: %s; popularity: %s" % (caches, spec(cfg.popularity)))
    opted_out = [i for i, s in enumerate(cfg.steps) if not s.autotune]
    print("autotune: %s%s" % (spec(cfg.autotune),
                              "; opted-out steps: %s" % opted_out
                              if opted_out else ""))
    print("ragged: %s" % spec(cfg.ragged))
    print("handoff: %s" % spec(cfg.handoff))
    replicated = {"step%d" % i: len(s.replica_queues)
                  for i, s in enumerate(cfg.steps) if s.replica_queues}
    print("placement: %s%s" % (spec(cfg.placement),
                               "; replica lanes: %s" % json.dumps(
                                   replicated, sort_keys=True)
                               if replicated else ""))
    print("trace: %s" % spec(cfg.trace))
    print("metrics: %s" % spec(cfg.metrics))
    print("devobs: %s" % spec(cfg.devobs))
    print("critpath: %s; whatif: %s" % (spec(cfg.critpath),
                                        spec(cfg.whatif)))
    print("operator: %s" % spec(cfg.operator))
    hedged = {"step%d" % i: s.hedge_ms for i, s in enumerate(cfg.steps)
              if s.hedge_ms is not None}
    print("health: %s; deadline: %s; hedging: %s"
          % (spec(cfg.health), spec(cfg.deadline), spec(hedged)))
    print("rnb_tpu_torch is ready to go!")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="PyTorch/CUDA streaming video-analytics benchmark")
    parser.add_argument("-mi", "--mean_interval_ms", type=nonnegative_int,
                        default=3,
                        help="Mean request interval (Poisson), ms; 0 = "
                             "bulk max-throughput mode")
    parser.add_argument("-b", "--batch_size", type=positive_int, default=1,
                        help="Video batch size per replica (recorded in "
                             "the Args: line; no stage reads it)")
    parser.add_argument("-v", "--videos", type=positive_int, default=2000,
                        help="Total number of videos to run")
    parser.add_argument("-qs", "--queue_size", type=positive_int,
                        default=50000,
                        help="Max size of inter-stage queues")
    parser.add_argument("-c", "--config_file_path", type=str,
                        default="configs/rnb-fused-yuv-big.json")
    parser.add_argument("--check", action="store_true",
                        help="validate the config and print its posture, "
                             "then exit")
    parser.add_argument("--platform", choices=["cuda", "cpu"],
                        default="cuda")
    parser.add_argument("--log-base", type=str, default="logs")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--profile", action="store_true",
                        help="trace the measured window (torch.profiler)")
    parser.add_argument("--xprof", action="store_true",
                        help="write the measured window's device ops to "
                             "xprof-ops.txt (scripts/device_busy.py "
                             "reads it)")
    args = parser.parse_args(argv)
    if args.check:
        return check_config(args.config_file_path)
    try:
        result = run_benchmark(
            config_path=args.config_file_path,
            mean_interval_ms=args.mean_interval_ms, num_videos=args.videos,
            queue_size=args.queue_size, log_base=args.log_base,
            seed=args.seed, platform=args.platform, profile=args.profile,
            xprof=args.xprof, batch_size=args.batch_size)
    finally:
        # a process of a launch leaves it (a no-op in one process)
        distributed.shutdown()
    print("Throughput: %.3f videos/s" % result.throughput_vps)
    print("Logs: %s" % result.log_dir)
    print(json.dumps(asdict(result)))
    return 0 if result.termination_flag == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
