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
buckets:``. Without those keys none of it runs and no line or file is
added. Every exit path, an aborted run included, leaves no hook
installed and no flusher running.

Fault containment (:mod:`rnb_tpu_torch.faults`, the reference's wiring):
every run keeps a :class:`~rnb_tpu_torch.control.FaultStats` ledger shared
by the client and the executors and writes ``Faults:`` (with ``Failure
reasons:``, ``Shed sites:`` and ``Queue overflows:`` when they have
entries, and ``failed-requests.txt``, one line per dead letter). The root
``fault_plan`` key (or the ``RNB_FAULT_PLAN`` env JSON, which wins) is
the injection schedule; the root ``deadline`` key stamps each request's
deadline and adds ``Deadline:``/``Deadline sites:``. Latency percentiles
and throughput count successes only.

Runs on ``cuda:0`` (the config's devices) unless ``platform="cpu"``.

CLI::

    python -m rnb_tpu_torch.benchmark -c configs/rnb-fused-yuv-big.json \\
        -mi 0 -v 48            # bulk mode, 48 requests, on the card
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import resource
import sys
import threading
import time
from dataclasses import asdict, dataclass, field
from datetime import datetime
from typing import Any, Dict, Optional

import torch

from rnb_tpu_torch import hostprof
from rnb_tpu_torch import metrics as metrics_mod
from rnb_tpu_torch import trace as trace_mod
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
from rnb_tpu_torch.faults import LANE_KINDS, FaultPlan
from rnb_tpu_torch.health import DeadlineSettings, DeadlineStats
from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.ops.ragged import RaggedSettings
from rnb_tpu_torch.pager import Pager, PagerSettings
from rnb_tpu_torch.runner import NUM_SUMMARY_SKIPS, RunnerContext, runner
from rnb_tpu_torch.telemetry import latency_percentiles, logmeta, logroot
from rnb_tpu_torch.utils.class_utils import load_class

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
    #: rows ragged cache hits served into pools (the ``Ragged:`` line)
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


def _resolve_fault_plan(config, print_progress: bool):
    """The run's fault plan (the ``RNB_FAULT_PLAN`` env JSON over the
    config's ``fault_plan``), or None; a plan no path of the port can
    inject is refused with the reference's messages."""
    plan = FaultPlan.resolve(config.fault_plan)
    if plan is None:
        return None
    # an env plan bypassed the config reader's step check
    plan.check_steps(config.num_steps)
    if any(f["kind"] in LANE_KINDS for f in plan.faults):
        raise ValueError(
            "the fault plan injects replica_crash/replica_stall but the "
            "config has no enabled root 'health' key (or no replica "
            "lanes) — lane deaths need the health layer's eviction/drain "
            "machinery to stay contained")
    if plan.has_net_faults():
        raise ValueError(
            "the fault plan injects net_* faults but the config has no "
            "enabled root 'netedge' key — there is no network edge to "
            "address")
    if print_progress:
        print("[rnb-tpu-torch] fault plan active: %s" % plan.describe())
    return plan


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


def _start_metrics(config, job_id: str, log_base: str, filename_queue,
                   queues, queue_size: int, pager, tracer, slo_budget_ms,
                   fault_stats, deadline_stats):
    """The job's live-metrics registry and its SpanBridge (None, None
    without the root ``metrics`` key). Its gauge sources are the filename
    queue and every inter-stage queue (keyed by edge ordinal in step
    order, each armed for the saturation trigger at the queue's
    capacity); the fault ledger, the deadline ledger and the page
    allocator are poll sources. The bridge forwards to ``tracer`` on a
    traced run."""
    settings = metrics_mod.MetricsSettings.from_config(config.metrics)
    if settings is None:
        return None, None
    registry = metrics_mod.MetricsRegistry(
        settings, job_dir=logroot(job_id, base=log_base), job_id=job_id,
        slo_budget_ms=slo_budget_ms)
    registry.add_gauge_source(metrics_mod.name("queue.filename.depth"),
                              filename_queue.qsize, capacity=queue_size)
    edge_idx = 0
    for step_idx in sorted(queues):
        for q_idx in sorted(queues[step_idx]):
            registry.add_gauge_source(
                metrics_mod.name("queue.e%d.depth", edge_idx),
                queues[step_idx][q_idx].qsize, capacity=queue_size)
            edge_idx += 1
    registry.add_poll(metrics_mod.snapshot_poll(
        "faults", fault_stats.snapshot,
        counters=("num_failed", "num_shed", "num_retries")))
    if deadline_stats is not None:
        registry.add_poll(metrics_mod.snapshot_poll(
            "deadline", deadline_stats.snapshot, counters=("expired",)))
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
                  stages_sink: Optional[list] = None) -> BenchmarkResult:
    """Programmatic entry used by the CLI, the tests and chip_smoke.py.
    ``outputs_sink``, when given, receives every request's output rows
    (request id -> (video, float32 array, its cache stamps)).
    ``stages_sink``, when given, receives ``(step_idx, stage)`` for every
    stage built. ``profile`` traces the measured window with
    ``torch.profiler`` (card runs): the sum of
    kernel time lands in the result, each kernel's time and launches in
    ``profile.json``, and the profiler's table in ``profile.txt``."""
    try:
        return _run_benchmark(
            config_path, mean_interval_ms, num_videos, queue_size, log_base,
            print_progress, seed, platform, outputs_sink, profile,
            stages_sink)
    finally:
        # every exit path, an aborted or failed run included: no trace
        # or metrics hook stays installed, no flusher keeps running
        trace_mod.ACTIVE = None
        registry, metrics_mod.ACTIVE = metrics_mod.ACTIVE, None
        if registry is not None:
            registry.stop()


def _run_benchmark(config_path, mean_interval_ms, num_videos, queue_size,
                   log_base, print_progress, seed, platform, outputs_sink,
                   profile, stages_sink) -> BenchmarkResult:
    config = load_config(config_path, platform)
    job_id = "%s-mi%d-v%d-qs%d" % (
        datetime.today().strftime("%y%m%d_%H%M%S"), mean_interval_ms,
        num_videos, queue_size)

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
    autotune_sink, requests_sink = [], []
    autotune_settings = AutotuneSettings.from_config(config.autotune)
    if autotune_settings is not None:
        _warn_if_no_stage_autotunes(config)
    critpath_settings = CritpathSettings.from_config(config.critpath)
    fault_plan = _resolve_fault_plan(config, print_progress)
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
    tracer = _start_tracer(config, filename_queue, queues)
    # the SLO budget: the deadline's, else the controller's
    slo_budget_ms = (deadline_settings.budget_ms if deadline_settings
                     else autotune_settings.slo_ms if autotune_settings
                     else None)
    registry, bridge = _start_metrics(
        config, job_id, log_base, filename_queue, queues, queue_size, pager,
        tracer, slo_budget_ms, fault_stats, deadline_stats)
    # installed before the stages are built: they register their poll
    # sources before the start barrier
    metrics_mod.ACTIVE = registry
    num_markers = max(NUM_EXIT_MARKERS,
                      sum(len(g.devices) for g in config.steps[0].groups))

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
            in_queue = (filename_queue if step_idx == 0
                        else queues[step_idx - 1][group.in_queue])
            out_queues = (None if is_final else
                          [queues[step_idx][q] for q in group.out_queues])
            for instance_idx, device in enumerate(group.devices):
                ctx = RunnerContext(
                    in_queue=in_queue, out_queues=out_queues,
                    job_id=job_id, device=device, group_idx=group_idx,
                    instance_idx=instance_idx, counter=counter,
                    num_videos=num_videos, termination=termination,
                    step_idx=step_idx, sta_bar=sta_bar, fin_bar=fin_bar,
                    model_class_path=step.model, model_kwargs=kwargs,
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
                    pager=pager,
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
                    deadline_stats=deadline_stats)
                threads.append(threading.Thread(
                    target=runner, args=(ctx,), daemon=True,
                    name="runner-s%d-g%d-i%d" % (step_idx, group_idx,
                                                 instance_idx)))
    for t in threads:
        t.start()

    profiler = None
    if profile or registry is not None:
        # the profiler and the metrics flusher cover the measured window
        # only: wait until every other party is parked on the start
        # barrier (built, warm, and its poll sources registered)
        while sta_bar.n_waiting < bar_total - 1 and not any(
                not t.is_alive() for t in threads):
            time.sleep(0.01)
    if profile:
        profiler = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        profiler.__enter__()
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
    sta_bar.wait()
    ru_start = resource.getrusage(resource.RUSAGE_SELF)
    launches_start = _kernels.launch_counts()
    time_start = time.time()
    if print_progress:
        print("START! %f" % time_start)
    fin_bar.wait()
    time_end = time.time()
    ru_end = resource.getrusage(resource.RUSAGE_SELF)
    host_cpu_s = ((ru_end.ru_utime + ru_end.ru_stime)
                  - (ru_start.ru_utime + ru_start.ru_stime))
    total_time = time_end - time_start
    kernel_ms = None
    if profiler is not None:
        if config.platform == "cuda":
            torch.cuda.synchronize()
        profiler.__exit__(None, None, None)
        averages = profiler.key_averages()
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
    # every thread has drained: uninstall the tracer (or the bridge)
    # first, so a later run in this process never writes into this job's
    # collector
    trace_mod.ACTIVE = None
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
    device = (torch.cuda.get_device_name(0) if config.platform == "cuda"
              else "cpu")
    cache_stats = aggregate_snapshots(cache_sink) if cache_sink else None
    cache_hit_rows = sum(r.get("cache_hit_rows", 0) for r in ragged_sink)
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
        # the port has no hedging or lane eviction: no row is hedged or
        # redispatched
        critpath_report = critpath_aggregate(
            ((timings, False, 0) for summary in summary_sink
             for timings in summary.steady_rows(NUM_SUMMARY_SKIPS)), lanes)
    autotune_stats = (aggregate_autotune(autotune_sink) if autotune_sink
                      else None)
    faults = fault_stats.snapshot()
    deadline_snap = (deadline_stats.snapshot() if deadline_stats is not None
                     else None)
    metrics_summary = None
    if registry is not None:
        # the final footing snapshot: every thread joined and every
        # ledger above settled, so its counters equal the log-meta lines
        # exactly; also services RNB_FLIGHT_FORCE and writes metrics.prom
        registry.stop()
        metrics_mod.ACTIVE = None
        metrics_summary = registry.summary()
    result = BenchmarkResult(
        job_id=job_id, total_time_s=total_time, num_videos=num_videos,
        termination_flag=int(termination.value),
        throughput_vps=completed / total_time if total_time > 0 else 0.0,
        log_dir=logroot(job_id, base=log_base), device=device,
        p50_latency_ms=pct.get(50.0), p99_latency_ms=pct.get(99.0),
        clips_completed=clips, num_completed=completed,
        pad_rows=pad_rows, total_rows=total_rows,
        window_launches=window_launches, kernel_ms=kernel_ms,
        ragged_cache_hit_rows=cache_hit_rows,
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
    if autotune_stats is not None:
        for key, value in autotune_stats.items():
            setattr(result, "autotune_" + key, value)
    if cache_stats is not None:
        for key in ("hits", "misses", "inserts", "evictions", "coalesced",
                    "oversize", "bytes_resident"):
            setattr(result, "cache_" + key, cache_stats[key])

    with open(logmeta(job_id, base=log_base), "w") as f:
        f.write("Args: %s\n" % json.dumps(dict(
            config=config_path, mean_interval_ms=mean_interval_ms,
            num_videos=num_videos, queue_size=queue_size, seed=seed,
            platform=config.platform)))
        f.write("%f %f\n" % (time_start, time_end))
        f.write("Termination flag: %d\n" % termination.value)
        # the reference's fault lines, byte for byte
        f.write("Faults: num_failed=%d num_shed=%d num_retries=%d\n"
                % (faults["num_failed"], faults["num_shed"],
                   faults["num_retries"]))
        for head, key in (("Failure reasons", "failure_reasons"),
                          ("Shed sites", "shed_sites"),
                          ("Queue overflows", "overflow_sites")):
            if faults[key]:
                f.write("%s: %s\n" % (head, json.dumps(faults[key],
                                                       sort_keys=True)))
        if deadline_snap is not None:
            # parse_utils cross-foots the sites with the deadline-suffixed
            # entries of Shed sites:
            f.write("Deadline: budget_ms=%d expired=%d\n"
                    % (result.deadline_budget_ms, deadline_snap["expired"]))
            if deadline_snap["sites"]:
                f.write("Deadline sites: %s\n" % json.dumps(
                    deadline_snap["sites"], sort_keys=True))
        f.write("Device: %s\n" % device)
        for ingest in ingest_sink:
            # no "=" in these lines: they are names, not counters
            f.write("Pixel path: %s\n" % ingest["pixel_path"])
            f.write("Decode backend: %s\n"
                    % ",".join(sorted(ingest["backends"])))
        # the clip rows the final step completed: every batching stage
        # counts its own rows into Padding: and Ragged:, so a loader
        # followed by a batcher counts a clip twice there
        f.write("Completed: requests=%d clips=%d\n" % (completed, clips))
        f.write("Padding: pad_rows=%d total_rows=%d\n"
                % (pad_rows, total_rows))
        if ragged_sink:
            # one line over every ragged batching stage (a loader, a
            # batcher), as the reference writes it
            f.write("Ragged: pool_rows=%d emissions=%d rows=%d "
                    "pad_rows_eliminated=%d cache_hit_rows=%d\n"
                    % ((max(r["pool_rows"] for r in ragged_sink),)
                       + tuple(sum(r[k] for r in ragged_sink) for k in (
                           "emissions", "rows", "pad_rows_eliminated",
                           "cache_hit_rows"))))
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
        f.write("Kernels: %s\n" % json.dumps(window_launches,
                                             sort_keys=True))
        if kernel_ms is not None:
            f.write("Profile: kernel_ms=%.3f window_ms=%.3f busy_share=%.4f\n"
                    % (kernel_ms, total_time * 1e3,
                       kernel_ms / (total_time * 1e3)))
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="PyTorch/CUDA streaming video-analytics benchmark")
    parser.add_argument("-mi", "--mean_interval_ms", type=int, default=3,
                        help="Mean request interval (Poisson), ms; 0 = "
                             "bulk max-throughput mode")
    parser.add_argument("-v", "--videos", type=int, default=2000,
                        help="Total number of videos to run")
    parser.add_argument("-qs", "--queue_size", type=int, default=50000,
                        help="Max size of inter-stage queues")
    parser.add_argument("-c", "--config_file_path", type=str,
                        default="configs/rnb-fused-yuv-big.json")
    parser.add_argument("--platform", choices=["cuda", "cpu"],
                        default="cuda")
    parser.add_argument("--log-base", type=str, default="logs")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--profile", action="store_true",
                        help="trace the measured window (torch.profiler)")
    args = parser.parse_args(argv)
    result = run_benchmark(
        config_path=args.config_file_path,
        mean_interval_ms=args.mean_interval_ms, num_videos=args.videos,
        queue_size=args.queue_size, log_base=args.log_base,
        seed=args.seed, platform=args.platform, profile=args.profile)
    print("Throughput: %.3f videos/s" % result.throughput_vps)
    print("Logs: %s" % result.log_dir)
    print(json.dumps(asdict(result)))
    return 0 if result.termination_flag == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
