"""Benchmark controller: build the pipeline, drive it, report.

Counterpart of ``rnb_tpu/benchmark.py``. ``run_benchmark`` reads one
of the repo's pipeline configs, starts a client thread and one
executor thread per (step, group, device), opens the measured window
at the start barrier (after every stage built its weights and warmed
up), and closes it when the final step has completed ``num_videos``
requests. It writes ``logs/<job>/log-meta.txt`` and one timing table
per final-step instance, and returns a :class:`BenchmarkResult`.

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
import sys
import threading
import time
from dataclasses import asdict, dataclass, field
from datetime import datetime
from typing import Dict, Optional

import torch

from rnb_tpu_torch.client import bulk_client, poisson_client
from rnb_tpu_torch.config import load_config
from rnb_tpu_torch.control import (NUM_EXIT_MARKERS, EdgeTracker,
                                   InferenceCounter, RingCredits,
                                   TerminationState)
from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.ops.ragged import RaggedSettings
from rnb_tpu_torch.runner import NUM_SUMMARY_SKIPS, RunnerContext, runner
from rnb_tpu_torch.telemetry import latency_percentiles, logmeta, logroot
from rnb_tpu_torch.utils.class_utils import load_class

#: a stage that has not reached a barrier after this long is hung
BARRIER_TIMEOUT_S = 1800.0


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
                  profile: bool = False) -> BenchmarkResult:
    """Programmatic entry used by the CLI, the tests and chip_smoke.py.
    ``outputs_sink``, when given, receives every request's output rows
    (request id -> (video, float32 array)). ``profile`` traces the
    measured window with ``torch.profiler`` (card runs): the sum of
    kernel time lands in the result, each kernel's time and launches in
    ``profile.json``, and the profiler's table in ``profile.txt``."""
    config = load_config(config_path, platform)
    job_id = "%s-mi%d-v%d-qs%d" % (
        datetime.today().strftime("%y%m%d_%H%M%S"), mean_interval_ms,
        num_videos, queue_size)

    ragged = RaggedSettings.from_config(config.ragged)
    bar_total = config.num_runners + 2  # runners + client + controller
    sta_bar = threading.Barrier(bar_total, timeout=BARRIER_TIMEOUT_S)
    fin_bar = threading.Barrier(bar_total, timeout=BARRIER_TIMEOUT_S)
    counter = InferenceCounter()
    termination = TerminationState()
    summary_sink, pad_sink, ragged_sink, staging_sink = [], [], [], []
    if mean_interval_ms == 0:
        # bulk mode pre-enqueues everything (plus the exit markers)
        queue_size = num_videos + config.num_runners + NUM_EXIT_MARKERS + 1
    filename_queue: "queue.Queue" = queue.Queue(queue_size)
    queues, trackers = _pipeline_queues(config, queue_size)
    num_markers = max(NUM_EXIT_MARKERS,
                      sum(len(g.devices) for g in config.steps[0].groups))

    client_args = (config.video_path_iterator, filename_queue,
                   mean_interval_ms if mean_interval_ms > 0 else num_videos,
                   termination, sta_bar, fin_bar, seed, num_markers)
    threads = [threading.Thread(
        target=poisson_client if mean_interval_ms > 0 else bulk_client,
        args=client_args, name="client", daemon=True)]
    for step_idx, step in enumerate(config.steps):
        is_final = step_idx == config.num_steps - 1
        kwargs = dict(step.kwargs)
        if ragged is not None and getattr(load_class(step.model),
                                          "SUPPORTS_RAGGED", False):
            kwargs.update(ragged=True, ragged_pool_rows=ragged.pool_rows)
        for group_idx, group in enumerate(step.groups):
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
                    staging_sink=staging_sink,
                    outputs_sink=outputs_sink if is_final else None)
                threads.append(threading.Thread(
                    target=runner, args=(ctx,), daemon=True,
                    name="runner-s%d-g%d-i%d" % (step_idx, group_idx,
                                                 instance_idx)))
    for t in threads:
        t.start()

    profiler = None
    if profile:
        # trace the measured window only: every other party is parked
        # on the start barrier (warm-up done) before capture begins
        while sta_bar.n_waiting < bar_total - 1 and not any(
                not t.is_alive() for t in threads):
            time.sleep(0.01)
        profiler = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        profiler.__enter__()
    sta_bar.wait()
    launches_start = _kernels.launch_counts()
    time_start = time.time()
    if print_progress:
        print("START! %f" % time_start)
    fin_bar.wait()
    time_end = time.time()
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
    result = BenchmarkResult(
        job_id=job_id, total_time_s=total_time, num_videos=num_videos,
        termination_flag=int(termination.value),
        throughput_vps=completed / total_time if total_time > 0 else 0.0,
        log_dir=logroot(job_id, base=log_base), device=device,
        p50_latency_ms=pct.get(50.0), p99_latency_ms=pct.get(99.0),
        clips_completed=clips, num_completed=completed,
        pad_rows=pad_rows, total_rows=total_rows,
        window_launches=window_launches, kernel_ms=kernel_ms)

    with open(logmeta(job_id, base=log_base), "w") as f:
        f.write("Args: %s\n" % json.dumps(dict(
            config=config_path, mean_interval_ms=mean_interval_ms,
            num_videos=num_videos, queue_size=queue_size, seed=seed,
            platform=config.platform)))
        f.write("%f %f\n" % (time_start, time_end))
        f.write("Termination flag: %d\n" % termination.value)
        f.write("Device: %s\n" % device)
        f.write("Padding: pad_rows=%d total_rows=%d\n"
                % (pad_rows, total_rows))
        for stats in ragged_sink:
            f.write("Ragged: pool_rows=%d emissions=%d rows=%d "
                    "pad_rows_eliminated=%d\n"
                    % (stats["pool_rows"], stats["emissions"],
                       stats["rows"], stats["pad_rows_eliminated"]))
        for snap in staging_sink:
            f.write("Staging: %s\n" % " ".join(
                "%s=%d" % kv for kv in sorted(snap.items())))
        f.write("Kernels: %s\n" % json.dumps(window_launches,
                                             sort_keys=True))
        if kernel_ms is not None:
            f.write("Profile: kernel_ms=%.3f window_ms=%.3f busy_share=%.4f\n"
                    % (kernel_ms, total_time * 1e3,
                       kernel_ms / (total_time * 1e3)))
    if print_progress:
        print("FINISH! %f" % time_end)
        print("Result: %s" % json.dumps(dict(
            videos_per_s=round(result.throughput_vps, 3),
            p50_ms=result.p50_latency_ms, p99_ms=result.p99_latency_ms,
            completed=completed, termination_flag=result.termination_flag,
            device=device, kernel_launches=window_launches,
            kernel_ms=kernel_ms)))
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
