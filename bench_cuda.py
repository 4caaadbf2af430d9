"""Headline benchmark of the PyTorch/CUDA port: videos/s on one card.

The port's counterpart of ``bench.py``: it serves
``configs/rnb-fused-yuv-big.json`` (the fusing loader decoding packed
4:2:0 planes on the native pool, the yuv420 ingest fused in front of
R(2+1)D-18 in one captured CUDA graph a forward) through
``rnb_tpu_torch.benchmark.run_benchmark``, in bulk or under Poisson
arrivals (``RNB_BENCH_MEAN_INTERVAL_MS``), and prints exactly ONE JSON
line, with ``bench.py``'s keys::

    {"metric": "videos_per_sec", "value": N, "unit": "videos/s",
     "vs_baseline": N / 11.3, "platform": "gpu", "decode_backend": "...",
     "p50_ms": N, "p99_ms": N, "clips_per_sec": N, "gflops_per_clip": N,
     "tflops": N, "mfu": N, ...}

``latency_semantics`` is the config's (``bench.py``'s rule,
:func:`rnb_tpu_torch.devobs.latency_semantics`): "dispatch" where a
stage publishes before its device work ends, else "completion". A run
that ends with a non-zero termination flag (an infeasible Poisson rate
overflowing a queue) prints its line with ``termination_flag`` and an
``error`` beside the numbers, and exits 1, as ``bench.py`` does. On any
other failure it prints the structured error line instead (exit code
1)::

    {"metric": "videos_per_sec", "value": null, "unit": "videos/s",
     "vs_baseline": null, "error": "..."}

The baseline is the upstream project's only published figure: 500
videos in 44.249694 s on one GPU over ``config/r2p1d-whole.json``
(snuspl/rnb, README.md:176-178), 11.3 videos/s; ``vs_baseline`` is
``value / 11.3`` on the card, and null (with a note) on the CPU.

The decode is real: a y4m dataset generated by ``rnb_tpu_torch.dataset``
(44 videos of 128 frames, 112 x 112, 4:2:0), cached under
``data/bench_cuda_y4m`` and decoded on the port's native C++ pool
(``decode_backend`` "native-y4m"). ``RNB_BENCH_DATASET=mjpeg`` serves
compressed input instead, as ``bench.py``'s mode of that name: the same
44 x 128-frame population, written by the port's own encoder
(``rnb_tpu_torch.dataset --format mjpeg``, the JAX package's generator)
at quality 90 (``rnb_tpu_torch.dataset.PIXEL_QUALITY``) under
``data/bench_cuda_mjpeg``, each frame entropy-decoded and inverse-DCT'd
on the native pool (``decode_backend`` "native-mjpeg"). A root holding
both formats is refused: the iterator would serve both while
``decode_backend`` names one. ``gflops_per_clip`` is the analytic
conv+dense count of ``rnb_tpu_torch/models/r2p1d/flops.py`` over the
config's network steps; ``mfu`` divides the achieved rate by the card's
spec-sheet dense bf16 peak, looked up by ``torch.cuda.get_device_name``
(null for a card the table does not know).

Env knobs, as ``bench.py``'s: ``RNB_BENCH_VIDEOS`` (default 10000),
``RNB_BENCH_MEAN_INTERVAL_MS`` (default 0, bulk; above 0 the Poisson
client's mean interval), ``RNB_BENCH_CONFIG``, ``RNB_BENCH_DATASET`` (y4m, mjpeg or synth;
default y4m),
``RNB_TPU_DATA_ROOT`` (an existing dataset instead of the generated
one), ``RNB_BENCH_LOG_BASE`` and ``RNB_BENCH_PLATFORM=cpu`` (serve on the CPU: a smoke of the line,
never a card number). Without a card and without that knob it prints
the error line: it never falls back to the CPU.

Run from the root of a checkout::

    python3 bench_cuda.py
    RNB_BENCH_VIDEOS=300 python3 bench_cuda.py
    RNB_BENCH_MEAN_INTERVAL_MS=6 RNB_BENCH_VIDEOS=2000 python3 bench_cuda.py
    RNB_BENCH_DATASET=mjpeg python3 bench_cuda.py
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys

#: snuspl/rnb README.md:176-178 — 500 videos / 44.249694 s on one GPU
BASELINE_VIDEOS_PER_SEC = 500.0 / 44.249694
#: the generated dataset's geometry (rnb_tpu_torch.dataset.make_dataset):
#: 4 labels x 11 videos, 128 frames each (room for the sampler's largest
#: draw, 15 clips of 8)
DATASET_VIDEOS = 44
DATASET_FRAMES = 128


def _emit(payload: dict) -> None:
    sys.stdout.write(json.dumps(payload) + "\n")
    sys.stdout.flush()


def _emit_error(message: str) -> int:
    _emit({"metric": "videos_per_sec", "value": None, "unit": "videos/s",
           "vs_baseline": None, "error": message[:500]})
    return 1


#: the files of each dataset mode
MODE_EXTENSIONS = {"y4m": (".y4m",), "mjpeg": (".mjpg", ".mjpeg")}
#: a backend's name in ``decode_backend`` where it differs from
#: log-meta's (MJPEG without the native pool decodes through PIL)
BACKEND_NAMES = {"mjpeg": "pil"}


def _count_videos(root: str, *extensions) -> int:
    """Videos the pipeline's iterator would serve under ``root`` (those
    of ``extensions`` only, where given)."""
    from rnb_tpu_torch.video_path_provider import (VIDEO_EXTENSIONS,
                                                   scan_video_tree)
    if not os.path.isdir(root):
        return 0
    return len(scan_video_tree(root, extensions or VIDEO_EXTENSIONS))


def ensure_dataset(repo_dir: str):
    """The decode workload: ``(dataset root or None, mode)``, with
    ``RNB_TPU_DATA_ROOT`` exported for the pipeline's iterator."""
    mode = os.environ.get("RNB_BENCH_DATASET", "y4m")
    if mode == "synth":
        os.environ.pop("RNB_TPU_DATA_ROOT", None)
        return None, mode
    if mode not in MODE_EXTENSIONS:
        raise ValueError("RNB_BENCH_DATASET must be y4m, mjpeg or synth, "
                         "got %r" % mode)
    root = os.environ.get("RNB_TPU_DATA_ROOT") or os.path.join(
        repo_dir, "data", "bench_cuda_" + mode)
    extensions = MODE_EXTENSIONS[mode]
    if _count_videos(root, *extensions) == 0:
        from rnb_tpu_torch.dataset import PIXEL_QUALITY, make_dataset
        if mode == "y4m":
            make_dataset(root, videos=DATASET_VIDEOS, frames=DATASET_FRAMES)
        else:
            make_dataset(root, videos=DATASET_VIDEOS, frames=DATASET_FRAMES,
                         fmt="mjpeg", quality=PIXEL_QUALITY)
    served = _count_videos(root, *extensions)
    if served == 0:
        raise RuntimeError("no videos under %s" % root)
    other = _count_videos(root) - served
    if other:
        raise RuntimeError(
            "dataset root %s holds %d video(s) of another format beside "
            "the %s dataset: the iterator would serve both and "
            "decode_backend would name one; use a single-format root"
            % (root, other, mode))
    os.environ["RNB_TPU_DATA_ROOT"] = root
    return root, mode


def _decode_backend(log_dir: str, mode: str) -> str:
    """What decoded the served requests, from the run's log-meta."""
    if mode == "synth":
        return "synthetic"
    with open(os.path.join(log_dir, "log-meta.txt")) as f:
        backends = {b for line in f.read().splitlines()
                    if line.startswith("Decode backend: ")
                    for b in line.split(": ", 1)[1].split(",")}
    if backends == {"native"}:
        return "native-" + mode
    return "+".join(sorted(BACKEND_NAMES.get(b, b)
                           for b in backends)) + "-" + mode


def measure(config: str, num_videos: int, dataset_root, mode: str,
            platform: str, log_base: str = "logs", seed: int = 0,
            mean_interval_ms: int = 0):
    """Serve one job, in bulk where ``mean_interval_ms`` is 0; -> (the
    evidence line, the termination flag)."""
    import torch
    from rnb_tpu_torch.benchmark import run_benchmark
    from rnb_tpu_torch.devobs import (devices_used, flops_per_clip_for_config,
                                      latency_semantics)
    from rnb_tpu_torch.models.r2p1d.flops import peak_tflops_for
    repo_dir = os.path.dirname(os.path.abspath(__file__))
    with open(config) as f:
        config_dict = json.load(f)
    result = run_benchmark(config_path=config,
                           mean_interval_ms=mean_interval_ms,
                           num_videos=num_videos, log_base=log_base,
                           print_progress=False, seed=seed,
                           platform=platform)
    on_card = platform == "cuda"
    window = result.total_time_s
    line = {
        "metric": "videos_per_sec",
        "value": round(result.throughput_vps, 3),
        "unit": "videos/s",
        "vs_baseline": None,
        "platform": "gpu" if on_card else "cpu",
        "device_kind": result.device,
        "num_devices": torch.cuda.device_count() if on_card else 1,
        "devices_used": devices_used(config_dict),
        "num_videos": num_videos,
        "mean_interval_ms": mean_interval_ms,
        "config": os.path.relpath(config, repo_dir),
        "decode_backend": _decode_backend(result.log_dir, mode),
        "dataset": (os.path.relpath(dataset_root, repo_dir)
                    if dataset_root else None),
        "measured_window_s": round(window, 3),
        "p50_ms": (round(result.p50_latency_ms, 3)
                   if result.p50_latency_ms is not None else None),
        "p99_ms": (round(result.p99_latency_ms, 3)
                   if result.p99_latency_ms is not None else None),
        "latency_semantics": latency_semantics(config_dict),
        "host_cpu_frac": (round(result.host_cpu_s / window, 3)
                          if window > 0 else None),
        # each hand-written kernel's launches in the measured window
        "kernel_launches": result.window_launches,
    }
    flops_per_clip = flops_per_clip_for_config(config_dict)
    clips_per_sec = result.clips_completed / window if window > 0 else 0.0
    tflops = clips_per_sec * flops_per_clip / 1e12
    peak = peak_tflops_for(result.device) if on_card else None
    line.update(
        clips_per_sec=round(clips_per_sec, 3),
        gflops_per_clip=round(flops_per_clip / 1e9, 3),
        tflops=round(tflops, 3),
        peak_tflops_per_device=peak,
        mfu=(round(tflops / (peak * line["devices_used"]), 4)
             if peak else None))
    if on_card:
        line["vs_baseline"] = round(
            result.throughput_vps / BASELINE_VIDEOS_PER_SEC, 3)
    else:
        line["note"] = ("vs_baseline omitted: measured on the CPU, the "
                        "baseline is a GPU's")
    return line, result.termination_flag


def main() -> int:
    repo_dir = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo_dir)
    platform = os.environ.get("RNB_BENCH_PLATFORM", "cuda")
    if platform not in ("cuda", "cpu"):
        return _emit_error("RNB_BENCH_PLATFORM must be cuda or cpu, got %r"
                           % platform)
    try:
        import torch
        if platform == "cuda" and not torch.cuda.is_available():
            return _emit_error("no CUDA device is available (set "
                               "RNB_BENCH_PLATFORM=cpu for a CPU smoke)")
        dataset_root, mode = ensure_dataset(repo_dir)
    except Exception as e:  # one line on any failure
        return _emit_error("dataset preparation failed: %s: %s"
                           % (type(e).__name__, e))
    try:
        num_videos = int(os.environ.get("RNB_BENCH_VIDEOS", "10000"))
        mean_interval_ms = int(os.environ.get("RNB_BENCH_MEAN_INTERVAL_MS",
                                              "0"))
    except ValueError as e:
        return _emit_error("RNB_BENCH_VIDEOS and RNB_BENCH_MEAN_INTERVAL_MS "
                           "must be integers: %s" % e)
    if mean_interval_ms < 0:
        return _emit_error("RNB_BENCH_MEAN_INTERVAL_MS must be >= 0, got %d"
                           % mean_interval_ms)
    config = os.environ.get("RNB_BENCH_CONFIG", os.path.join(
        repo_dir, "configs", "rnb-fused-yuv-big.json"))
    # everything the run prints stays out of the one-line contract
    captured_err = io.StringIO()
    try:
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(captured_err):
            line, termination_flag = measure(
                config, num_videos, dataset_root, mode,
                platform, log_base=os.environ.get("RNB_BENCH_LOG_BASE",
                                                  "logs"),
                mean_interval_ms=mean_interval_ms)
    except Exception as e:  # one line on any failure
        sys.stderr.write(captured_err.getvalue())
        return _emit_error("%s: %s" % (type(e).__name__, e))
    if termination_flag != 0:
        # the numbers stay beside the flag: an infeasible rate is a row
        sys.stderr.write(captured_err.getvalue())
        line.update(termination_flag=termination_flag,
                    error="the run ended with termination flag %d"
                    % termination_flag)
        _emit(line)
        return 1
    _emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
