#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rnb_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compile the port's CUDA kernels from ``rnb_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the serving path's shapes (rows 48 and 15, rows_valid = rows, 5,
   0) — the normalize kernel bitwise, the colourspace kernel within one
   u8 step with pad rows exact — and each one's time on the card (the
   profiler's device time per call) beside its bound and its plain
   version's, plus its time per back-to-back call by CUDA events;
4. path: serve ``configs/rnb-fused-yuv-big.json`` and
   ``configs/rnb-fused-yuv-ragged.json`` at full R(2+1)D-18 width on
   cuda:0 over a generated y4m dataset, check that every request
   completed with finite logits, that both kernels were launched, and
   that a few requests' logits agree with a CPU recompute through the
   plain versions on the same seeded weights.

The line before the last is ``nvidia-smi``'s name and power limit; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = ("configs/rnb-fused-yuv-big.json",
           "configs/rnb-fused-yuv-ragged.json")
HW = 112
FRAMES = 8
#: requests served per config on the path phase
VIDEOS_PER_RUN = 48
#: published H100 SXM peaks (NVIDIA data sheet) for the bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: card vs CPU float32 network on the same input: accumulation order
#: only (TF32 off)
F32_ATOL = 1e-3
#: served bf16 logits vs the CPU float32 truth: at most BF16_FACTOR x
#: the CPU's own bf16 error, plus BF16_ATOL (see cpu_recompute)
BF16_FACTOR = 2.0
BF16_ATOL = 1e-2


class SmokeFailure(RuntimeError):
    pass


def check(condition, message):
    if not condition:
        raise SmokeFailure(message)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, "nvidia-smi failed: %s" % out.stderr)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, reps: int = 50, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after a warm-up. A call that is shorter on
    the card than its launch on the host measures the launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    samples.sort()
    return samples[len(samples) // 2]


def device_ms(fn, reps: int = 50) -> float:
    """Time on the card per call: the device time of every kernel the
    profiler records over ``reps`` calls, after a warm-up, over
    ``reps``."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # device-side events only: an operator's own event repeats the time
    # of the kernels it launched
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type != torch.autograd.DeviceType.CPU)
    check(total_us > 0, "the profiler recorded no device time")
    return total_us / reps / 1e3


def phase_kernels(device):
    """Each kernel against its plain version; returns the timing rows
    at the 48-row serving shape and the worst errors."""
    import torch
    from rnb_tpu_torch.ops import preprocess, yuv
    packed_bytes = yuv.packed_frame_bytes(HW, HW)
    gen = torch.Generator().manual_seed(1234)
    worst = {"yuv420_to_rgb_u8": 0, "normalize_u8": 0}
    for rows in (48, 15):
        packed = torch.randint(0, 256, (rows, FRAMES, packed_bytes),
                               generator=gen, dtype=torch.uint8)
        packed = packed.to(device)
        zero_rgb = yuv.yuv420_to_rgb_reference(
            torch.zeros((1, FRAMES, packed_bytes), dtype=torch.uint8,
                        device=device), HW, HW)
        for valid in (rows, 5, 0):
            masked = packed.clone()
            masked[valid:] = 0
            rgb = yuv.yuv420_to_rgb_u8(packed, HW, HW, valid)
            plain_rgb = yuv.yuv420_to_rgb_reference(masked, HW, HW)
            diff = (rgb.int() - plain_rgb.int()).abs()
            err = int(diff.max())
            exact = float((diff == 0).double().mean())
            worst["yuv420_to_rgb_u8"] = max(worst["yuv420_to_rgb_u8"], err)
            check(err <= 1, "yuv420_to_rgb_u8 rows=%d valid=%d differs "
                  "from its plain version by %d u8 steps" % (rows, valid,
                                                            err))
            pads_exact = bool((rgb[valid:] == zero_rgb).all())
            check(pads_exact, "yuv420_to_rgb_u8 rows=%d valid=%d: pad rows "
                  "are not the conversion of zero bytes" % (rows, valid))
            out = preprocess.normalize_u8_rows(rgb, valid)
            plain = preprocess.normalize_u8_reference(rgb)
            plain[valid:] = 0
            bitwise = torch.equal(out.view(torch.int16),
                                  plain.view(torch.int16))
            worst["normalize_u8"] = max(
                worst["normalize_u8"],
                float((out.float() - plain.float()).abs().max()))
            check(bitwise, "normalize_u8 rows=%d valid=%d is not bitwise "
                  "equal to its plain version" % (rows, valid))
            print("kernels rows=%d rows_valid=%d: yuv420_to_rgb_u8 max "
                  "err %d (exact share %.6f, pad rows exact %s); "
                  "normalize_u8 bitwise %s"
                  % (rows, valid, err, exact, pads_exact, bitwise))
    torch.cuda.synchronize()

    rows = 48
    packed = torch.randint(0, 256, (rows, FRAMES, packed_bytes),
                           generator=gen, dtype=torch.uint8).to(device)
    rgb = yuv.yuv420_to_rgb_u8(packed, HW, HW)
    in_k2, out_k2 = packed.numel(), rgb.numel()
    calls = {
        "yuv420_to_rgb_u8": (
            lambda: yuv.yuv420_to_rgb_u8(packed, HW, HW),
            lambda: yuv.yuv420_to_rgb_reference(packed, HW, HW)),
        "normalize_u8": (
            lambda: preprocess.normalize_u8(rgb),
            lambda: preprocess.normalize_u8_reference(rgb)),
    }
    timings = {
        "yuv420_to_rgb_u8": dict(
            bound_bytes=in_k2 + out_k2,
            # per pixel: 4 adds/subs; per 2x2 quad: 4 muls + 2 subs
            bound_ops=4 * out_k2 // 3 + 6 * out_k2 // 12),
        "normalize_u8": dict(
            bound_bytes=rgb.numel() * 3,  # 1 byte in, 2 bytes out
            bound_ops=3 * rgb.numel()),   # mul, sub, mul per element
    }
    for name, row in timings.items():
        kernel, plain = calls[name]
        row["ms"] = device_ms(kernel)
        row["plain_ms"] = device_ms(plain, reps=10)
        row["call_ms"] = call_ms(kernel)
        by_bytes = row["bound_bytes"] / PEAK_BYTES_PER_S * 1e3
        by_ops = row["bound_ops"] / PEAK_F32_FLOPS * 1e3
        row["bound_ms"] = max(by_bytes, by_ops)
        row["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        print("timing %s at %d rows: %.5f ms on the card (plain %.5f ms, "
              "bound %.5f ms by %s); %.5f ms per back-to-back call"
              % (name, rows, row["ms"], row["plain_ms"], row["bound_ms"],
                 row["bound_by"], row["call_ms"]))
    return timings, worst


def cpu_recompute(config_path, sink, picks):
    """Recompute ``picks`` requests on the CPU through the plain
    versions with the same seeded weights, in bfloat16 (as served) and
    in float32; also run the card's network in float32 on the same
    input. Returns a dict of the worst errors and the bounds held.

    bf16 rounds at other places on the card (cuDNN) than on the CPU
    (oneDNN), so the served logits are held to the float32 truth with a
    bound measured on the CPU's own bf16 run of the same input: the
    card may be at most BF16_FACTOR times as far from float32 as the
    CPU's bf16 is, plus BF16_ATOL. The network itself is held tightly
    in float32: card vs CPU within F32_ATOL (no TF32, accumulation
    order only)."""
    import numpy as np
    import torch
    from rnb_tpu_torch.config import load_config
    from rnb_tpu_torch.decode import get_decoder
    from rnb_tpu_torch.models.r2p1d.model import shared_network
    from rnb_tpu_torch.models.r2p1d.sampler import R2P1DSampler
    from rnb_tpu_torch.ops.yuv import normalize_yuv420
    config = load_config(config_path, "cpu")
    max_clips = config.steps[0].kwargs.get("max_clips", 15)
    runner_kwargs = config.steps[-1].kwargs
    arch = (1, runner_kwargs.get("end_index", 5),
            runner_kwargs.get("num_classes", 400),
            tuple(runner_kwargs.get("layer_sizes", (2, 2, 2, 2))))
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    nets = {
        "cpu_bf16": shared_network(*arch, cpu),
        "cpu_f32": shared_network(*arch, cpu, dtype=torch.float32),
        "card_f32": shared_network(*arch, card, dtype=torch.float32)}
    sampler = R2P1DSampler(consecutive_frames=FRAMES)
    report = dict(f32_err=0.0, served_err=0.0, cpu_bf16_err=0.0,
                  bound=0.0, argmax_agreed=0, rows=0, past_margin=0)
    for rid in picks:
        video, served = sink[rid]
        decoder = get_decoder(video)
        starts = sampler.sample(decoder.num_frames(video),
                                video_id=video)[:max_clips]
        packed = torch.from_numpy(decoder.decode_clips_yuv(
            video, starts, FRAMES, HW, HW))
        with torch.inference_mode():
            x_cpu = normalize_yuv420(packed, HW, HW)
            x_card = normalize_yuv420(packed.to(card), HW, HW)
            check(torch.equal(x_card.cpu().view(torch.int16),
                              x_cpu.view(torch.int16)),
                  "request %d: card ingest differs from the plain one"
                  % rid)
            out = {"cpu_bf16": nets["cpu_bf16"](x_cpu).numpy(),
                   "cpu_f32": nets["cpu_f32"](x_cpu).numpy(),
                   "card_f32": nets["card_f32"](x_card).cpu().numpy()}
        truth = out["cpu_f32"]
        check(truth.shape == served.shape, "request %d: cpu logits %s vs "
              "card %s" % (rid, truth.shape, served.shape))
        f32_err = float(np.abs(out["card_f32"] - truth).max())
        check(f32_err <= F32_ATOL, "request %d (%s): card float32 network "
              "differs from the CPU's by %g > %g"
              % (rid, video, f32_err, F32_ATOL))
        cpu_bf16_err = float(np.abs(out["cpu_bf16"] - truth).max())
        bound = BF16_FACTOR * cpu_bf16_err + BF16_ATOL
        served_err = float(np.abs(served - truth).max())
        check(served_err <= bound, "request %d (%s): served logits are %g "
              "from float32, more than the bf16 bound %g"
              % (rid, video, served_err, bound))
        for key, value in (("f32_err", f32_err), ("served_err", served_err),
                           ("cpu_bf16_err", cpu_bf16_err),
                           ("bound", bound)):
            report[key] = max(report[key], value)
        for row_truth, row_served in zip(truth, served):
            same = row_truth.argmax() == row_served.argmax()
            report["argmax_agreed"] += int(same)
            report["rows"] += 1
            top2 = np.sort(row_truth)[-2:]
            if top2[1] - top2[0] > 2 * bound:
                # every served logit is within the bound, so past a
                # 2*bound margin the argmax cannot move
                report["past_margin"] += 1
                check(same, "request %d: argmax differs past the margin"
                      % rid)
    return report


def phase_path(data_root, videos_per_run):
    """Serve both configs on cuda:0; returns per-config launch counts."""
    import numpy as np
    from rnb_tpu_torch.benchmark import run_benchmark
    from rnb_tpu_torch.ops import _kernels
    os.environ["RNB_TPU_DATA_ROOT"] = data_root
    launches = {k.name: 0 for k in _kernels.KERNELS}
    for config in CONFIGS:
        sink = {}
        _kernels.reset_launches()
        t0 = time.time()
        result = run_benchmark(
            os.path.join(HERE, config), mean_interval_ms=0,
            num_videos=videos_per_run, print_progress=False,
            log_base=os.path.join(data_root, "logs"), seed=0,
            outputs_sink=sink)
        counts = _kernels.launch_counts()
        wall = time.time() - t0
        check(result.termination_flag == 0, "%s terminated with flag %d"
              % (config, result.termination_flag))
        check(result.num_completed == videos_per_run,
              "%s completed %d of %d requests"
              % (config, result.num_completed, videos_per_run))
        check(sorted(sink) == list(range(videos_per_run)),
              "%s: outputs of requests %s missing" % (
                  config, sorted(set(range(videos_per_run)) - set(sink))))
        for rid, (video, logits) in sink.items():
            check(logits.ndim == 2 and logits.shape[1] == 400
                  and logits.shape[0] >= 1,
                  "%s request %d: logits of shape %s"
                  % (config, rid, logits.shape))
            check(np.isfinite(logits).all(),
                  "%s request %d: non-finite logits" % (config, rid))
        for name, count in counts.items():
            check(count > 0, "%s: kernel %s was never launched"
                  % (config, name))
            check(result.window_launches[name] > 0,
                  "%s: kernel %s was not launched in the measured window"
                  % (config, name))
            launches[name] += count
        by_clips = sorted(sink, key=lambda r: (sink[r][1].shape[0], r))
        picks = by_clips[:2] + by_clips[-1:]
        report = cpu_recompute(os.path.join(HERE, config), sink, picks)
        print("path %s: %d requests, %d clips, %.3f videos/s, p50 %s ms, "
              "p99 %s ms, wall %.1f s, launches %s (window %s), "
              "pad_rows %d of %d; recompute of requests %s: %s"
              % (config, result.num_completed, result.clips_completed,
                 result.throughput_vps, result.p50_latency_ms,
                 result.p99_latency_ms, wall, counts,
                 result.window_launches, result.pad_rows,
                 result.total_rows, picks, json.dumps(report)))
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "rnb_tpu_torch")) or not all(
            os.path.exists(os.path.join(HERE, c)) for c in CONFIGS):
        print("chip_smoke: run from a checkout of the repo (rnb_tpu_torch/ "
              "and configs/ beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    t_start = time.time()
    data_root = tempfile.mkdtemp(prefix="rnb-smoke-")
    try:
        print("torch %s, CUDA %s, python %s" % (
            torch.__version__, torch.version.cuda, sys.version.split()[0]))
        smi = nvidia_smi_line()
        print("card: %s" % smi)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

        from rnb_tpu_torch.ops import _kernels
        seconds = _kernels.build()
        for source, (secs, log) in _kernels.BUILD_LOG.items():
            print("build %s: %.1f s\n%s" % (source, secs, log.strip()))
        print("build: %s" % json.dumps(seconds))

        device = torch.device("cuda", 0)
        timings, worst = phase_kernels(device)

        from rnb_tpu_torch.dataset import make_dataset
        make_dataset(data_root)
        launches = phase_path(data_root, VIDEOS_PER_RUN)

        rows = []
        for kernel in _kernels.KERNELS:
            t = timings[kernel.name]
            rows.append({
                "name": kernel.name, "route": "cuda",
                "source": "rnb_tpu_torch/csrc/%s" % kernel.source,
                "replaces": kernel.replaces.split(" ")[0],
                "launches": launches[kernel.name],
                "max_abs_err": worst[kernel.name],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None})
        print("total %.1f s" % (time.time() - t_start))
        print(json.dumps({"kernels": rows}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except SmokeFailure as e:
        print("chip_smoke FAILED: %s" % e, file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(data_root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
