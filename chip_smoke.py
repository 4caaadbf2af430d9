#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rnb_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compile the port's CUDA kernels from ``rnb_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the serving paths' shapes (rows 48 and 15, rows_valid = rows, 5,
   0) — the normalize kernel and the dct unpack bitwise, the
   colourspace kernel within one u8 step and the dct convert within two
   (one per quantized plane, carried through BT.601), pad rows exact —
   and each one's time on the card (the profiler's device time per
   call) beside its bound and its plain version's, plus its time per
   back-to-back call by CUDA events;
4. path: serve ``configs/rnb-fused-yuv-big.json`` and
   ``configs/rnb-fused-yuv-ragged.json`` over a generated y4m dataset,
   and ``configs/rnb-fused-dct-ragged.json`` over ``synth://`` ids, at
   full R(2+1)D-18 width on cuda:0; check that every request completed
   with finite logits, that each config launched exactly its pixel
   path's kernels in the measured window, and that a few requests'
   logits agree with a CPU recompute through the plain versions on the
   same seeded weights.

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
           "configs/rnb-fused-yuv-ragged.json",
           "configs/rnb-fused-dct-ragged.json")
#: the kernels each pixel path's ingest launches, and no others
PATH_KERNELS = {"yuv420": {"normalize_u8", "yuv420_to_rgb_u8"},
                "dct": {"dct_unpack", "dct_convert"}}
HW = 112
FRAMES = 8
#: requests served per config on the path phase
VIDEOS_PER_RUN = 48
#: published H100 SXM peaks (NVIDIA data sheet) for the bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: the dct convert vs its plain version, in u8 steps: one per quantized
#: plane where two float32 IDCT summation orders flip floor(p + 128.5),
#: which BT.601 carries into R or B as up to two; and the least share
#: of outputs that must be exact
DCT_STEPS = 2
DCT_EXACT_SHARE = 0.99
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
        time_kernel(name, row, rows, *calls[name])
    return timings, worst


def time_kernel(name, row, rows, kernel, plain):
    """Fill a timing row: device time per call of the kernel and of its
    plain version, time per back-to-back call, and the bound from the
    row's bytes and operations."""
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


def dct_pool(rows, seed):
    """A wire pool of ``rows`` clip rows: synthetic spectra (what the
    serving path's dataset-free arm ships), random well-formed rows over
    all 64 positions, and a random-int16 garbage tail, a third each."""
    import numpy as np
    import torch
    from rnb_tpu_torch.decode import SyntheticDecoder
    from rnb_tpu_torch.ops import dct
    rng = np.random.default_rng(seed)
    nb = dct.num_dct_blocks(HW, HW)
    third = rows // 3
    pool = np.empty((rows, FRAMES, dct.dct_frame_elems(HW, HW)), np.int16)
    pool[:rows - 2 * third] = SyntheticDecoder().decode_clips_dct(
        "synth://smoke-%d" % seed, list(range(rows - 2 * third)), FRAMES,
        HW, HW)
    for r in range(rows - 2 * third, rows - third):
        for f in range(FRAMES):
            zz = np.where(rng.random((nb, 64)) < 0.1,
                          rng.integers(-900, 900, (nb, 64)), 0)
            pool[r, f] = dct.pack_frame_dct(zz, HW, HW)
    pool[rows - third:] = rng.integers(-32768, 32768,
                                       pool[rows - third:].shape)
    return torch.from_numpy(pool)


def to_u8(x):
    """Normalized frames back to u8 steps: (x*255 + 255) / 2."""
    import torch
    return torch.round((x.float() * 255.0 + 255.0) / 2.0)


def phase_kernels_dct(device):
    """The dct unpack and convert against their plain versions; returns
    the timing rows at the dct serving path's 15-row pool and the worst
    errors (the unpack's in coefficient units, the convert's in output
    units)."""
    import torch
    from rnb_tpu_torch.decode import SyntheticDecoder
    from rnb_tpu_torch.ops import dct
    worst = {"dct_unpack": 0, "dct_convert": 0.0}
    for rows in (48, 15):
        pool = dct_pool(rows, seed=rows)
        card = pool.to(device)
        plain_planes = [p.to(device)
                        for p in dct.unpack_dct_rows(pool, HW, HW)]
        for valid in (rows, 5, 0):
            planes = dct.unpack_dct_rows(card, HW, HW, valid)
            err = max(int((got[:valid].long() - want[:valid].long()).abs()
                          .max()) if valid else 0
                      for got, want in zip(planes, plain_planes))
            worst["dct_unpack"] = max(worst["dct_unpack"], err)
            check(err == 0, "dct_unpack rows=%d valid=%d differs from its "
                  "plain version by %d" % (rows, valid, err))
            out = dct.dct_convert(*planes, valid, HW, HW)
            plain = dct.dct_convert_reference(*plain_planes, valid, HW, HW)
            steps = (to_u8(out) - to_u8(plain)).abs()
            max_steps = int(steps.max())
            exact = float((out == plain).double().mean())
            worst["dct_convert"] = max(
                worst["dct_convert"],
                float((out.float() - plain.float()).abs().max()))
            check(max_steps <= DCT_STEPS and exact >= DCT_EXACT_SHARE,
                  "dct_convert rows=%d valid=%d: %d u8 steps from its "
                  "plain version, exact share %.6f" % (rows, valid,
                                                       max_steps, exact))
            pads_zero = not bool(out[valid:].float().any())
            check(pads_zero, "dct_convert rows=%d valid=%d: pad rows are "
                  "not zero" % (rows, valid))
            print("kernels rows=%d rows_valid=%d: dct_unpack bitwise %s; "
                  "dct_convert max %d u8 steps (%d outputs over one, exact "
                  "share %.6f, pad rows zero %s)"
                  % (rows, valid, err == 0, max_steps,
                     int((steps > 1).sum()), exact, pads_zero))
    torch.cuda.synchronize()

    # timing at the serving shape: a full 15-row pool of synthetic spectra
    rows = 15
    wire = torch.from_numpy(SyntheticDecoder().decode_clips_dct(
        "synth://smoke-timing", list(range(rows)), FRAMES, HW, HW))
    card = wire.to(device)
    planes = dct.unpack_dct_rows(card, HW, HW)
    out = dct.dct_convert(*planes, rows, HW, HW)
    nb = dct.num_dct_blocks(HW, HW)
    coeffs = dct.coeffs_from_elems(HW, HW, wire.shape[-1])
    counts = wire[..., :nb].long().clamp(0, 64)
    kept = int(counts.sum(-1).clamp(max=coeffs).sum())
    frames = rows * FRAMES
    plane_bytes = sum(p.numel() * p.element_size() for p in planes)
    pixels = frames * HW * HW
    timings = {
        "dct_unpack": dict(
            # the counts and the kept (value, position) pairs in, every
            # plane slot out
            bound_bytes=frames * nb * 2 + kept * 4 + plane_bytes,
            # per count: clamp and add; per kept entry: clamp, map, store
            bound_ops=2 * frames * nb + 3 * kept),
        "dct_convert": dict(
            bound_bytes=plane_bytes + out.numel() * out.element_size(),
            # two 8-term passes per plane sample (8 mul + 7 add each),
            # the quantize (add, floor, clip) per plane sample, and per
            # pixel BT.601 (10) plus clip, floor, normalize per channel
            bound_ops=pixels * 3 // 2 * (2 * 15 + 4) + pixels * (10 + 18)),
    }
    calls = {
        "dct_unpack": (lambda: dct.unpack_dct_rows(card, HW, HW),
                       lambda: dct.unpack_dct_rows_reference(card, HW, HW)),
        "dct_convert": (
            lambda: dct.dct_convert(*planes, rows, HW, HW),
            lambda: dct.dct_convert_reference(*planes, rows, HW, HW)),
    }
    for name, row in timings.items():
        time_kernel(name, row, rows, *calls[name])
    print("dct wire: %d kept coefficients in %d frames (%.1f per block)"
          % (kept, frames, kept / (frames * nb)))
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
    from rnb_tpu_torch.ops.dct import normalize_dct
    from rnb_tpu_torch.ops.yuv import normalize_yuv420
    config = load_config(config_path, "cpu")
    loader_kwargs = config.steps[0].kwargs
    max_clips = loader_kwargs.get("max_clips", 15)
    pixel_path = loader_kwargs["pixel_path"]
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
        if pixel_path == "dct":
            wire = torch.from_numpy(decoder.decode_clips_dct(
                video, starts, FRAMES, HW, HW,
                loader_kwargs.get("dct_coeffs_per_frame")))
            ingest = normalize_dct
        else:
            wire = torch.from_numpy(decoder.decode_clips_yuv(
                video, starts, FRAMES, HW, HW))
            ingest = normalize_yuv420
        with torch.inference_mode():
            x_cpu = ingest(wire, HW, HW)
            x_card = ingest(wire.to(card), HW, HW).cpu()
            if pixel_path == "dct":
                steps = int((to_u8(x_card) - to_u8(x_cpu)).abs().max())
                exact = float((x_card == x_cpu).double().mean())
                report["ingest_exact_share"] = min(
                    report.get("ingest_exact_share", 1.0), exact)
                check(steps <= DCT_STEPS and exact >= DCT_EXACT_SHARE,
                      "request %d: card ingest is %d u8 steps from the "
                      "plain one (exact share %.6f)" % (rid, steps, exact))
            else:
                check(torch.equal(x_card.view(torch.int16),
                                  x_cpu.view(torch.int16)),
                      "request %d: card ingest differs from the plain one"
                      % rid)
            # the float32 networks see the same input, so they differ by
            # accumulation order only
            out = {"cpu_bf16": nets["cpu_bf16"](x_cpu).numpy(),
                   "cpu_f32": nets["cpu_f32"](x_cpu).numpy(),
                   "card_f32": nets["card_f32"](x_cpu.to(card))
                   .cpu().numpy()}
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
    """Serve every config on cuda:0: the yuv420 ones over the y4m
    dataset, the dct one over synth:// ids (a y4m file holds no DCT
    coefficients). Returns the launches summed over the configs."""
    import numpy as np
    from rnb_tpu_torch.benchmark import run_benchmark
    from rnb_tpu_torch.config import load_config
    from rnb_tpu_torch.ops import _kernels
    launches = {k.name: 0 for k in _kernels.KERNELS}
    for config in CONFIGS:
        pixel_path = load_config(os.path.join(HERE, config),
                                 "cpu").steps[0].kwargs["pixel_path"]
        if pixel_path == "dct":
            os.environ.pop("RNB_TPU_DATA_ROOT", None)
        else:
            os.environ["RNB_TPU_DATA_ROOT"] = data_root
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
            if name in PATH_KERNELS[pixel_path]:
                check(result.window_launches[name] > 0,
                      "%s: kernel %s was not launched in the measured "
                      "window" % (config, name))
            else:
                check(count == 0, "%s: kernel %s of another pixel path "
                      "was launched" % (config, name))
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
        dct_timings, dct_worst = phase_kernels_dct(device)
        timings.update(dct_timings)
        worst.update(dct_worst)

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
