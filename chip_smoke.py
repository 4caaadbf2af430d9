#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rnb_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compile the port's CUDA kernels from ``rnb_tpu_torch/csrc``,
   and beside them count the dct kernels' SASS instructions by source
   section (``rnb_tpu_torch/tools/sass_counts.py``), printed on ``sass``
   lines before the result;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the serving paths' shapes (rows 48 and 15, rows_valid = rows, 5,
   0, read by the yuv420 kernel and the dct convert from one device
   scalar that is rewritten between launches whose arguments stay the
   same) — the normalize kernel and the dct unpack bitwise, the
   colourspace kernel's u8 entry within one u8 step and its fused
   normalize entry bitwise the normalize kernel of the u8 entry's
   output (bf16; f32 bitwise the plain normalize), both also at a width
   that is not a multiple of 16 (the scalar path), the dct convert
   within two u8 steps (one per quantized plane, carried through
   BT.601), also at a second geometry, pad rows exact; the fused dct
   ingest (the serving path's one dct launch) bitwise the unpack
   followed by the convert at 48 and 15 rows and at the second geometry
   (a garbage wire row among its pad rows), bf16 and f32, and within two
   u8 steps of its plain version — and each one's time on the card (the
   profiler's device time per call; CUDA events around each call, queued
   behind a spin on the card, where no profiler session comes back whole)
   with L2 warm (back-to-back calls on one input) and with L2 flushed
   (256 MB written between calls; only the calls' own events summed)
   beside its bound and its plain version's, plus its time per
   back-to-back call by CUDA events; the
   fused entries' beside the two launches each replaces (the dct ingest
   also at 48 rows);
   The gather kernel is held bitwise to its plain version at the clip
   arena's rows (15 x 8 x 18,816 u8 over a 1,780-row slab) and the
   feature arena's (15 x 400 float32), on five source tables, timed at
   the 15-row clip pool with 8 hits, and on an all-hit table beside
   ``torch.index_select`` of the same table (both with L2 warm and
   flushed), and the clip arena's stream order is checked: a gather
   issued before a write of its page returns the old rows;
   The ragged normalize kernel is held bitwise to its plain version at
   the unfused loader's full-width pool (15 x 8 x 112 x 112 x 3 u8) for
   ``rows_valid`` in {0, 1, 7, 14, 15} read from one device scalar that
   is rewritten between launches whose arguments stay the same, over a
   pool whose tail holds random bytes (pad rows come out zero, so the
   tail was not read into the result), at one odd row size through the
   byte loop, and against the bucketed normalize kernel on the valid
   rows; timed at 15 and at 7 valid rows beside its bounds, its plain
   version and the bucketed kernel at 15 rows;
4. path: serve ``configs/rnb-fused-yuv-big.json`` and
   ``configs/rnb-fused-yuv-ragged.json`` over a generated y4m dataset,
   and ``configs/rnb-fused-dct-ragged.json`` over ``synth://`` ids, at
   full R(2+1)D-18 width on cuda:0, in bulk; then the Zipf cache cells
   under Poisson arrivals: ``configs/rnb-fused-yuv-paged-zipf.json``, a
   copy of it with ``pager.feature_cache`` off (repeats become clip-page
   hits) and ``configs/rnb-fused-yuv-zipf-cache.json``. Check that every
   request completed with finite logits, that each config launched
   exactly its own kernels in the measured window, that a few
   requests' logits (on the features-off copy, a clip-page hit among
   them) agree with a CPU recompute through the plain versions on the
   same seeded weights, that each bulk yuv420 or dct run launched its
   ingest kernel once per emission, that the ``Pages:`` footings hold, that the
   cache answered (feature hits, gathers, blob hits), and that every
   feature hit's logits are bitwise those of its video's first
   serving. Then the unfused multi-step topologies on the rgb path:
   ``configs/r2p1d-whole.json`` (loader -> runner; the bucketed
   normalize in the loader step), a copy of it with the root ``ragged``
   key (the ragged normalize kernel once per emission, the bucketed one
   never), ``configs/r2p1d-whole-yuv.json``,
   ``configs/r2p1d-split-1chip.json`` (a feature map between 1..4 and
   5..5; logits held to the unsplit run's), ``configs/rnb-1chip.json``
   (Large/Small routing into two batchers; at least one six-request
   fused batch) and ``configs/r2p1d-nopipeline-1chip.json`` (class ids
   held to the argmax of the two-step run's logits), each with a CPU
   recompute of two requests where it emits logits.

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
PAGED = "configs/rnb-fused-yuv-paged-zipf.json"
BLOB = "configs/rnb-fused-yuv-zipf-cache.json"
WHOLE = "configs/r2p1d-whole.json"
WHOLE_YUV = "configs/r2p1d-whole-yuv.json"
SPLIT = "configs/r2p1d-split-1chip.json"
RNB = "configs/rnb-1chip.json"
NOPIPELINE = "configs/r2p1d-nopipeline-1chip.json"
CONFIGS = ("configs/rnb-fused-yuv-big.json",
           "configs/rnb-fused-yuv-ragged.json",
           "configs/rnb-fused-dct-ragged.json", PAGED, BLOB,
           WHOLE, WHOLE_YUV, SPLIT, RNB, NOPIPELINE)
#: the paged cell with feature pages off, written next to the dataset
FEATURES_OFF = "paged-zipf-features-off"
#: the unfused whole pipeline under the root ``ragged`` key, likewise
WHOLE_RAGGED = "r2p1d-whole-ragged"
#: a yuv420 emission launches the fused ingest once, and no other ingest
YUV_KERNELS = {"yuv420_normalize"}
#: the ingest kernel each bulk run launches once per emission
ONE_PER_EMISSION = {"configs/rnb-fused-yuv-big.json": "yuv420_normalize",
                    "configs/rnb-fused-yuv-ragged.json": "yuv420_normalize",
                    "configs/rnb-fused-dct-ragged.json": "dct_ingest",
                    WHOLE_YUV: "yuv420_normalize"}
#: the kernels each run launches, and no others
PATH_KERNELS = {CONFIGS[0]: YUV_KERNELS, CONFIGS[1]: YUV_KERNELS,
                CONFIGS[2]: {"dct_ingest"},
                PAGED: YUV_KERNELS | {"gather_rows"},
                FEATURES_OFF: YUV_KERNELS | {"gather_rows"},
                BLOB: YUV_KERNELS,
                WHOLE: {"normalize_u8"},
                WHOLE_RAGGED: {"ragged_normalize_u8"},
                WHOLE_YUV: YUV_KERNELS, SPLIT: {"normalize_u8"},
                RNB: {"normalize_u8"}, NOPIPELINE: {"normalize_u8"}}
#: the runs of the unfused multi-step pipeline, in serving order
UNFUSED = (WHOLE, WHOLE_RAGGED, WHOLE_YUV, SPLIT, RNB, NOPIPELINE)
#: the fused loader of rnb-1chip's small lane fuses this many requests
RNB_BATCH = 6
#: mean Poisson gap of the Zipf runs: repeats then arrive after their
#: video's first forward stored its logits (in bulk the loader admits
#: every request before the first forward ends)
ZIPF_INTERVAL_MS = 25
HW = 112
FRAMES = 8
#: a geometry whose width is not a multiple of 16: the yuv420 kernel's
#: scalar path
ODD_GEOMETRY = (66, 90)
#: a second dct geometry: wider than 128, so the convert's load phase
#: takes two rounds
DCT_GEOMETRY = (64, 176)
#: requests served per config on the path phase
VIDEOS_PER_RUN = 32
#: another topology's logits against the two-step run's for the same
#: request: the same bf16 network at other batch shapes (row tiles, fused
#: batches) or cut at a float32 feature map, so equal up to the
#: convolution algorithm the library picks per shape; each run is held
#: to float32 within about BF16_ATOL by its recompute, two runs to twice
#: that
TWO_STEP_ATOL = 2e-2
#: the single step's class id against the two-step run's logits: it may
#: differ only where the top-2 margin of the summed clip logits is within
#: this much per clip, twice over (twice the largest difference between
#: two topologies' logits that the smoke has shown, 0.002)
CLASS_ID_ATOL = 4e-3
#: bytes written between calls for the L2-flushed times: five times the
#: H100's 50 MB L2
FLUSH_BYTES = 256 << 20
#: profiler sessions tried before CUDA events time a call instead
PROFILER_TRIES = 3
#: the spin that holds the card while the host queues timed calls counts
#: SM cycles; the H100's highest clock is 1.98 GHz, so a lower clock only
#: makes it longer. Each retry doubles it.
SPIN_CYCLES_PER_S = 2e9
SPIN_TRIES = 4
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


#: timing keys a kernel's row carries into the ``kernels`` line where
#: its phase measured them
EXTRA_ROW_KEYS = ("all_hit_ms", "all_hit_ms_l2_flushed",
                  "library_ms_l2_flushed", "tiny_rows_ms",
                  "tiny_rows_ms_l2_flushed", "ms_48", "ms_48_l2_flushed",
                  "bound_ms_48")


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


def profiled(calls, reps: int):
    """``{event name: device us}`` of the device events the profiler
    records while ``calls()`` runs ``reps`` calls and the card is
    synchronized, or None where no session of PROFILER_TRIES came back
    whole: with events, each a multiple of ``reps`` times (a session may
    come back with none, one or two seconds after one that had them)."""
    import torch
    for _ in range(PROFILER_TRIES):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            calls()
            torch.cuda.synchronize()
        # device-side events only: an operator's own event repeats the
        # time of the kernels it launched
        events = [e for e in prof.key_averages()
                  if e.device_type != torch.autograd.DeviceType.CPU]
        if events and all(e.count % reps == 0 for e in events):
            return {e.key: e.self_device_time_total for e in events}
    return None


def device_ms(fn, reps: int = 50) -> float:
    """Time on the card per call, L2 warm: the device time of every
    kernel the profiler records over ``reps`` back-to-back calls, after a
    warm-up, over ``reps``. An input under 50 MB stays in L2. Where the
    profiler records no whole session, CUDA events time the calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = profiled(lambda: [fn() for _ in range(reps)], reps)
    if times is not None:
        return sum(times.values()) / reps / 1e3
    print("note: no profiler session timed the calls whole; CUDA events "
          "time the next row's warm call")
    return events_ms(fn, reps)


def flushed_ms(fn, reps: int = 50) -> float:
    """Time on the card per call with L2 flushed before each call, as a
    serving pool finds it after its copy from the host: FLUSH_BYTES are
    written between calls, and only the device events named as those of
    the calls alone are summed, so the flush's own kernel is not. Where
    the profiler records no whole session, CUDA events time the calls."""
    import torch
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    own = profiled(lambda: [fn() for _ in range(reps)], reps)
    theirs = profiled(lambda: [flush.zero_() for _ in range(reps)], reps)

    def calls():
        for _ in range(reps):
            flush.zero_()
            fn()
    if own is not None and theirs is not None and not own.keys() & theirs:
        both = profiled(calls, reps)
        if both is not None and own.keys() <= both.keys():
            return sum(both[name] for name in own) / reps / 1e3
    print("note: no profiler session timed the calls whole; CUDA events "
          "time the next row's L2-flushed call")
    return events_ms(fn, reps, flush=flush)


def events_ms(fn, reps: int, flush=None) -> float:
    """Time on the card per call: the mean of CUDA event pairs around each
    of ``reps`` calls, after a warm-up, the calls queued behind a spin on
    the card that outlasts the host's queueing of them, so a pair times
    the card's work and not the host's launches; it also holds the gaps
    between the pair and the call's launches (2-4 us more than the
    profiler's time of a 2-17 us kernel on the H100). ``flush``, a
    tensor, is written before each call and outside its pair."""
    import time
    import torch
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]

    def queue():
        for start, end in pairs:
            if flush is not None:
                flush.zero_()
            start.record()
            fn()
            end.record()
    fn()
    torch.cuda.synchronize()
    begin = time.perf_counter()
    queue()
    host_s = time.perf_counter() - begin
    torch.cuda.synchronize()
    for _ in range(SPIN_TRIES):
        torch.cuda._sleep(int(2 * host_s * SPIN_CYCLES_PER_S))
        spun = torch.cuda.Event()
        spun.record()
        queue()
        # the spin still runs: every call was queued before the card
        # reached it
        ahead = not spun.query()
        torch.cuda.synchronize()
        if ahead:
            break
        host_s *= 2
    else:
        print("note: the host fell behind the card while it queued the "
              "calls (a call that waits for the card); their time "
              "includes the host's")
    return sum(start.elapsed_time(end) for start, end in pairs) / reps


def phase_kernels(device):
    """The yuv420 kernel's two entries and the bucketed normalize against
    their plain versions; returns the timing rows at the 48-row serving
    shape and the worst errors."""
    import torch
    from rnb_tpu_torch.ops import _kernels, preprocess, yuv
    packed_bytes = yuv.packed_frame_bytes(HW, HW)
    gen = torch.Generator().manual_seed(1234)
    worst = {"yuv420_to_rgb_u8": 0, "yuv420_normalize": 0.0,
             "normalize_u8": 0}
    # one device scalar, rewritten between launches whose arguments stay
    # the same
    scalar = torch.zeros((1,), dtype=torch.int32, device=device)
    for rows in (48, 15):
        packed = torch.randint(0, 256, (rows, FRAMES, packed_bytes),
                               generator=gen, dtype=torch.uint8)
        packed = packed.to(device)
        zero_rgb = yuv.yuv420_to_rgb_reference(
            torch.zeros((1, FRAMES, packed_bytes), dtype=torch.uint8,
                        device=device), HW, HW)
        before = (_kernels.YUV420_TO_RGB_U8.launches,
                  _kernels.YUV420_NORMALIZE.launches)
        for valid in (rows, 5, 0):
            scalar.fill_(valid)
            masked = packed.clone()
            masked[valid:] = 0
            rgb = yuv.yuv420_to_rgb_u8(packed, HW, HW, scalar)
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
            check(torch.equal(yuv.yuv420_to_rgb_u8(packed, HW, HW, valid),
                              rgb),
                  "yuv420_to_rgb_u8 rows=%d valid=%d: the int form differs "
                  "from the device scalar's" % (rows, valid))
            # the fused entry, bitwise the normalize kernel of the u8
            # entry's output (every row: pads are converted zero bytes)
            fused = yuv.yuv420_normalize(packed, HW, HW, scalar)
            two = preprocess.normalize_u8(rgb)
            fused_bitwise = torch.equal(fused.view(torch.int16),
                                        two.view(torch.int16))
            check(fused_bitwise, "yuv420_normalize rows=%d valid=%d is not "
                  "bitwise normalize_u8 of yuv420_to_rgb_u8" % (rows, valid))
            fused32 = yuv.yuv420_normalize(packed, HW, HW, scalar,
                                           torch.float32)
            check(torch.equal(fused32, preprocess.normalize_u8_reference(
                rgb, torch.float32)), "yuv420_normalize rows=%d valid=%d: "
                  "float32 out is not the normalize of the u8 entry's"
                  % (rows, valid))
            worst["yuv420_normalize"] = max(
                worst["yuv420_normalize"],
                float((fused.float() - preprocess.normalize_u8_reference(
                    plain_rgb).float()).abs().max()))
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
            print("kernels rows=%d rows_valid=%d (device scalar): "
                  "yuv420_to_rgb_u8 max err %d (exact share %.6f, pad rows "
                  "exact %s); yuv420_normalize bitwise normalize_u8 of it "
                  "%s (bf16 and f32); normalize_u8 bitwise %s"
                  % (rows, valid, err, exact, pads_exact, fused_bitwise,
                     bitwise))
        check((_kernels.YUV420_TO_RGB_U8.launches - before[0],
               _kernels.YUV420_NORMALIZE.launches - before[1]) == (6, 6),
              "the yuv420 entries did not count one launch per call")
    # a width that is not a multiple of 16: the scalar path
    height, width = ODD_GEOMETRY
    packed = torch.randint(0, 256, (15, FRAMES, yuv.packed_frame_bytes(
        height, width)), generator=gen, dtype=torch.uint8).to(device)
    for valid in (15, 5):
        scalar.fill_(valid)
        masked = packed.clone()
        masked[valid:] = 0
        rgb = yuv.yuv420_to_rgb_u8(packed, height, width, scalar)
        plain_rgb = yuv.yuv420_to_rgb_reference(masked, height, width)
        err = int((rgb.int() - plain_rgb.int()).abs().max())
        check(err <= 1 and torch.equal(rgb[valid:], plain_rgb[valid:]),
              "yuv420_to_rgb_u8 at %dx%d valid=%d: %d u8 steps from its "
              "plain version or pad rows not exact" % (height, width, valid,
                                                       err))
        fused = yuv.yuv420_normalize(packed, height, width, scalar)
        check(torch.equal(fused.view(torch.int16),
                          preprocess.normalize_u8_reference(rgb)
                          .view(torch.int16)),
              "yuv420_normalize at %dx%d valid=%d is not bitwise the "
              "normalize of the u8 entry's output" % (height, width, valid))
        print("kernels %dx%d (scalar path) rows_valid=%d: yuv420_to_rgb_u8 "
              "max err %d, pad rows exact; yuv420_normalize bitwise the "
              "normalize of it" % (height, width, valid, err))
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
        "yuv420_normalize": (
            lambda: yuv.yuv420_normalize(packed, HW, HW),
            lambda: preprocess.normalize_u8_reference(
                yuv.yuv420_to_rgb_reference(packed, HW, HW))),
        "normalize_u8": (
            lambda: preprocess.normalize_u8(rgb),
            lambda: preprocess.normalize_u8_reference(rgb)),
    }
    # per pixel: 4 adds/subs; per 2x2 quad: 2 subs + 4 muls
    yuv_ops = 4 * out_k2 // 3 + 6 * out_k2 // 12
    timings = {
        "yuv420_to_rgb_u8": dict(bound_bytes=in_k2 + out_k2,
                                 bound_ops=yuv_ops),
        # packed planes in, bf16 out; the conversion plus mul, sub, mul
        # per element
        "yuv420_normalize": dict(bound_bytes=in_k2 + 2 * out_k2,
                                 bound_ops=yuv_ops + 3 * out_k2),
        "normalize_u8": dict(
            bound_bytes=rgb.numel() * 3,  # 1 byte in, 2 bytes out
            bound_ops=3 * rgb.numel()),   # mul, sub, mul per element
    }
    for name, row in timings.items():
        time_kernel(name, row, rows, *calls[name])
    row = timings["yuv420_normalize"]
    def two():
        return preprocess.normalize_u8(yuv.yuv420_to_rgb_u8(packed, HW, HW))
    row["two_launch_ms"] = device_ms(two)
    row["two_launch_ms_l2_flushed"] = flushed_ms(two)
    print("timing yuv420_normalize at %d rows: %.5f ms (L2 flushed %.5f ms) "
          "for the work of yuv420_to_rgb_u8 + normalize_u8, which take "
          "%.5f ms (L2 flushed %.5f ms) as two launches (bound %.5f ms)"
          % (rows, row["ms"], row["ms_l2_flushed"], row["two_launch_ms"],
             row["two_launch_ms_l2_flushed"], row["bound_ms"]))
    return timings, worst


def bound(bound_bytes, bound_ops):
    """(ms, "bytes" or "operations"): the least time the card could
    take, from the bytes moved and the operations done."""
    by_bytes = bound_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = bound_ops / PEAK_F32_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def time_kernel(name, row, rows, kernel, plain):
    """Fill a timing row: device time per call of the kernel with L2
    warm and with L2 flushed, and of its plain version, time per
    back-to-back call, and the bound from the row's bytes and
    operations."""
    row["ms"] = device_ms(kernel)
    row["ms_l2_flushed"] = flushed_ms(kernel)
    row["plain_ms"] = device_ms(plain, reps=10)
    row["call_ms"] = call_ms(kernel)
    row["bound_ms"], row["bound_by"] = bound(row["bound_bytes"],
                                             row["bound_ops"])
    print("timing %s at %d rows: %.5f ms on the card, L2 warm (share "
          "%.3f), %.5f ms with L2 flushed (share %.3f); plain %.5f ms, "
          "bound %.5f ms by %s; %.5f ms per back-to-back call"
          % (name, rows, row["ms"], row["bound_ms"] / row["ms"],
             row["ms_l2_flushed"], row["bound_ms"] / row["ms_l2_flushed"],
             row["plain_ms"], row["bound_ms"], row["bound_by"],
             row["call_ms"]))


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


def check_dct_ingest(wire, scalar, valid, two, height, width, dtype):
    """The fused ingest on ``wire`` with ``rows_valid`` from the device
    ``scalar`` (holding ``valid``): bitwise ``two`` (the unpack and the
    convert kernels' output), within DCT_STEPS of its plain version with
    at least DCT_EXACT_SHARE exact, pad rows zero. Returns (max abs
    error against the plain version, max steps, exact share)."""
    import torch
    from rnb_tpu_torch.ops import dct
    one = dct.ragged_normalize_dct(wire, scalar, height, width, dtype)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    check(torch.equal(one.view(bits), two.view(bits)),
          "dct_ingest rows=%d %dx%d valid=%d %s is not bitwise dct_unpack "
          "followed by dct_convert" % (wire.shape[0], height, width, valid,
                                       dtype))
    plain = dct.dct_ingest_reference(wire, valid, height, width, dtype)
    max_steps = int((to_u8(one) - to_u8(plain)).abs().max())
    exact = float((one == plain).double().mean())
    check(max_steps <= DCT_STEPS and exact >= DCT_EXACT_SHARE
          and not one[valid:].float().any(),
          "dct_ingest rows=%d %dx%d valid=%d %s: %d u8 steps from its plain "
          "version, exact share %.6f, or pad rows not zero"
          % (wire.shape[0], height, width, valid, dtype, max_steps, exact))
    return (float((one.float() - plain.float()).abs().max()), max_steps,
            exact)


def dct_ingest_row(wire, out):
    """The fused ingest's bound at a wire pool: the counts and the kept
    (value, position) pairs in, ``out`` out; the unpack's operations
    (per count: clamp and add; per kept entry: clamp, map, store) and
    the convert's (two 8-term passes per plane sample, 8 mul + 7 add
    each, the quantize -- add, floor, clip -- per plane sample, and per
    pixel BT.601 (10) plus clip, floor, normalize per channel)."""
    from rnb_tpu_torch.ops import dct
    nb = dct.num_dct_blocks(HW, HW)
    coeffs = dct.coeffs_from_elems(HW, HW, wire.shape[-1])
    counts = wire[..., :nb].long().clamp(0, 64)
    kept = int(counts.sum(-1).clamp(max=coeffs).sum())
    frames = wire.shape[0] * wire.shape[1]
    pixels = frames * HW * HW
    return dict(
        bound_bytes=frames * nb * 2 + kept * 4
        + out.numel() * out.element_size(),
        bound_ops=2 * frames * nb + 3 * kept
        + pixels * 3 // 2 * (2 * 15 + 4) + pixels * (10 + 18)), kept


def phase_kernels_dct(device):
    """The dct kernels against their plain versions, and the fused ingest
    bitwise the unpack followed by the convert; returns the timing rows
    at the dct serving path's 15-row pool (the ingest also at 48 rows,
    each beside the two launches it replaces) and the worst errors (the
    unpack's in coefficient units, the others' in output units)."""
    import numpy as np
    import torch
    from rnb_tpu_torch.decode import SyntheticDecoder
    from rnb_tpu_torch.ops import dct
    worst = {"dct_unpack": 0, "dct_convert": 0.0, "dct_ingest": 0.0}
    # one device scalar, rewritten between launches whose arguments stay
    # the same
    scalar = torch.zeros((1,), dtype=torch.int32, device=device)
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
            scalar.fill_(valid)
            out = dct.dct_convert(*planes, scalar, HW, HW)
            check(torch.equal(dct.dct_convert(*planes, valid, HW, HW), out),
                  "dct_convert rows=%d valid=%d: the int form differs from "
                  "the device scalar's" % (rows, valid))
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
            fused = []
            for dtype in (torch.bfloat16, torch.float32):
                two = out if dtype == torch.bfloat16 else dct.dct_convert(
                    *planes, scalar, HW, HW, dtype)
                fused.append(check_dct_ingest(card, scalar, valid, two, HW,
                                              HW, dtype))
                worst["dct_ingest"] = max(worst["dct_ingest"], fused[-1][0])
            print("kernels rows=%d rows_valid=%d: dct_unpack bitwise %s; "
                  "dct_convert (device scalar) max %d u8 steps (%d outputs "
                  "over one, exact share %.6f, pad rows zero %s); "
                  "dct_ingest (device scalar) bitwise dct_unpack + "
                  "dct_convert in bf16 and f32, max %d u8 steps from its "
                  "plain version (exact share %.6f), pad rows zero"
                  % (rows, valid, err == 0, max_steps,
                     int((steps > 1).sum()), exact, pads_zero,
                     max(f[1] for f in fused), min(f[2] for f in fused)))
    # a second geometry, both output dtypes
    height, width = DCT_GEOMETRY
    rng = np.random.default_rng(5)
    nb = dct.num_dct_blocks(height, width)
    wire = np.empty((15, FRAMES, dct.dct_frame_elems(height, width)),
                    np.int16)
    for r in range(15):
        for f in range(FRAMES):
            zz = np.where(rng.random((nb, 64)) < 0.1,
                          rng.integers(-900, 900, (nb, 64)), 0)
            wire[r, f] = dct.pack_frame_dct(zz, height, width)
    wire[14] = rng.integers(-32768, 32768, wire[14].shape)  # garbage row
    wire = torch.from_numpy(wire).to(device)
    for valid in (14, 5):
        scalar.fill_(valid)
        planes = dct.unpack_dct_rows(wire, height, width, valid)
        for dtype in (torch.bfloat16, torch.float32):
            out = dct.dct_convert(*planes, scalar, height, width, dtype)
            plain = dct.dct_convert_reference(*planes, valid, height, width,
                                              dtype)
            max_steps = int((to_u8(out) - to_u8(plain)).abs().max())
            exact = float((out == plain).double().mean())
            check(max_steps <= DCT_STEPS and exact >= DCT_EXACT_SHARE
                  and not out[valid:].float().any(),
                  "dct_convert %dx%d valid=%d %s: %d u8 steps from its "
                  "plain version, exact share %.6f, or pad rows not zero"
                  % (height, width, valid, dtype, max_steps, exact))
            _, fused_steps, fused_exact = check_dct_ingest(
                wire, scalar, valid, out, height, width, dtype)
            print("kernels %dx%d rows_valid=%d (device scalar) %s: "
                  "dct_convert max %d u8 steps, exact share %.6f, pad rows "
                  "zero; dct_ingest bitwise dct_unpack + dct_convert, max "
                  "%d u8 steps from its plain version (exact share %.6f), "
                  "pad rows zero (the garbage row among them)"
                  % (height, width, valid, dtype, max_steps, exact,
                     fused_steps, fused_exact))
    torch.cuda.synchronize()

    # timing at the serving shape: a full 15-row pool of synthetic spectra
    rows = 15
    wire = torch.from_numpy(SyntheticDecoder().decode_clips_dct(
        "synth://smoke-timing", list(range(rows)), FRAMES, HW, HW))
    card = wire.to(device)
    planes = dct.unpack_dct_rows(card, HW, HW)
    out = dct.dct_convert(*planes, rows, HW, HW)
    nb = dct.num_dct_blocks(HW, HW)
    ingest, kept = dct_ingest_row(wire, out)
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
        "dct_ingest": ingest,
    }
    calls = {
        "dct_unpack": (lambda: dct.unpack_dct_rows(card, HW, HW),
                       lambda: dct.unpack_dct_rows_reference(card, HW, HW)),
        "dct_convert": (
            lambda: dct.dct_convert(*planes, rows, HW, HW),
            lambda: dct.dct_convert_reference(*planes, rows, HW, HW)),
        "dct_ingest": (
            lambda: dct.normalize_dct(card, HW, HW),
            lambda: dct.dct_ingest_reference(card, rows, HW, HW)),
    }
    for name, row in timings.items():
        time_kernel(name, row, rows, *calls[name])
    print("dct wire: %d kept coefficients in %d frames (%.1f per block)"
          % (kept, frames, kept / (frames * nb)))

    # the fused ingest beside the two launches it replaces, at 15 rows
    # and at the yuv420 kernel's 48
    row = timings["dct_ingest"]
    big = torch.from_numpy(SyntheticDecoder().decode_clips_dct(
        "synth://smoke-timing-48", list(range(48)), FRAMES, HW, HW))
    big_card = big.to(device)
    big_row, _ = dct_ingest_row(big, dct.normalize_dct(big_card, HW, HW))
    for suffix, pool in (("", card), ("_48", big_card)):
        def two(pool=pool):
            return dct.dct_convert(*dct.unpack_dct_rows(pool, HW, HW),
                                   int(pool.shape[0]), HW, HW)

        def one(pool=pool):
            return dct.normalize_dct(pool, HW, HW)
        if suffix:
            row["ms_48"] = device_ms(one)
            row["ms_48_l2_flushed"] = flushed_ms(one)
            row["bound_ms_48"], _ = bound(big_row["bound_bytes"],
                                          big_row["bound_ops"])
        row["two_kernel_ms" + suffix] = device_ms(two)
        row["two_kernel_ms_l2_flushed" + suffix] = flushed_ms(two)
        print("timing dct_ingest at %d rows: %.5f ms (L2 flushed %.5f ms) "
              "for the work of dct_unpack + dct_convert, which take %.5f ms "
              "(L2 flushed %.5f ms) as two launches (bound %.5f ms)"
              % (int(pool.shape[0]), row["ms" + suffix],
                 row["ms%s_l2_flushed" % suffix],
                 row["two_kernel_ms" + suffix],
                 row["two_kernel_ms_l2_flushed" + suffix],
                 row["bound_ms" + suffix]))
    return timings, worst


def gather_tables(pool_rows, slab_rows, seed):
    """The source tables the gather is held on: all sentinels, all hits,
    mixed, duplicate sources, and the slab's last row."""
    import numpy as np
    rng = np.random.default_rng(seed)
    mixed = rng.integers(-1, slab_rows, pool_rows).astype(np.int32)
    return {"all_miss": np.full(pool_rows, -1, np.int32),
            "all_hit": rng.integers(0, slab_rows, pool_rows).astype(np.int32),
            "mixed": mixed,
            "duplicates": np.where(mixed >= 0, 3, -1).astype(np.int32),
            "last_row": np.where(np.arange(pool_rows) % 2, slab_rows - 1,
                                 -1).astype(np.int32)}


def check_arena_order(device):
    """A gather issued, its plan released, its page evicted and
    rewritten by an insert, with no host sync between: the gather must
    return the old rows (the arena runs gathers and writes on one
    stream, in order)."""
    import numpy as np
    import torch
    from rnb_tpu_torch.cache import ClipCache
    from rnb_tpu_torch.pager import Pager, PagerSettings
    row = (FRAMES, 18816)
    pager = Pager(PagerSettings(page_rows=1))
    arena = pager.create_arena("clips", row, torch.uint8,
                               budget_bytes=FRAMES * 18816, device=device)
    cache = ClipCache(1.0, device=device)
    cache.attach_arena(arena)
    rng = np.random.default_rng(3)
    for trial in range(10):
        old, new = (torch.from_numpy(rng.integers(
            0, 256, (1,) + row, dtype=np.uint8)).to(device)
            for _ in range(2))
        check(cache.insert_pages(("old", trial), old, 0, 1),
              "order check: insert refused")
        plan = cache.acquire(("old", trial))
        out = arena.gather(torch.zeros((15,) + row, dtype=torch.uint8,
                                       device=device),
                           np.full(15, plan.src_rows[0], np.int32))
        plan.release()
        check(cache.insert_pages(("new", trial), new, 0, 1),
              "order check: the page was not reused")
        torch.cuda.synchronize()
        check(torch.equal(out, old.expand((15,) + row)),
              "order check: a write overtook an earlier gather of its page")
        check(torch.equal(arena._slab[0], new[0]),
              "order check: the write did not land")
        cache.acquire(("new", trial)).release()
        with pager.lock:
            cache._entries.clear()
            arena.free_locked((0,))
    print("kernels gather_rows: stream order held in 10 trials (gather, "
          "release, evict, rewrite, no host sync)")


def phase_kernels_gather(device):
    """The gather against its plain version, bitwise, at the clip and
    feature arenas' rows; returns its timing row at the 15-row clip pool
    with 8 hits and the worst error."""
    import numpy as np
    import torch
    from rnb_tpu_torch.ops.pages import gather_rows, gather_rows_reference
    gen = torch.Generator().manual_seed(99)
    worst = 0.0
    clip_slab_rows = 445  # the clip arena of cache_mb 256: 445 rows/page 4
    cases = (
        ("clip u8", torch.randint(0, 256, (15, FRAMES, 18816),
                                  generator=gen, dtype=torch.uint8),
         torch.randint(0, 256, (clip_slab_rows * 4, FRAMES, 18816),
                       generator=gen, dtype=torch.uint8)),
        ("feature f32", torch.randn((15, 400), generator=gen),
         torch.randn((4096, 400), generator=gen)))
    for what, pool, slab in cases:
        pool, slab = pool.to(device), slab.to(device)
        for name, src in gather_tables(15, int(slab.shape[0]), 5).items():
            out = gather_rows(pool, slab, src)
            plain = gather_rows_reference(pool, slab, src)
            bitwise = bool(torch.equal(
                out.view(torch.uint8) if out.dtype != torch.uint8 else out,
                plain.view(torch.uint8) if plain.dtype != torch.uint8
                else plain))
            worst = max(worst, float((out.float() - plain.float()).abs()
                                     .max()))
            check(bitwise, "gather_rows %s table %s is not bitwise equal "
                  "to its plain version" % (what, name))
            print("kernels gather_rows %s %s, table %s, over %d slab rows: "
                  "bitwise %s" % (what, tuple(pool.shape), name,
                                  int(slab.shape[0]), bitwise))
    torch.cuda.synchronize()
    check_arena_order(device)

    # timing at the serving shape: a 15-row clip pool, 8 rows hit
    pool, slab = cases[0][1].to(device), cases[0][2].to(device)
    src = np.full(15, -1, np.int32)
    src[:8] = np.arange(0, 8 * 97, 97)
    table = torch.from_numpy(src).to(device)
    all_hit = torch.from_numpy(np.arange(0, 15 * 97, 97)).to(device)
    all_hit32 = all_hit.int()
    row_bytes = FRAMES * 18816
    row = dict(bound_bytes=15 * row_bytes * 2 + src.nbytes, bound_ops=0)
    time_kernel("gather_rows", row, 15,
                lambda: gather_rows(pool, slab, table),
                lambda: gather_rows_reference(pool, slab, table))
    # the library yardstick like for like: one torch.index_select of the
    # all-hit table beside the kernel on the same table, both with L2
    # warm and flushed
    def library():
        return torch.index_select(slab, 0, all_hit)

    def kernel_all_hit():
        return gather_rows(pool, slab, all_hit32)
    # the fixed cost: the same launch and table at 16-byte rows (the
    # table's read, the launch and one dependent row load)
    tiny_pool = pool.reshape(15, -1)[:, :16].contiguous()
    tiny_slab = slab.reshape(slab.shape[0], -1)[:, :16].contiguous()

    def kernel_tiny():
        return gather_rows(tiny_pool, tiny_slab, table)
    row["tiny_rows_ms"] = device_ms(kernel_tiny)
    row["tiny_rows_ms_l2_flushed"] = flushed_ms(kernel_tiny)
    print("timing gather_rows at 16-byte rows, the same table: %.5f ms "
          "(L2 flushed %.5f ms)" % (row["tiny_rows_ms"],
                                    row["tiny_rows_ms_l2_flushed"]))
    row["library_ms"] = device_ms(library)
    row["library_ms_l2_flushed"] = flushed_ms(library)
    row["all_hit_ms"] = device_ms(kernel_all_hit)
    row["all_hit_ms_l2_flushed"] = flushed_ms(kernel_all_hit)
    print("timing gather_rows on an all-hit table: %.5f ms (L2 flushed "
          "%.5f ms); torch.index_select (library) on it %.5f ms (L2 "
          "flushed %.5f ms)"
          % (row["all_hit_ms"], row["all_hit_ms_l2_flushed"],
             row["library_ms"], row["library_ms_l2_flushed"]))
    return {"gather_rows": row}, {"gather_rows": worst}


def phase_kernels_ragged(device):
    """The ragged normalize against its plain version, bitwise, at the
    unfused loader's 15-row pool; returns its timing row at 15 valid
    rows (7 beside it) and the worst error."""
    import torch
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.ops.preprocess import normalize_u8
    from rnb_tpu_torch.ops.ragged import (ragged_normalize_u8,
                                          ragged_normalize_u8_reference)
    gen = torch.Generator().manual_seed(77)
    rows = 15
    # every row random, so the tail past rows_valid is garbage
    pool = torch.randint(0, 256, (rows, FRAMES, HW, HW, 3), generator=gen,
                         dtype=torch.uint8).to(device)
    odd = torch.randint(0, 256, (rows, 1001), generator=gen,
                        dtype=torch.uint8).to(device)
    bucketed = normalize_u8(pool)
    scalar = torch.zeros((1,), dtype=torch.int32, device=device)
    worst = 0.0
    for what, x in (("clip pool", pool), ("odd rows", odd)):
        before = _kernels.RAGGED_NORMALIZE_U8.launches
        for valid in (0, 1, 7, 14, 15):
            # the same launch arguments every time: only the scalar on
            # the card changes
            scalar.fill_(valid)
            out = ragged_normalize_u8(x, scalar)
            plain = ragged_normalize_u8_reference(x, valid)
            bitwise = torch.equal(out.view(torch.int16),
                                  plain.view(torch.int16))
            worst = max(worst, float((out.float() - plain.float()).abs()
                                     .max()))
            check(bitwise, "ragged_normalize_u8 %s rows_valid=%d is not "
                  "bitwise equal to its plain version" % (what, valid))
            pads_zero = not bool(out[valid:].float().any())
            check(pads_zero, "ragged_normalize_u8 %s rows_valid=%d: pad "
                  "rows are not zero" % (what, valid))
            same_as_k1 = x is not pool or torch.equal(
                out[:valid].view(torch.int16),
                bucketed[:valid].view(torch.int16))
            check(same_as_k1, "ragged_normalize_u8 rows_valid=%d: valid "
                  "rows differ from normalize_u8's" % valid)
            print("kernels ragged_normalize_u8 %s %s rows_valid=%d (device "
                  "scalar): bitwise %s, pad rows zero %s, valid rows equal "
                  "normalize_u8 %s" % (what, tuple(x.shape), valid, bitwise,
                                       pads_zero, same_as_k1))
        check(_kernels.RAGGED_NORMALIZE_U8.launches == before + 5,
              "ragged_normalize_u8 did not count one launch per call")
    torch.cuda.synchronize()

    per_row = pool[0].numel()
    row = dict(bound_bytes=rows * per_row * 3, bound_ops=3 * rows * per_row)
    scalar.fill_(rows)
    time_kernel("ragged_normalize_u8", row, rows,
                lambda: ragged_normalize_u8(pool, scalar),
                lambda: ragged_normalize_u8_reference(pool, scalar))
    # 7 valid rows: 7 rows read, 15 written
    scalar.fill_(7)
    row["ms_valid7"] = device_ms(lambda: ragged_normalize_u8(pool, scalar))
    row["bound_ms_valid7"] = ((7 * per_row + rows * per_row * 2)
                              / PEAK_BYTES_PER_S * 1e3)
    row["k1_ms_15_rows"] = device_ms(lambda: normalize_u8(pool))
    print("timing ragged_normalize_u8 at 7 valid rows of 15: %.5f ms "
          "(bound %.5f ms); normalize_u8 at the same 15 rows: %.5f ms"
          % (row["ms_valid7"], row["bound_ms_valid7"],
             row["k1_ms_15_rows"]))
    return {"ragged_normalize_u8": row}, {"ragged_normalize_u8": worst}


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
    from rnb_tpu_torch.ops.preprocess import normalize_u8
    from rnb_tpu_torch.ops.yuv import normalize_yuv420
    config = load_config(config_path, "cpu")
    loader_kwargs = config.steps[0].kwargs
    max_clips = loader_kwargs.get("max_clips", 15)
    pixel_path = loader_kwargs.get("pixel_path", "rgb")
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
        video, served, _stamps = sink[rid]
        decoder = get_decoder(video)
        starts = sampler.sample(decoder.num_frames(video),
                                video_id=video)[:max_clips]
        if pixel_path == "dct":
            wire = torch.from_numpy(decoder.decode_clips_dct(
                video, starts, FRAMES, HW, HW,
                loader_kwargs.get("dct_coeffs_per_frame")))
            ingest = normalize_dct
        elif pixel_path == "yuv420":
            wire = torch.from_numpy(decoder.decode_clips_yuv(
                video, starts, FRAMES, HW, HW))
            ingest = normalize_yuv420
        else:
            wire = torch.from_numpy(decoder.decode_clips(
                video, starts, FRAMES, HW, HW))

            def ingest(frames, _height, _width):
                return normalize_u8(frames)
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


def features_off_copy(data_root) -> str:
    """The paged Zipf cell with ``pager.feature_cache`` off, so repeats
    become clip-page hits: a temporary copy beside the dataset."""
    with open(os.path.join(HERE, PAGED)) as f:
        raw = json.load(f)
    raw["pager"]["feature_cache"] = False
    path = os.path.join(data_root, FEATURES_OFF + ".json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def whole_ragged_copy(data_root) -> str:
    """The unfused whole pipeline under the root ``ragged`` key, so the
    loader's step runs the ragged normalize kernel: a temporary copy
    beside the dataset."""
    with open(os.path.join(HERE, WHOLE)) as f:
        raw = json.load(f)
    raw["ragged"] = {"enabled": True}
    path = os.path.join(data_root, WHOLE_RAGGED + ".json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def check_unfused_run(label, result, sink, whole_sink):
    """The unfused runs' own checks against the two-step run of the same
    requests (``whole_sink``): one ragged-normalize launch per emission,
    the split pipeline's logits, the batcher's fused batches, the single
    step's class ids."""
    import numpy as np
    from rnb_tpu_torch.parse_utils import read_table
    if label == WHOLE_RAGGED:
        launched = result.window_launches["ragged_normalize_u8"]
        check(launched == result.num_completed,
              "%s: %d ragged_normalize_u8 launches for %d emissions"
              % (label, launched, result.num_completed))
    if label in (WHOLE_RAGGED, SPLIT, RNB):
        worst = 0.0
        for rid, (video, logits, _stamps) in sorted(sink.items()):
            check(video == whole_sink[rid][0], "%s request %d served %s, "
                  "the two-step run %s" % (label, rid, video,
                                           whole_sink[rid][0]))
            worst = max(worst, float(np.abs(
                logits - whole_sink[rid][1]).max()))
        check(worst <= TWO_STEP_ATOL, "%s: logits differ from the two-step "
              "run's by %g > %g" % (label, worst, TWO_STEP_ATOL))
        print("path %s: logits within %g of the two-step run's (bound %g)"
              % (label, worst, TWO_STEP_ATOL))
    if label == RNB:
        tables = [n for n in os.listdir(result.log_dir)
                  if n.endswith("-0.txt")]
        fused = {}
        for name in tables:
            keys, rows = read_table(os.path.join(result.log_dir, name))
            col = keys.index("inference2_start")
            for row in rows:
                fused[row[col]] = fused.get(row[col], 0) + 1
        check(max(fused.values()) == RNB_BATCH,
              "%s: no emission fused %d requests (sizes %s)"
              % (label, RNB_BATCH, sorted(fused.values())))
        print("path %s: %d emissions for %d requests, %d of them fused %d"
              % (label, len(fused), result.num_completed,
                 sum(n == RNB_BATCH for n in fused.values()), RNB_BATCH))
    if label == NOPIPELINE:
        held = 0
        for rid, (video, pred, _stamps) in sorted(sink.items()):
            check(video == whole_sink[rid][0], "%s request %d served "
                  "another video than the two-step run" % (label, rid))
            total = whole_sink[rid][1].sum(axis=0)
            top2 = np.sort(total)[-2:]
            # the batch shapes differ (max shape here, row buckets
            # there): hold the class id past the bf16 margin
            clips = whole_sink[rid][1].shape[0]
            if top2[1] - top2[0] > 2 * CLASS_ID_ATOL * clips:
                check(pred == int(total.argmax()), "%s request %d: class "
                      "id %d, the two-step run's logits say %d"
                      % (label, rid, pred, int(total.argmax())))
                held += 1
        check(held >= len(sink) // 4, "%s: only %d of %d class ids could "
              "be held to the two-step run" % (label, held, len(sink)))
        print("path %s: %d of %d class ids equal the argmax of the "
              "two-step run's summed logits (the rest have a top-2 "
              "margin inside the bound)" % (label, held, len(sink)))


def check_cache_run(label, result, sink):
    """The Zipf runs' own checks: the ``Pages:`` footings, that the
    cache answered, and that every feature hit's logits are bitwise
    its video's first serving's. Returns the rid of a clip-page hit
    (None when the run had none)."""
    from rnb_tpu_torch.parse_utils import footing_problems, read_meta
    meta = read_meta(os.path.join(result.log_dir, "log-meta.txt"))
    problems = footing_problems(meta)
    check(not problems, "%s: %s" % (label, "; ".join(problems)))
    pages = result.pages
    if label == PAGED:
        check(pages["feature_hits"] > 0, "%s: no feature hit" % label)
    elif label == FEATURES_OFF:
        check(pages["gathers"] > 0 and pages["gather_rows"] > 0,
              "%s: no clip-page gather" % label)
    else:
        check(result.cache_hits > 0, "%s: no cache hit" % label)
    first = {}
    for rid in sorted(sink):
        video, logits, stamps = sink[rid]
        if not stamps["feature_hit"]:
            first.setdefault(video, rid)
    feature_hits = 0
    for rid, (video, logits, stamps) in sorted(sink.items()):
        if stamps["feature_hit"]:
            feature_hits += 1
            check(video in first and logits.tobytes()
                  == sink[first[video]][1].tobytes(),
                  "%s request %d: feature-hit logits are not bitwise those "
                  "of request %s, its video's first serving"
                  % (label, rid, first.get(video)))
    page_hits = [rid for rid, (_v, _l, st) in sorted(sink.items())
                 if st["cache_hit"] and label != BLOB]
    print("path %s: Cache: %s; Pages: %s; %d feature hits bitwise equal "
          "to their first serving; %d clip-page hits"
          % (label, json.dumps({k: getattr(result, "cache_" + k) for k in (
              "hits", "misses", "inserts", "evictions", "coalesced")}),
             json.dumps(pages, sort_keys=True), feature_hits,
             len(page_hits)))
    return page_hits[0] if page_hits else None


def phase_path(data_root, videos_per_run):
    """Serve every run on cuda:0: the yuv420 configs over the y4m
    dataset (bulk, then the Zipf cells under Poisson arrivals), the dct
    one over synth:// ids (a y4m file holds no DCT coefficients).
    Returns the launches summed over the runs."""
    import numpy as np
    from rnb_tpu_torch.benchmark import run_benchmark
    from rnb_tpu_torch.config import load_config
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.parse_utils import summarize
    launches = {k.name: 0 for k in _kernels.KERNELS}
    runs = [(c, os.path.join(HERE, c)) for c in CONFIGS]
    runs.insert(4, (FEATURES_OFF, features_off_copy(data_root)))
    runs.insert(runs.index((WHOLE, os.path.join(HERE, WHOLE))) + 1,
                (WHOLE_RAGGED, whole_ragged_copy(data_root)))
    whole_sink = None
    for label, config_path in runs:
        pixel_path = load_config(config_path, "cpu").steps[0].kwargs.get(
            "pixel_path", "rgb")
        if pixel_path == "dct":
            os.environ.pop("RNB_TPU_DATA_ROOT", None)
        else:
            os.environ["RNB_TPU_DATA_ROOT"] = data_root
        zipf = label in (PAGED, FEATURES_OFF, BLOB)
        sink = {}
        _kernels.reset_launches()
        t0 = time.time()
        result = run_benchmark(
            config_path, mean_interval_ms=ZIPF_INTERVAL_MS if zipf else 0,
            num_videos=videos_per_run, print_progress=False,
            log_base=os.path.join(data_root, "logs"), seed=0,
            outputs_sink=sink)
        counts = _kernels.launch_counts()
        wall = time.time() - t0
        check(result.termination_flag == 0, "%s terminated with flag %d"
              % (label, result.termination_flag))
        if zipf:
            # an open-loop client: the run stops once the target is met,
            # and a fused emission may complete a few more requests
            check(result.num_completed >= videos_per_run
                  and len(sink) == result.num_completed,
                  "%s completed %d of %d requests (%d outputs)"
                  % (label, result.num_completed, videos_per_run,
                     len(sink)))
        else:
            check(result.num_completed == videos_per_run,
                  "%s completed %d of %d requests"
                  % (label, result.num_completed, videos_per_run))
            check(sorted(sink) == list(range(videos_per_run)),
                  "%s: outputs of requests %s missing" % (
                      label, sorted(set(range(videos_per_run))
                                    - set(sink))))
        for rid, (video, logits, _stamps) in sink.items():
            if label == NOPIPELINE:
                check(isinstance(logits, int) and 0 <= logits < 400,
                      "%s request %d: class id %r" % (label, rid, logits))
                continue
            check(logits.ndim == 2 and logits.shape[1] == 400
                  and logits.shape[0] >= 1,
                  "%s request %d: logits of shape %s"
                  % (label, rid, logits.shape))
            check(np.isfinite(logits).all(),
                  "%s request %d: non-finite logits" % (label, rid))
        for name, count in counts.items():
            if name in PATH_KERNELS[label]:
                check(result.window_launches[name] > 0,
                      "%s: kernel %s was not launched in the measured "
                      "window" % (label, name))
            else:
                check(count == 0, "%s: kernel %s, not of this config, "
                      "was launched" % (label, name))
            launches[name] += count
        if label in ONE_PER_EMISSION:
            name = ONE_PER_EMISSION[label]
            emissions = summarize(result.log_dir)["emissions"]
            check(result.window_launches[name] == emissions,
                  "%s: %d %s launches for %d emissions"
                  % (label, result.window_launches[name], name, emissions))
        if label == WHOLE:
            whole_sink = sink
        if label in UNFUSED:
            check_unfused_run(label, result, sink, whole_sink)
        if label == NOPIPELINE:
            print("path %s: %d requests, %d clips, %.3f videos/s, wall "
                  "%.1f s, launches %s (window %s), pad_rows %d of %d"
                  % (label, result.num_completed, result.clips_completed,
                     result.throughput_vps, wall, counts,
                     result.window_launches, result.pad_rows,
                     result.total_rows))
            continue
        by_clips = sorted(sink, key=lambda r: (sink[r][1].shape[0], r))
        picks = by_clips[:2] + by_clips[-1:]
        if label in UNFUSED:
            picks = by_clips[:1] + by_clips[-1:]
        if zipf:
            page_hit = check_cache_run(label, result, sink)
            if label == FEATURES_OFF:
                check(page_hit is not None, "%s: no clip-page hit to "
                      "recompute" % label)
                picks = [page_hit] + by_clips[1:2] + by_clips[-1:]
        report = cpu_recompute(config_path, sink, picks)
        print("path %s: %d requests, %d clips, %.3f videos/s, p50 %s ms, "
              "p99 %s ms, wall %.1f s, launches %s (window %s), "
              "pad_rows %d of %d; recompute of requests %s: %s"
              % (label, result.num_completed, result.clips_completed,
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
    sass = None
    try:
        print("torch %s, CUDA %s, python %s" % (
            torch.__version__, torch.version.cuda, sys.version.split()[0]))
        smi = nvidia_smi_line()
        print("card: %s" % smi)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

        from rnb_tpu_torch.ops import _kernels
        # the SASS counts of the dct kernels, by section, built beside the
        # kernels and read at the end
        sass = subprocess.Popen(
            [sys.executable, "-m", "rnb_tpu_torch.tools.sass_counts",
             "--kernel", "dct_ingest_kernel", "--kernel",
             "dct_convert_kernel", "--out-dir",
             os.path.join(data_root, "sass")],
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        seconds = _kernels.build()
        for source, (secs, log) in _kernels.BUILD_LOG.items():
            print("build %s: %.1f s\n%s" % (source, secs, log.strip()))
        print("build: %s" % json.dumps(seconds))

        device = torch.device("cuda", 0)
        timings, worst = phase_kernels(device)
        for phase in (phase_kernels_dct, phase_kernels_gather,
                      phase_kernels_ragged):
            more_timings, more_worst = phase(device)
            timings.update(more_timings)
            worst.update(more_worst)

        from rnb_tpu_torch.dataset import make_dataset
        make_dataset(data_root)
        launches = phase_path(data_root, VIDEOS_PER_RUN)

        sass_out, _ = sass.communicate()
        check(sass.returncode == 0, "sass_counts failed:\n%s" % sass_out)
        for line in sass_out.splitlines():
            report = json.loads(line)
            print("sass %s: %d instructions; by section %s" % (
                report["kernel"], report["total"], json.dumps(
                    {name: section["instructions"] for name, section
                     in sorted(report["sections"].items())})))

        rows = []
        for kernel in _kernels.KERNELS:
            t = timings[kernel.name]
            rows.append({
                "name": kernel.name, "route": "cuda",
                "source": "rnb_tpu_torch/csrc/%s" % kernel.source,
                "replaces": " + ".join(kernel.replaced),
                "launches": launches[kernel.name],
                "max_abs_err": worst[kernel.name],
                "ms": t["ms"], "ms_l2_flushed": t["ms_l2_flushed"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t.get("library_ms"),
                **{key: t[key] for key in EXTRA_ROW_KEYS if key in t}})
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
        if sass is not None and sass.poll() is None:
            sass.kill()
            sass.wait()
        shutil.rmtree(data_root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
