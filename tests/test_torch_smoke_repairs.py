"""What the card smoke (``chip_smoke.py``) relies on to pass run after
run, shown on the CPU.

* The chaos burst's own plan (``rnb_tpu_torch/tools/chaos.py``
  ``--burst``) stalls step 0 briefly, then step 1, on the client's first
  request, which always finds the filename queue empty; with a target
  past what is shed during the stalls, a reduced 1 ms burst into 4-deep
  queues has its client shed and expires requests at step 1's take.
* The smoke's dataset lives under a fixed relative root, so two builds
  serve the same clip mix (the sampler seeds each video's draw with a CRC
  of its path).
* The device observability plane places a capture's ops at the profiler
  session's start on the wall clock (``DevObsPlane.device_events``). The
  reference's rule, the last op at the capture's flush epoch, shifts
  every op of a capture whose pipeline went idle before the window closed
  past its span: a real CPU profiler session below binds no op under it
  and every op under the port's rule.
"""

import json
import os
import queue
import threading
import time

import numpy as np
import pytest
import torch

from rnb_tpu import devobs as jax_devobs
from rnb_tpu_torch import devobs, profiler, trace
from rnb_tpu_torch.dataset import clip_mix, make_dataset
from rnb_tpu_torch.decode import write_y4m
from rnb_tpu_torch.faults import FaultPlan
from rnb_tpu_torch.tools import chaos
from torch_job_checks import assert_both_checks_pass

torch.set_num_threads(2)

#: the idle-tail capture's window, never reached: the test ends it
IDLE_TAIL_WINDOW_S = 60


@pytest.fixture(autouse=True)
def _no_installed_hooks():
    trace.ACTIVE = None
    yield
    trace.ACTIVE = None


# -- the chaos burst ------------------------------------------------------------

def test_the_burst_plan_stalls_both_steps_on_the_first_request():
    plan = FaultPlan(chaos.chaos_config(burst=True)["fault_plan"])
    stalls = [f for f in plan.faults if f["kind"] == "stall"]
    assert sorted((f["step"], list(f["request_ids"]), f["ms"])
                  for f in stalls) == [
        (0, [chaos.BURST_STALL_ID], chaos.BURST_STEP0_STALL_MS),
        (1, [chaos.BURST_STALL_ID], chaos.STALL_MS)]
    assert chaos.BURST_STALL_ID == 0
    assert plan.stall_ms(1, [0, 1, 2]) == chaos.STALL_MS
    assert plan.stall_ms(0, [0]) == chaos.BURST_STEP0_STALL_MS
    assert plan.stall_ms(0, [20, 60]) == plan.stall_ms(1, [20, 60]) == 0
    # the bulk copy keeps its plan
    bulk = FaultPlan(chaos.chaos_config()["fault_plan"])
    assert bulk.stall_ms(1, [chaos.STEP1_STALL_ID]) == chaos.STALL_MS
    assert bulk.stall_ms(0, [chaos.STEP0_STALL_ID]) == chaos.STALL_MS
    assert bulk.stall_ms(1, [0]) == 0
    # the other faults are the bulk copy's
    keep = [f for f in bulk.faults if f["kind"] != "stall"]
    assert [f for f in plan.faults if f["kind"] != "stall"] == keep
    assert chaos.BURST_MIN_TARGET == 2 * chaos.STALL_MS


def test_the_client_admits_its_first_request_into_a_full_burst(tmp_path):
    """The port's Poisson client at a 1 ms mean into a 4-deep queue no
    one drains: request 0 is admitted, later ones shed."""
    from rnb_tpu_torch.client import poisson_client
    from rnb_tpu_torch.control import (FaultStats, InferenceCounter,
                                       TerminationState)
    _dataset(str(tmp_path / "data"), videos=2)
    filename_queue = queue.Queue(4)
    termination, stats = TerminationState(), FaultStats()
    sta, fin = threading.Barrier(2), threading.Barrier(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RNB_TPU_DATA_ROOT", str(tmp_path / "data"))
        thread = threading.Thread(target=poisson_client, args=(
            "rnb_tpu_torch.models.r2p1d.model.R2P1DVideoPathIterator",
            filename_queue, 1, termination, sta, fin, 0, 1), kwargs=dict(
                overload_policy="shed", fault_stats=stats,
                counter=InferenceCounter(), target_num_videos=40))
        thread.start()
        sta.wait()
        deadline = time.time() + 30
        while not termination.terminated and time.time() < deadline:
            time.sleep(0.01)
        fin.wait()
        thread.join()
    first = filename_queue.get_nowait()
    assert first[2].id == chaos.BURST_STALL_ID
    assert stats.snapshot()["num_shed"] == 40


def _dataset(root, videos=6, frames=40):
    rng = np.random.default_rng(0)
    for i in range(videos):
        label = os.path.join(root, "label%d" % (i % 2))
        os.makedirs(label, exist_ok=True)
        write_y4m(os.path.join(label, "v%02d.y4m" % i),
                  rng.integers(0, 256, (frames, 112, 112, 3),
                               dtype=np.uint8), colorspace="420")
    return root


def test_a_reduced_burst_expires_requests_at_step_1_s_take(tmp_path):
    """The burst copy at a CPU-sized runner, a 1 ms Poisson mean into
    queues 4 deep and the smallest target the smoke may give it: the
    client sheds while step 0 stalls, and step 1's stall holds what step
    0 published past the budget."""
    from rnb_tpu_torch.benchmark import run_benchmark
    raw = chaos.chaos_config(burst=True)
    loader, runner = raw["pipeline"]
    loader.update(max_clips=3, row_buckets=[1, 3], fuse=3)
    runner.update(max_rows=3, row_buckets=[1, 3], layer_sizes=[1, 1, 1, 1],
                  num_classes=10)
    path = str(tmp_path / "burst.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RNB_TPU_DATA_ROOT", _dataset(str(tmp_path / "data")))
        result = run_benchmark(
            path, mean_interval_ms=1, num_videos=chaos.BURST_MIN_TARGET,
            queue_size=4, log_base=str(tmp_path / "logs"),
            print_progress=False, seed=0, platform="cpu")
    assert result.termination_flag == 0
    assert result.total_time_s > chaos.STALL_MS / 1000.0
    assert result.deadline_expired >= 1
    assert result.deadline_sites.get("step1_take:deadline_expired", 0) >= 1
    assert result.shed_sites.get("filename_queue", 0) >= 1
    assert result.num_completed + result.num_failed + result.num_shed \
        >= chaos.BURST_MIN_TARGET
    assert_both_checks_pass(result.log_dir)


# -- the fixed dataset root -----------------------------------------------------

def test_the_fixed_root_serves_the_same_clip_mix_in_every_build(tmp_path):
    mixes = []
    cwd = os.getcwd()
    try:
        for build in ("a", "b"):
            os.makedirs(str(tmp_path / build))
            os.chdir(str(tmp_path / build))
            root = os.path.join("data", "smoke")
            make_dataset(root, videos=8)
            broken = chaos.write_chaos_dataset(
                root, os.path.join(root, "chaos-dataset"))
            mixes.append((clip_mix(root), clip_mix(os.path.join(
                root, "chaos-dataset")), broken))
    finally:
        os.chdir(cwd)
    assert mixes[0] == mixes[1]
    base, chaos_mix, broken = mixes[0]
    assert all(not os.path.isabs(path) for path in base)
    assert broken in chaos_mix and len(chaos_mix) == len(base) + 1


# -- device ops aligned at the session's start ----------------------------------

def _capture(interval_s, spans, tail_s):
    """One capture: ``spans`` model_call spans of ``interval_s`` each,
    ops inside them, then the window stays open ``tail_s`` longer."""
    start = 1.7e9
    ops = []
    for i in range(spans):
        t0 = 0.010 + i * interval_s
        ops.append(("conv", int(t0 * 1e9) + 1000,
                    int((t0 + interval_s / 2) * 1e9), "/device:GPU:0"))
    last = max(t1 for _n, _t0, t1, _p in ops)
    t1_epoch = start + last / 1e9 + tail_s
    cap = (0, "forced", start - 0.002, t1_epoch, ops, len(ops), None,
           {"/device:GPU:0": last})
    model_spans = [(start + 0.010 + i * interval_s,
                    start + 0.010 + (i + 1) * interval_s - 1e-6, i)
                   for i in range(spans)]
    return cap, start, model_spans


@pytest.mark.parametrize("tail_s", [0.0, 0.05, 0.5])
def test_session_start_alignment_binds_what_the_flush_anchor_loses(tail_s):
    cap, start, spans = _capture(0.02, 10, tail_s)
    reference = jax_devobs.DevObsPlane(jax_devobs.DevObsSettings())
    reference.captures.append(jax_devobs._Capture(*cap))
    port = devobs.DevObsPlane(devobs.DevObsSettings())
    port.captures.append(devobs._Capture(*cap, start, cap[3]))
    theirs = reference.device_events(spans)
    ours = port.device_events(spans)
    assert [e[5] for e in ours] == list(range(10))
    if tail_s == 0.0:
        # the pipeline worked up to the window's end: both rules agree
        assert [e[2] for e in ours] == pytest.approx([e[2] for e in theirs])
        assert [e[5] for e in theirs] == list(range(10))
    else:
        # an idle tail: the flush anchor moves every op that far late,
        # onto a later request's span or past them all
        assert all(e[5] != op for op, e in enumerate(theirs))
    # without a recorded start the port keeps the reference's rule
    port.captures[0] = devobs._Capture(*cap)
    assert port.device_events(spans) == theirs


def test_ops_outside_the_session_keep_the_flush_anchor():
    """A clock that is not the wall clock puts the ops outside the
    window: the port falls back to the reference's anchor."""
    cap, start, spans = _capture(0.02, 4, 0.2)
    port = devobs.DevObsPlane(devobs.DevObsSettings())
    port.captures.append(devobs._Capture(*cap, start - 50.0, cap[3]))
    reference = jax_devobs.DevObsPlane(jax_devobs.DevObsSettings())
    reference.captures.append(jax_devobs._Capture(*cap))
    assert port.device_events(spans) == reference.device_events(spans)


def test_a_real_capture_of_an_idle_tail_binds_its_ops(tmp_path):
    """A CPU profiler capture whose window outlives the work: ops run
    inside ``exec1.model_call`` spans once the session is up, then an
    idle tail twice as long as the work closes the window. The port
    binds them to their spans; the flush anchor (the reference's rule on
    the same capture) binds none."""
    # a window long enough for the work under any load; the plane's own
    # stop event ends it once an idle tail longer than the work has
    # passed, so the flush anchor moves every op past the last span
    plane = devobs.DevObsPlane(devobs.DevObsSettings(
        capture_window_ms=IDLE_TAIL_WINDOW_S * 1000))
    tracer = trace.Tracer(trace.TraceSettings())
    profiler.warm_up()
    capture = threading.Thread(target=plane._capture_once,
                               args=("forced",))
    capture.start()
    deadline = time.monotonic() + 30.0
    while not profiler._capturing:  # the session is up
        assert capture.is_alive() and time.monotonic() < deadline
        time.sleep(0.005)
    trace.ACTIVE = tracer
    t0 = time.monotonic()
    x = torch.randn(64, 64)
    for rid in range(5):
        with trace.span("exec1.model_call", rid):
            for _ in range(20):
                x = torch.tanh(x @ x)
    trace.ACTIVE = None
    time.sleep(max(0.5, 2 * (time.monotonic() - t0)))
    plane._stop.set()
    capture.join()
    spans = devobs.model_call_spans(tracer.snapshot_events())
    assert len(spans) == 5
    (cap,) = plane.captures
    assert cap.start_epoch is not None and cap.intervals
    assert cap.t0_epoch - 0.05 <= cap.start_epoch <= spans[0][0]
    ours = plane.device_events(spans)
    looped = ("aten::mm", "aten::tanh")
    assert {e[5] for e in ours if e[0] in looped} == set(range(5))
    cap.start_epoch = None
    flush = plane.device_events(spans)
    assert {e[5] for e in flush if e[0] in looped} == {None}
