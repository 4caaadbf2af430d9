"""The port's trace plane (``rnb_tpu_torch.trace``, ``hostprof``) held to
the JAX package's.

The same stamps, made from a seed, go through both packages'
``attribute_phases`` (plain cards and merged three-segment cards) and
``phase_of``; the same events through both exporters. A traced CPU run
of ``configs/rnb-fused-yuv-traced.json`` at reduced size (3-row
buckets, layer sizes (1, 1, 1, 1), 10 classes) and of the one-card
segment copy writes a ``trace.json`` that the JAX package's own
``validate_trace`` accepts, whose ``Trace:`` line agrees with the file,
whose every event name is declared in the port's registry, and whose
requests' phases sum to their end-to-end latency. The disabled hooks
return the shared no-op and allocate nothing; the host profiler reports
a section per thread role.
"""

import json
import os
import re
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from rnb_tpu import hostprof as jax_hostprof
from rnb_tpu import telemetry as jax_telemetry
from rnb_tpu import trace as jax_trace
from rnb_tpu_torch import hostprof, trace
from rnb_tpu_torch import telemetry as port_telemetry
from rnb_tpu_torch.decode import write_y4m
from rnb_tpu_torch.parse_utils import attribute, read_meta, summarize
from rnb_tpu_torch.telemetry import (TRACE_EVENT_REGISTRY,
                                     TRACE_STAMP_REGISTRY, TimeCard)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACED = os.path.join(REPO, "configs/rnb-fused-yuv-traced.json")
SEGMENT = os.path.join(REPO, "configs/r2p1d-segment.json")
LS = [1, 1, 1, 1]
REQUESTS = 12

#: one request's stamps through loader (refined), runner and a
#: three-segment runner step into the aggregator
PLAIN_KEYS = ("enqueue_filename", "runner0_start", "inference0_start",
              "decode0_done", "transfer0_start", "transfer0_done",
              "inference0_finish", "runner1_start", "inference1_start",
              "inference1_finish")


def _plain_stamps(seed, refined=True):
    rng = np.random.default_rng(seed)
    keys = [k for k in PLAIN_KEYS
            if refined or not k.startswith(("decode", "transfer"))]
    at = 1.7e9 + np.cumsum(rng.exponential(0.004, len(keys)))
    return dict(zip(keys, at.tolist()))


def _merged_stamps(seed, module):
    """A merged card of three segments, built by ``module``'s TimeCard
    from seeded gaps (the segments overlap in time)."""
    rng = np.random.default_rng(seed)
    card = module.TimeCard(seed)
    t = 1.7e9
    for key in ("enqueue_filename", "runner0_start", "inference0_start",
                "decode0_done", "transfer0_start", "transfer0_done",
                "inference0_finish"):
        t += float(rng.exponential(0.003))
        card.record(key, at=t)
    kids = [card.fork(i) for i in range(3)]
    ends = []
    for kid in kids:
        s = t
        for key in ("runner1_start", "inference1_start",
                    "inference1_finish", "runner2_start",
                    "inference2_start"):
            s += float(rng.exponential(0.005))
            kid.record(key, at=s)
        ends.append(s)
    merged = module.TimeCard.merge(kids)
    merged.record("inference2_finish", at=max(ends) + 1e-4)
    return dict(merged.timings)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", ["plain", "unrefined", "merged"])
def test_attribute_phases_equal_the_reference(kind, seed):
    if kind == "merged":
        stamps = _merged_stamps(seed, jax_telemetry)
        assert stamps == _merged_stamps(seed, port_telemetry)
        assert "inference1_finish-2" in stamps
    else:
        stamps = _plain_stamps(seed, refined=kind == "plain")
    got = trace.attribute_phases(stamps)
    want = jax_trace.attribute_phases(stamps)
    assert got == want
    e2e_ms = (max(stamps.values()) - min(stamps.values())) * 1e3
    assert abs(sum(got.values()) - e2e_ms) <= 1e-3  # 1 us
    if kind == "plain":
        assert set(got) == {"client_queue", "decode", "hold", "transfer",
                            "drain", "inter_stage_queue", "inference1"}


@pytest.mark.parametrize("prev,nxt", [
    ("enqueue_filename", "runner0_start"),
    ("inference0_start", "decode0_done"),
    ("decode0_done", "transfer0_start"),
    ("transfer0_start", "transfer0_done"),
    ("transfer0_done", "inference0_finish"),
    ("inference0_start", "inference0_finish"),
    ("inference0_finish", "runner1_start-2"),
    ("inference1_start-0", "inference1_finish-0"),
    ("inference1_finish-1", "inference1_start-2"),
    ("inference2_start-1", "inference2_finish"),
    ("runner2_start-0", "unknown_stamp"),
])
def test_phase_of_equals_the_reference(prev, nxt):
    assert trace.phase_of(prev, nxt) == jax_trace.phase_of(prev, nxt)
    assert trace._strip_suffix(nxt) == jax_trace._strip_suffix(nxt)


def test_export_equals_the_reference_exporter(tmp_path):
    rng = np.random.default_rng(3)
    events = []
    for i in range(40):
        t0 = 1.7e9 + float(rng.uniform(0, 1))
        kind = ("X", "i", "C")[i % 3]
        events.append(("exec%d.model_call" % (i % 2), kind, t0,
                       0.002 if kind == "X" else 0.0,
                       ("client", "runner-s0-g0-i0", "rnb-transfer")[i % 3],
                       i % 5 if kind != "C" else None,
                       {"value": i} if kind == "C" else None))
    for module, name in ((trace, "port.json"), (jax_trace, "ref.json")):
        assert module.export_events(events, 2, str(tmp_path / name),
                                    "job") == 40
    with open(tmp_path / "port.json") as f:
        port = json.load(f)
    with open(tmp_path / "ref.json") as f:
        ref = json.load(f)
    assert port == ref
    assert jax_trace.validate_trace(str(tmp_path / "port.json")) == []


def test_tracer_is_bounded_and_counts_what_it_drops(tmp_path):
    tracer = trace.Tracer(trace.TraceSettings(max_events=5, sample_hz=0))
    for i in range(8):
        with tracer.span("exec1.model_call", rid=i):
            pass
    assert tracer.num_events() == 5 and tracer.dropped == 3
    path = str(tmp_path / "trace.json")
    assert tracer.export(path, "job") == 5
    with open(path) as f:
        other = json.load(f)["otherData"]
    assert other["dropped_events"] == 3 and other["num_events"] == 5
    assert jax_trace.validate_trace(path) == []


def test_sampler_polls_its_sources_and_survives_a_dying_one():
    tracer = trace.Tracer(trace.TraceSettings(sample_hz=200))
    tracer.add_counter_source("queue.filename.depth", lambda: 3)
    tracer.add_counter_source("queue.e0.depth", lambda: 1 / 0)
    tracer.start_sampler()
    try:
        deadline = 200
        while tracer.num_events() < 3 and deadline:
            threading.Event().wait(0.01)
            deadline -= 1
    finally:
        tracer.stop_sampler()
    assert tracer.num_events() >= 3


# -- the disabled hooks ------------------------------------------------

def test_disabled_hooks_return_the_shared_no_op_and_allocate_nothing(
        monkeypatch):
    monkeypatch.setattr(trace, "ACTIVE", None)
    monkeypatch.setattr(hostprof, "ENABLED", False)
    assert trace.span("exec1.model_call") is trace._NULL
    assert trace.span("exec1.model_call", rid=3) is trace._NULL
    assert hostprof.section("exec1.model_call") is hostprof._NULL
    assert trace.instant("loader.decode_ready", rid=1) is None
    assert trace.counter("client.enqueued", 1) is None
    name = trace.name("exec%d.model_call", 1)

    def hot_loop():
        for rid in range(2000):
            with hostprof.section(name), trace.span(name, rid):
                pass
            trace.instant(name, rid=rid)
            trace.counter(name, rid)

    hot_loop()  # warm any lazily built state
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        hot_loop()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    hooks = [tracemalloc.Filter(True, trace.__file__),
             tracemalloc.Filter(True, hostprof.__file__)]
    grown = after.filter_traces(hooks).compare_to(
        before.filter_traces(hooks), "lineno")
    assert sum(stat.size_diff for stat in grown) <= 0


# -- the host profiler -------------------------------------------------

def test_hostprof_reports_each_section_per_thread_role(monkeypatch):
    monkeypatch.setattr(hostprof, "ENABLED", True)
    hostprof.reset()

    def work(n):
        for _ in range(n):
            with hostprof.section("loader.transfer"):
                pass

    threads = [threading.Thread(target=work, args=(n,), name=role)
               for n, role in ((3, "runner-s0-g0-i0"), (2, "rnb-transfer"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    hostprof.add("exec1.model_call", 0.5, role="runner-s1-g0-i0")
    by_role = hostprof.snapshot_by_role()
    assert by_role[("loader.transfer", "runner-s0-g0-i0")][1] == 3
    assert by_role[("loader.transfer", "rnb-transfer")][1] == 2
    assert hostprof.totals("loader.", role="rnb-transfer")[1] == 2
    assert hostprof.snapshot()["loader.transfer"][1] == 5
    lines = hostprof.report_lines(1.0)
    assert lines[0].split() == ["section", "total_s", "pct", "calls",
                                "mean_us"]
    assert lines[1].startswith("exec1.model_call")
    # a section hit from two roles gets a per-role block
    assert any("by thread role" in line for line in lines)
    assert any("loader.transfer @rnb-transfer" in line for line in lines)
    # the same accumulation in the reference gives the same table
    hostprof.reset()
    jax_hostprof.reset()
    for module in (hostprof, jax_hostprof):
        module.add("exec1.model_call", 0.5, role="runner-s1-g0-i0")
        module.add("exec1.model_call", 0.25, role="runner-s1-g0-i1")
    assert hostprof.report_lines(2.0) == jax_hostprof.report_lines(2.0)
    jax_hostprof.reset()
    hostprof.reset()


# -- traced runs -------------------------------------------------------

def _dataset(root, videos=6, frames=40):
    rng = np.random.default_rng(0)
    for i in range(videos):
        label = os.path.join(root, "label%d" % (i % 2))
        os.makedirs(label, exist_ok=True)
        write_y4m(os.path.join(label, "v%02d.y4m" % i),
                  rng.integers(0, 256, (frames, 112, 112, 3),
                               dtype=np.uint8), colorspace="420")
    return root


def _reduced_traced(tmp):
    with open(TRACED) as f:
        raw = json.load(f)
    loader, runner = raw["pipeline"]
    loader.update(max_clips=3, row_buckets=[1, 3], fuse=3)
    runner.update(max_rows=3, row_buckets=[1, 3], layer_sizes=LS,
                  num_classes=10)
    path = os.path.join(tmp, "rnb-fused-yuv-traced.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _reduced_traced_segments(tmp):
    with open(SEGMENT) as f:
        raw = json.load(f)
    for step in raw["pipeline"]:
        for group in step["queue_groups"]:
            group["devices"] = [0 if d >= 0 else d
                                for d in group["devices"]]
    loader, runner, _aggregator = raw["pipeline"]
    loader.update(max_clips=3, consecutive_frames=2,
                  num_clips_population=[1, 3], weights=[2, 1], prefetch=2)
    runner.update(max_rows=1, consecutive_frames=2, layer_sizes=LS,
                  num_classes=8, num_warmups=1)
    raw["trace"] = {"enabled": True, "sample_hz": 100}
    path = os.path.join(tmp, "r2p1d-segment-traced.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


@pytest.fixture(scope="module")
def traced_runs(tmp_path_factory):
    """Both traced runs, once, with the host profiler on."""
    from rnb_tpu_torch.benchmark import run_benchmark
    tmp = str(tmp_path_factory.mktemp("traced"))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hostprof, "ENABLED", True)
        for name, config, data in (
                ("fused", _reduced_traced(tmp), _dataset(
                    os.path.join(tmp, "data"))),
                ("segments", _reduced_traced_segments(tmp), None)):
            if data is None:
                mp.delenv("RNB_TPU_DATA_ROOT", raising=False)
            else:
                mp.setenv("RNB_TPU_DATA_ROOT", data)
            result = run_benchmark(
                config, mean_interval_ms=0, num_videos=REQUESTS,
                log_base=os.path.join(tmp, "logs"), print_progress=False,
                seed=0, platform="cpu")
            assert result.termination_flag == 0
            assert result.num_completed == REQUESTS
            runs[name] = result
    hostprof.reset()
    assert trace.ACTIVE is None
    return runs


@pytest.mark.parametrize("name", ["fused", "segments"])
def test_traced_run_writes_a_trace_the_reference_validates(traced_runs,
                                                           name):
    result = traced_runs[name]
    path = os.path.join(result.log_dir, "trace.json")
    assert jax_trace.validate_trace(path) == []
    assert trace.validate_trace(path) == []
    with open(path) as f:
        doc = json.load(f)
    meta = read_meta(os.path.join(result.log_dir, "log-meta.txt"))
    assert meta["lines"]["Trace"] == {
        "events": doc["otherData"]["num_events"],
        "dropped": doc["otherData"]["dropped_events"]}
    assert result.trace_events == doc["otherData"]["num_events"] > 0
    assert summarize(result.log_dir)["footing_problems"] == []
    tracks = set(jax_trace.track_names(path))
    assert {"client", "runner-s0-g0-i0", "runner-s1-g0-i0"} <= tracks
    if name == "fused":
        assert "rnb-transfer" in tracks  # transfer_async
    else:
        assert "runner-s1-g0-i6" in tracks and "runner-s2-g0-i0" in tracks


@pytest.mark.parametrize("name", ["fused", "segments"])
def test_every_request_phases_sum_to_its_latency(traced_runs, name):
    result = traced_runs[name]
    report = attribute(result.log_dir, num_skips=0)
    assert report["requests"] == REQUESTS
    assert report["max_residual_ms"] <= 1e-3
    phases = set(report["phases"])
    assert {"client_queue", "decode", "transfer", "inference1"} <= phases
    meta = read_meta(os.path.join(result.log_dir, "log-meta.txt"))
    assert set(meta["phases"]) <= phases
    with open(os.path.join(result.log_dir, [
            n for n in os.listdir(result.log_dir)
            if n.endswith("-0.txt")][0])) as f:
        trailer = [ln for ln in f if ln.startswith("# phases")]
    assert len(trailer) == 1 and trailer[0].startswith("# phases n=2 ")


def _declared(event_name):
    for spec in TRACE_EVENT_REGISTRY:
        pattern = "^%s$" % re.escape(spec.pattern).replace(
            re.escape("{step}"), r"\d+")
        if re.match(pattern, event_name):
            return True
    return False


def test_every_emitted_event_is_declared(traced_runs):
    names = set()
    for result in traced_runs.values():
        with open(os.path.join(result.log_dir, "trace.json")) as f:
            names |= {e["name"] for e in json.load(f)["traceEvents"]
                      if e["ph"] not in ("M", "s", "t", "f")}
    assert not {n for n in names if not _declared(n)}
    # the runs reach every family the registry declares, but for the
    # staging wait (no slot ran short) and the batcher (not in them)
    for expected in ("client.enqueue", "client.enqueued", "exec0.model_call",
                     "exec1.device_sync", "exec0.publish", "exec2.swallow",
                     "loader.emit", "loader.transfer", "loader.decode_submit",
                     "loader.decode_ready", "transfer.job",
                     "queue.filename.depth", "queue.e0.depth",
                     "staging.s0.free", "loader.s0.inflight"):
        assert expected in names, expected
    stamps = set()
    for spec in TRACE_STAMP_REGISTRY:
        stamps.add(spec.pattern.format(step=0))
    for result in traced_runs.values():
        (table,) = [n for n in os.listdir(result.log_dir)
                    if n.endswith("-0.txt")]
        with open(os.path.join(result.log_dir, table)) as f:
            header = f.readline().split()
        assert stamps <= set(header)


def test_hostprof_file_reports_the_window_per_role(traced_runs):
    path = os.path.join(traced_runs["fused"].log_dir, "hostprof.txt")
    with open(path) as f:
        lines = f.read().splitlines()
    head = lines[0].split()
    assert head[0] == "#" and head[5] == "host_cpu_frac"
    assert float(head[6]) >= 0
    sections = {line.split()[0] for line in lines[2:]
                if not line.startswith(" ")}
    assert {"exec0.model_call", "exec1.model_call", "exec1.device_sync",
            "loader.transfer"} <= sections


def test_untraced_run_writes_no_trace(tmp_path, monkeypatch):
    from rnb_tpu_torch.benchmark import run_benchmark
    with open(SEGMENT) as f:
        raw = json.load(f)
    # the one-step baseline is cheapest: the single step, untraced
    raw = {"video_path_iterator": raw["video_path_iterator"],
           "pipeline": [{"model": "rnb_tpu.models.r2p1d.model."
                         "R2P1DSingleStep",
                         "queue_groups": [{"devices": [0]}],
                         "max_clips": 2, "consecutive_frames": 2,
                         "layer_sizes": LS, "num_classes": 4,
                         "num_warmups": 0}]}
    config = str(tmp_path / "single.json")
    with open(config, "w") as f:
        json.dump(raw, f)
    monkeypatch.delenv("RNB_TPU_DATA_ROOT", raising=False)
    result = run_benchmark(config, mean_interval_ms=0, num_videos=3,
                           log_base=str(tmp_path / "logs"),
                           print_progress=False, seed=0, platform="cpu")
    assert result.termination_flag == 0 and result.trace_events == 0
    assert not os.path.exists(os.path.join(result.log_dir, "trace.json"))
    with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
        meta = f.read()
    assert "Trace:" not in meta and "Phases:" not in meta
    assert summarize(result.log_dir)["footing_problems"] == []


def test_time_card_stamps_stay_ordered_when_clamped():
    from rnb_tpu_torch.models.r2p1d.model import _record_clamped
    tc = TimeCard(0)
    tc.record("inference0_start", at=5.0)
    _record_clamped(tc, "decode0_done", 4.0)
    assert tc.timings["decode0_done"] == 5.0
    _record_clamped(tc, "transfer0_start", 6.0)
    assert list(tc.timings.values()) == [5.0, 5.0, 6.0]
