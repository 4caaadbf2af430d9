"""The port's live-metrics plane (``rnb_tpu_torch.metrics``) held to the
JAX package's, and the slice as a whole on the CPU.

The same seeded inputs (numpy) go through both packages' registries
under a fixed clock: histogram bucketing, a stream of counter, gauge,
observe, mark and bridged trace calls and the snapshots taken over it,
the Prometheus exposition, the SLO burn over a completion stream, and
the flight recorder's triggers and cooldown — all equal. In the port
alone: an undeclared name raises, the series cap counts its overflow,
and the disabled hooks allocate nothing.

The slice as a whole: the port's ``run_benchmark(platform="cpu")`` on
``configs/rnb-fused-yuv-metrics.json``, ``configs/rnb-fused-yuv-
autotune.json`` (bulk and Poisson), a critpath copy of
``configs/rnb-fused-yuv-traced.json`` and, for the keys-absent contract,
``configs/rnb-fused-yuv-staged.json``, each cut to a CPU-sized runner
(3-row buckets, layer sizes (1, 1, 1, 1), 10 classes) on the JAX
package's seeded weights. Every request's logits are held to the JAX
stages' (the JAX sampler's clip starts, decoded by the JAX decoder,
through the JAX ``_shared_apply``) within 2% of the logit scale, the
bound of ``tests/test_torch_slice.py``; the job directories pass the
port's ``parse_utils`` checks and the reference's own readers
(``validate_trace`` on flight dumps, ``load_metrics`` on
``metrics.jsonl``).
"""

import json
import os
import re
import sys
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from rnb_tpu import metrics as jax_metrics
from rnb_tpu import telemetry as jax_telemetry
from rnb_tpu import trace as jax_trace
from rnb_tpu.decode import get_decoder as jax_get_decoder
from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.models.r2p1d.model import _shared_apply
from rnb_tpu.models.r2p1d.sampler import R2P1DSampler as JaxSampler
from rnb_tpu_torch import critpath as port_critpath
from rnb_tpu_torch import metrics, trace
from rnb_tpu_torch import telemetry as port_telemetry
from rnb_tpu_torch.decode import write_y4m
from rnb_tpu_torch.models.r2p1d import model as port_model
from rnb_tpu_torch.models.r2p1d.checkpoint import (filter_layer_range,
                                                   from_jax_variables)
from rnb_tpu_torch.models.r2p1d.network import (R2Plus1DClassifier,
                                                cast_compute_weights)
from rnb_tpu_torch.parse_utils import (load_metrics, metrics_problems,
                                       read_meta, read_table, read_trailers,
                                       summarize)
from rnb_tpu_torch.runner import NUM_SUMMARY_SKIPS
from rnb_tpu_torch.telemetry import METRIC_REGISTRY, TimeCard

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LS = (1, 1, 1, 1)
CLASSES = 10
REQUESTS = 12
T0 = 1.7e9


@pytest.fixture(autouse=True)
def _no_installed_hooks():
    for module in (metrics, trace, jax_metrics, jax_trace):
        module.ACTIVE = None
    yield
    for module in (metrics, trace, jax_metrics, jax_trace):
        module.ACTIVE = None


def _pair(**kwargs):
    """The port's registry and the reference's, on the same settings."""
    fr = kwargs.pop("flight_recorder", None)
    return (metrics.MetricsRegistry(
        metrics.MetricsSettings(flight_recorder=fr), **kwargs),
            jax_metrics.MetricsRegistry(
                jax_metrics.MetricsSettings(flight_recorder=fr), **kwargs))


# -- parity under a fixed clock -----------------------------------------

def test_hist_bucket_and_bounds_equal_the_reference():
    rng = np.random.default_rng(0)
    latencies = np.concatenate([
        rng.lognormal(0.0, 3.0, 2000), [0.0, -1.0, 2.0 ** -3, 2.0 ** 13,
                                        1e9, 2.0 ** -10],
        2.0 ** np.arange(-4, 16)]).tolist()
    assert [metrics.hist_bucket(ms) for ms in latencies] == \
        [jax_metrics.hist_bucket(ms) for ms in latencies]
    assert metrics.hist_upper_bounds() == jax_metrics.hist_upper_bounds()


def _stream(registry, seed):
    """A seeded stream of every mutator, then the snapshots over it."""
    rng = np.random.default_rng(seed)
    snap = {"acquires": 0, "staged_batches": 0, "slots": 3}
    registry.add_poll(metrics.snapshot_poll(
        "staging", lambda: dict(snap),
        counters=("acquires", "staged_batches"), gauges=("slots",)))
    depth = [0]
    registry.add_gauge_source("queue.e0.depth", lambda: depth[0],
                              capacity=100)
    now, records = T0, []
    for i in range(400):
        now += float(rng.exponential(0.01))
        op = int(rng.integers(0, 7))
        if op == 0:
            registry.inc_counter("client.requests", int(rng.integers(1, 3)))
        elif op == 1:
            registry.set_gauge("autotune.target_rows",
                               int(rng.integers(1, 16)))
        elif op == 2:
            registry.observe_ms(("exec1.model_call", "exec0.queue_get",
                                 "loader.emit")[i % 3],
                                float(rng.lognormal(0.0, 2.0)))
        elif op == 3:
            registry.mark_rate("client.arrivals", 1, now=now)
        elif op == 4:
            name = ("exec1.publish", "batcher.emit", "client.enqueue",
                    "autotune.decision")[i % 4]
            registry.bridge_event(name, "X" if name == "exec1.publish"
                                  else "i", float(rng.exponential(0.002)))
        elif op == 5:
            snap["acquires"] += 1
            snap["staged_batches"] += int(rng.integers(0, 2))
            depth[0] = int(rng.integers(0, 50))
        else:
            records.append(registry.snapshot(now))
    records.append(registry.snapshot(now + 20.0))  # past the rate window
    return records


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_stream_snapshots_equal_the_reference(seed):
    port, ref = _pair()
    assert _stream(port, seed) == _stream(ref, seed)
    assert port.summary() == ref.summary()
    assert port.final_snapshot() == ref.final_snapshot()


def test_exposition_equals_the_reference():
    port, ref = _pair()
    _stream(port, 3)
    _stream(ref, 3)
    text = port.render_exposition()
    assert text == ref.render_exposition()
    assert "# TYPE rnb_exec1_model_call_ms histogram" in text
    assert 'rnb_exec1_model_call_ms_bucket{le="+Inf"}' in text


def _completions(registry, module, seed):
    """Seeded completions (end-to-end latencies around the 30 ms budget)
    in batches, each followed by a snapshot."""
    rng = np.random.default_rng(seed)
    now, records, rid = T0, [], 0
    for _ in range(40):
        now += float(rng.exponential(0.2))
        cards = []
        for _ in range(int(rng.integers(1, 5))):
            card = module.TimeCard(rid)
            rid += 1
            card.record("enqueue_filename",
                        at=now - float(rng.lognormal(np.log(0.025), 0.5)))
            card.record("inference1_finish", at=now)
            cards.append(card)
        registry.note_completions(cards, now)
        records.append(registry.snapshot(now))
    return records


@pytest.mark.parametrize("budget_ms", [30.0, None])
def test_slo_burn_equals_the_reference(budget_ms):
    port, ref = _pair(slo_budget_ms=budget_ms)
    got = _completions(port, port_telemetry, 4)
    want = _completions(ref, jax_telemetry, 4)
    assert got == want
    summary = port.summary()
    assert summary == ref.summary()
    assert summary["slo_within"] + summary["slo_missed"] \
        == summary["slo_tracked"] > 0
    if budget_ms is None:
        assert summary["slo_missed"] == 0 and summary["burn_max_milli"] == 0
    else:
        assert summary["slo_missed"] > 0 and summary["burn_max_milli"] > 0


def _triggers(registry, bridge_cls, seed):
    """Saturating queue depths and late completions on a fixed clock:
    the recorder's triggers, budget and cooldown decide the dumps."""
    rng = np.random.default_rng(seed)
    registry.bridge = bridge_cls(registry, ring_events=16)
    depth = [0]
    registry.add_gauge_source("queue.e0.depth", lambda: depth[0],
                              capacity=10)
    now = T0
    for i in range(30):
        now += 0.4
        depth[0] = int(rng.integers(0, 11))
        card = TimeCard(i)
        card.record("enqueue_filename", at=now - (0.5 if i % 3 else 0.01))
        card.record("inference1_finish", at=now)
        registry.note_completions([card], now)
        registry.bridge.add_event("exec1.model_call", "X", now - 0.01,
                                  0.01, i, None)
        registry.snapshot(now)
    return ([(p.reason, p.t, p.detail) for p in registry._pending_dumps],
            registry.num_triggers, registry.bridge.ring_evicted)


def test_flight_triggers_and_cooldown_equal_the_reference(tmp_path):
    fr = {"cooldown_s": 2.0, "max_dumps": 3, "burn_threshold": 2.0,
          "queue_saturation": 0.8}
    port, ref = _pair(flight_recorder=fr, slo_budget_ms=100.0,
                      job_dir=str(tmp_path), job_id="flight")
    got = _triggers(port, metrics.SpanBridge, 5)
    assert got == _triggers(ref, jax_metrics.SpanBridge, 5)
    pending, triggers, evicted = got
    # both kinds fired, the budget capped the dumps, the cooldown spaced
    # each kind's
    assert {p[0] for p in pending} == {"slo_burn", "queue_saturation"}
    assert len(pending) == 3 < triggers and evicted > 0
    for kind in ("slo_burn", "queue_saturation"):
        times = [p[1] for p in pending if p[0] == kind]
        assert all(b - a >= fr["cooldown_s"] for a, b in zip(times,
                                                             times[1:]))
    port.tick(T0 + 13.0)
    dumps = sorted(n for n in os.listdir(tmp_path) if n.startswith("flight"))
    assert dumps == ["flight-0.json", "flight-1.json", "flight-2.json"]
    for name in dumps:
        path = os.path.join(tmp_path, name)
        assert jax_trace.validate_trace(path) == []
        assert trace.validate_trace(path) == []
        with open(path) as f:
            other = json.load(f)["otherData"]
        assert other["flight_trigger"] in ("slo_burn", "queue_saturation")
        assert other["dropped_events"] == evicted
        assert other["critpath"][0]["name"] == "exec1.model_call"
    assert port.summary()["dumps"] == 3


@pytest.mark.parametrize("raw", [
    None, {}, {"enabled": False}, {"interval_ms": 25},
    {"flight_recorder": False}, {"flight_recorder": True},
    {"flight_recorder": {"ring_events": 16, "max_dumps": 2,
                         "burn_threshold": 1.5, "cooldown_s": 0.5}}])
def test_settings_from_config_equal_the_reference(raw):
    got = metrics.MetricsSettings.from_config(raw)
    want = jax_metrics.MetricsSettings.from_config(raw)
    assert (got is None) == (want is None)
    if got is not None:
        assert {k: getattr(got, k) for k in got.__slots__} == \
            {k: getattr(want, k) for k in want.__slots__}


# -- the port alone ------------------------------------------------------

def test_every_port_series_is_the_reference_s():
    reference = {spec.pattern: spec.kind
                 for spec in jax_telemetry.METRIC_REGISTRY}
    for spec in METRIC_REGISTRY:
        assert reference.get(spec.pattern) == spec.kind, spec.pattern


@pytest.mark.parametrize("call", ["counter", "gauge", "observe", "mark"])
def test_an_undeclared_name_raises(call):
    registry = metrics.MetricsRegistry()
    metrics.ACTIVE = registry
    hook = getattr(metrics, call)
    with pytest.raises(ValueError, match="not declared"):
        hook("client.typo", 1)
    # a name the reference declares and the port does not is no excuse
    # either (the port's staging pool never reallocates a slot)
    with pytest.raises(ValueError, match="not declared"):
        hook("staging.reallocs", 1)
    assert registry.summary()["series"] == 0


def test_the_series_cap_counts_its_overflow(monkeypatch):
    monkeypatch.setattr(metrics, "MAX_SERIES", 4)
    registry = metrics.MetricsRegistry()
    for step in range(7):
        registry.observe_ms("exec%d.model_call" % step, 1.0)
    registry.inc_counter("client.requests")
    snap = registry.snapshot(T0)
    assert len(snap["histograms"]) == 4 and snap["counters"].get(
        "client.requests") is None
    assert snap["series_overflowed"] == 4


def test_the_disabled_hooks_allocate_nothing():
    def hot_loop():
        for _ in range(200):
            metrics.counter("client.requests")
            metrics.gauge("autotune.target_rows", 6)
            metrics.observe("exec1.model_call", 1.5)
            metrics.mark("client.arrivals")
            metrics.trigger("forced")
            metrics.completions([])
            metrics.register_stage(object())

    hot_loop()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        hot_loop()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    hooks = [tracemalloc.Filter(True, metrics.__file__)]
    grown = after.filter_traces(hooks).compare_to(
        before.filter_traces(hooks), "lineno")
    assert sum(stat.size_diff for stat in grown) <= 0


def test_the_bridge_feeds_the_registry_and_forwards_to_the_tracer():
    registry = metrics.MetricsRegistry()
    tracer = trace.Tracer()
    bridge = metrics.SpanBridge(registry, forward=tracer, ring_events=2)
    trace.ACTIVE = bridge
    with trace.span("exec1.model_call", 3):
        pass
    trace.instant("batcher.emit")
    trace.instant("client.enqueue", rid=4)  # a trace event, no metric
    snap = registry.snapshot(T0)
    assert snap["histograms"]["exec1.model_call"]["count"] == 1
    assert snap["counters"] == {"batcher.emit": 1, "slo.tracked": 0,
                                "slo.within": 0, "slo.missed": 0}
    assert [e[0] for e in tracer._events] == [
        "exec1.model_call", "batcher.emit", "client.enqueue"]
    # the ring holds the last two and counts what it evicted
    assert [e[0] for e in bridge.ring_events()] == ["batcher.emit",
                                                    "client.enqueue"]
    assert bridge.ring_evicted == 1


def test_the_poll_of_a_failing_source_is_skipped():
    registry = metrics.MetricsRegistry()

    def broken():
        raise RuntimeError("a dying source")
    registry.add_poll(broken)
    registry.add_gauge_source("queue.e0.depth", broken, capacity=1)
    registry.add_poll(metrics.snapshot_poll(
        "cache", lambda: {"hits": 2}, counters=("hits",)))
    assert registry.tick(T0)["counters"]["cache.hits"] == 2


def test_concurrent_writers_lose_no_update(tmp_path):
    """Eight writer threads and the flusher on one registry, with a
    shortened switch interval: every increment and observation lands,
    and every snapshot the flusher appended is monotone."""
    registry = metrics.MetricsRegistry(
        metrics.MetricsSettings(interval_ms=1), job_dir=str(tmp_path))
    bridge = metrics.SpanBridge(registry, ring_events=32)

    def write():
        for _ in range(2000):
            registry.inc_counter("client.requests")
            registry.observe_ms("exec1.model_call", 0.5)
            bridge.add_event("batcher.emit", "i", T0, 0.0, None, None)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        registry.start()
        threads = [threading.Thread(target=write) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        registry.stop()
    finally:
        sys.setswitchinterval(switch)
    snapshots = load_metrics(str(tmp_path))
    final = snapshots[-1]
    assert final["counters"]["client.requests"] == 16000
    assert final["counters"]["batcher.emit"] == 16000
    assert final["histograms"]["exec1.model_call"]["count"] == 16000
    assert len(bridge.ring_events()) == 32
    for before, after in zip(snapshots, snapshots[1:]):
        for name, value in before["counters"].items():
            assert after["counters"][name] >= value


# -- the slice as a whole -------------------------------------------------

def _dataset(root, videos=6, frames=40):
    rng = np.random.default_rng(0)
    for i in range(videos):
        label = os.path.join(root, "label%d" % (i % 2))
        os.makedirs(label, exist_ok=True)
        write_y4m(os.path.join(label, "v%02d.y4m" % i),
                  rng.integers(0, 256, (frames, 112, 112, 3),
                               dtype=np.uint8), colorspace="420")
    return root


def _reduced(name, tmp, extra=None):
    with open(os.path.join(REPO, "configs/rnb-fused-yuv-%s.json" % name)) \
            as f:
        raw = json.load(f)
    raw.update(extra or {})
    loader, runner = raw["pipeline"]
    loader.update(max_clips=3, row_buckets=[1, 3], fuse=3)
    runner.update(max_rows=3, row_buckets=[1, 3], layer_sizes=list(LS),
                  num_classes=CLASSES)
    path = os.path.join(tmp, "%s-%d.json" % (name, len(os.listdir(tmp))))
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


#: label -> (config, root keys added, mean interval ms)
RUNS = {"metrics": ("metrics", None, 0),
        "autotune": ("autotune", None, 0),
        "autotune-poisson": ("autotune", None, 20),
        "critpath": ("traced", {"critpath": {"enabled": True}}, 0),
        "traced-metrics": ("traced", {"metrics": {"interval_ms": 50}}, 0),
        "staged": ("staged", None, 0)}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every run of the slice, once, on the JAX package's weights."""
    from rnb_tpu_torch.benchmark import run_benchmark
    weights = jax_ckpt.load_or_init(1, 5, CLASSES, LS, None)
    state = from_jax_variables(weights)

    def shared_network(start, end, num_classes, layer_sizes, device,
                       dtype=torch.bfloat16, factored_shortcut=False):
        net = R2Plus1DClassifier(start, end, num_classes, layer_sizes,
                                 factored_shortcut, dtype=dtype)
        net.load_state_dict(filter_layer_range(state, start, end),
                            strict=True)
        return cast_compute_weights(net).to(device).eval()

    tmp = str(tmp_path_factory.mktemp("planes"))
    os.makedirs(os.path.join(tmp, "configs"))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_model, "shared_network", shared_network)
        mp.setenv("RNB_TPU_DATA_ROOT", _dataset(os.path.join(tmp, "data")))
        for label, (name, extra, interval) in RUNS.items():
            if label == "metrics":
                mp.setenv("RNB_FLIGHT_FORCE", "1")
            else:
                mp.delenv("RNB_FLIGHT_FORCE", raising=False)
            sink = {}
            result = run_benchmark(
                _reduced(name, os.path.join(tmp, "configs"), extra),
                mean_interval_ms=interval, num_videos=REQUESTS,
                log_base=os.path.join(tmp, "logs", label),
                print_progress=False, seed=0, platform="cpu",
                outputs_sink=sink)
            assert result.termination_flag == 0
            assert metrics.ACTIVE is None and trace.ACTIVE is None
            runs[label] = (result, sink)
    return weights, runs


def _jax_logits(weights, video, n):
    """The JAX stages' logits for one served request: the JAX sampler's
    starts, the JAX decoder's 4:2:0 planes, the JAX network."""
    decoder = jax_get_decoder(video)
    starts = JaxSampler(consecutive_frames=8).sample(
        decoder.num_frames(video), video_id=video)[:3]
    rows = np.asarray(decoder.decode_clips_yuv(video, starts, 8, 112, 112))
    assert len(rows) == n
    pool = np.zeros((3,) + rows.shape[1:], np.uint8)
    pool[:n] = rows
    apply = _shared_apply(1, 5, CLASSES, LS, pixel_path="yuv420")
    return np.asarray(apply(weights, pool))[:n]


def _assert_logits_close(got, want):
    bound = 0.02 * float(np.abs(want).max())
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= bound
    for g, w in zip(got, want):
        top2 = np.sort(w)[-2:]
        if top2[1] - top2[0] > 2 * bound:
            assert g.argmax() == w.argmax()


@pytest.mark.parametrize("label", list(RUNS))
def test_the_slice_serves_the_jax_logits_and_its_logs_check(served, label):
    weights, runs = served
    result, sink = runs[label]
    assert result.num_completed >= REQUESTS
    assert len(sink) == result.num_completed
    for video, logits, _stamps in sink.values():
        _assert_logits_close(logits, _jax_logits(weights, video,
                                                 len(logits)))
    stats = summarize(result.log_dir)
    assert stats["footing_problems"] == []
    assert stats["compile_signatures"]["step1"]["steady_new"] == 0


def _heads(log_dir):
    with open(os.path.join(log_dir, "log-meta.txt")) as f:
        return [line.split(":")[0] for line in f.read().splitlines()
                if ":" in line]


def test_without_the_keys_nothing_is_added(served):
    _, runs = served
    staged = runs["staged"][0]
    assert sorted(os.listdir(staged.log_dir)) == ["cpu0-group0-0.txt",
                                                  "log-meta.txt"]
    heads = _heads(staged.log_dir)
    assert not {"Metrics", "Slo", "Critpath", "Critpath stages",
                "Autotune", "Autotune buckets"} & set(heads)
    # each plane adds exactly its own lines (and the traced cell its own)
    got = _heads(runs["metrics"][0].log_dir)
    assert [h for h in got if h not in ("Metrics", "Slo")] == heads
    got = _heads(runs["autotune"][0].log_dir)
    assert [h for h in got
            if h not in ("Autotune", "Autotune buckets")] == heads
    got = _heads(runs["critpath"][0].log_dir)
    assert [h for h in got if h not in (
        "Critpath", "Critpath stages", "Trace", "Phases")] == heads
    with open(os.path.join(staged.log_dir, "cpu0-group0-0.txt")) as f:
        assert "# critpath" not in f.read()
    assert staged.metrics_snapshots == staged.critpath_requests \
        == staged.autotune_decisions == 0


def test_the_metrics_run_foots_and_its_dump_validates(served, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    import parse_utils as jax_parse_utils
    _, runs = served
    result, _ = runs["metrics"]
    files = sorted(os.listdir(result.log_dir))
    assert files == ["cpu0-group0-0.txt", "flight-0.json", "log-meta.txt",
                     "metrics.jsonl", "metrics.prom"]
    meta = read_meta(os.path.join(result.log_dir, "log-meta.txt"))
    assert metrics_problems(result.log_dir, meta) == []
    snapshots = load_metrics(result.log_dir)
    assert jax_parse_utils.load_metrics(result.log_dir) == snapshots
    assert len(snapshots) == result.metrics_snapshots >= 1
    final = snapshots[-1]["counters"]
    assert final["client.requests"] == result.num_requests == REQUESTS
    assert final["slo.tracked"] == final["slo.within"] == REQUESTS
    assert final["staging.staged_batches"] + final.get(
        "staging.copied_batches", 0) >= 1
    assert meta["lines"]["Slo"] == {"tracked": REQUESTS,
                                    "within": REQUESTS, "missed": 0,
                                    "burn_max_milli": 0}
    assert snapshots[-1]["histograms"]["exec1.model_call"]["count"] >= 1
    path = os.path.join(result.log_dir, "flight-0.json")
    assert jax_trace.validate_trace(path) == []
    with open(path) as f:
        other = json.load(f)["otherData"]
    assert other["flight_trigger"] == "forced"
    assert other["metric_window"][-1] == snapshots[-1]
    assert result.metrics_dumps == 1 <= result.metrics_triggers


def test_the_critpath_run_partitions_and_names_a_step(served):
    _, runs = served
    result, _ = runs["critpath"]
    table = os.path.join(result.log_dir, "cpu0-group0-0.txt")
    keys, rows = read_table(table)
    for row in rows:
        chain = port_critpath.blocking_chain(dict(zip(keys, row)))
        assert abs(sum(ms for _c, _s, ms in chain)
                   - (row[-1] - row[0]) * 1e3) <= 1e-3
    assert result.critpath_requests == result.num_completed \
        - NUM_SUMMARY_SKIPS
    assert result.critpath_bound_step in (0, 1)
    assert read_trailers(table)["critpath"]["n"] == result.critpath_requests
    meta = read_meta(os.path.join(result.log_dir, "log-meta.txt"))
    assert meta["lines"]["Critpath"]["requests"] == result.critpath_requests
    assert set(meta["critpath_stages"]) == {"step0", "step1"}


@pytest.mark.parametrize("label", ["autotune", "autotune-poisson"])
def test_the_autotune_runs_decide_within_the_warmed_buckets(served, label):
    _, runs = served
    result, _ = runs[label]
    meta = read_meta(os.path.join(result.log_dir, "log-meta.txt"))
    line = meta["lines"]["Autotune"]
    staging = meta["staging"][0]
    assert 0 < line["emissions"] == (staging["staged_batches"]
                                     + staging["copied_batches"])
    assert line["decisions"] >= line["emissions"]
    assert set(meta["autotune_buckets"]) <= {"1", "3"}
    assert result.autotune_bucket_counts == meta["autotune_buckets"]
    assert meta["compile_signatures"]["step1"]["steady_new"] == 0


def _trace_events(log_dir):
    with open(os.path.join(log_dir, "trace.json")) as f:
        doc = json.load(f)
    return doc, {(ev["name"], ev["ph"]) for ev in doc["traceEvents"]}


def test_the_bridge_leaves_the_trace_as_a_traced_run_writes_it(served):
    """Metrics on a traced run: the bridge forwards every event, so
    trace.json holds the traced run's kinds of events (those every run
    of this cell shows; waits come and go with timing), its Trace: line
    agrees, and every bridged histogram counts exactly the spans the
    trace holds."""
    _, runs = served
    _, events = _trace_events(runs["critpath"][0].log_dir)
    result = runs["traced-metrics"][0]
    doc, got = _trace_events(result.log_dir)
    core = {(name, "X") for name in (
        "exec0.model_call", "exec1.model_call", "exec1.device_sync",
        "exec0.publish", "loader.emit", "loader.transfer",
        "transfer.job")} | {("client.enqueued", "C"),
                            ("queue.filename.depth", "C")}
    assert core <= got and core <= events
    declared = {spec.pattern.replace("{step}", "%d") for spec in
                port_telemetry.TRACE_EVENT_REGISTRY}
    for name, ph in got:
        assert ph in "stfM" or any(
            re.fullmatch(re.escape(p).replace("%d", r"\d+"), name)
            for p in declared), name
    assert jax_trace.validate_trace(os.path.join(result.log_dir,
                                                 "trace.json")) == []
    meta = read_meta(os.path.join(result.log_dir, "log-meta.txt"))
    assert meta["lines"]["Trace"]["events"] == \
        doc["otherData"]["num_events"] == result.trace_events
    final = load_metrics(result.log_dir)[-1]
    assert final["histograms"]
    for name, hist in final["histograms"].items():
        assert hist["count"] == sum(
            1 for ev in doc["traceEvents"]
            if ev["name"] == name and ev["ph"] == "X"), name


@pytest.mark.parametrize("drift", ["counter", "histogram", "footing",
                                   "dump", "prom"])
def test_parse_utils_catches_metrics_drift(served, tmp_path, drift):
    import shutil
    _, runs = served
    job = str(tmp_path / "job")
    shutil.copytree(runs["metrics"][0].log_dir, job)
    snapshots = load_metrics(job)
    if drift == "counter":
        snapshots[-1]["counters"]["client.requests"] = 0
    elif drift == "histogram":
        snapshots[-1]["histograms"]["exec1.model_call"]["count"] += 1
    elif drift == "footing":
        snapshots[-1]["counters"]["staging.acquires"] += 1
    if drift in ("counter", "histogram", "footing"):
        with open(os.path.join(job, "metrics.jsonl"), "w") as f:
            f.writelines(json.dumps(s) + "\n" for s in snapshots)
    elif drift == "dump":
        os.remove(os.path.join(job, "flight-0.json"))
    else:
        os.remove(os.path.join(job, "metrics.prom"))
    want = {"counter": "counter 'client.requests' fell",
            "histogram": "histogram 'exec1.model_call' buckets sum",
            "footing": "staging.acquires=",
            "dump": "dumps=1 but the job holds []",
            "prom": "no metrics.prom"}[drift]
    problems = summarize(job)["footing_problems"]
    assert any(want in p for p in problems), problems


@pytest.mark.parametrize("drift", ["trailer", "line"])
def test_parse_utils_catches_critpath_drift(served, tmp_path, drift):
    import shutil
    _, runs = served
    job = str(tmp_path / "job")
    shutil.copytree(runs["critpath"][0].log_dir, job)
    name = "log-meta.txt" if drift == "line" else "cpu0-group0-0.txt"
    path = os.path.join(job, name)
    with open(path) as f:
        text = f.read()
    if drift == "line":
        text = re.sub(r"Critpath: requests=\d+", "Critpath: requests=99",
                      text)
    else:
        text = re.sub(r"# critpath n=\d+", "# critpath n=99", text)
    with open(path, "w") as f:
        f.write(text)
    want = {"line": "Critpath: requests=99, the tables give",
            "trailer": "'# critpath' n=99"}[drift]
    problems = summarize(job)["footing_problems"]
    assert any(want in p for p in problems), problems
