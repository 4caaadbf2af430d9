"""The port's operator plane (``rnb_tpu_torch.statusz``,
``rnb_tpu_torch.stacksampler``), its config rules and the benchmark CLI
(``rnb_tpu_torch.arg_utils``, ``--check``) held to the JAX package's.

Unit parity: ``parse_whatif_query`` on the reference's cases and errors;
the settings and the root ``operator``/``whatif`` config rules with the
reference's messages; ``/healthz`` and ``/metrics`` bodies byte-equal to
what the reference's server renders from the same registry state (a
fixed clock); the folded-stack math on synthetic stacks; the server's
lifecycle, routes, ``allow_actions`` gate and ledger.

The slice as a whole: the port's ``run_benchmark(platform="cpu")`` on
``configs/rnb-fused-yuv-operator.json`` cut to a CPU-sized runner (3-row
buckets, layer sizes (1, 1, 1, 1), 10 classes) on the JAX package's
seeded weights, with actions allowed, ``trace`` and ``whatif`` added,
scraped live from a second thread; and the same config with the key
removed. Every request's logits are held to the JAX stages' within 2% of
the logit scale (the bound of ``tests/test_torch_slice.py``); the job
directory passes the port's ``parse_utils`` and the reference's
``scripts/parse_utils.py`` ``_check_operator`` and ``_check_whatif``,
and both catch a cooked ``stacks.folded`` and a cooked ``Whatif:`` line.

The CLI: ``-v 0``, ``-qs 0``, ``-b 0`` and ``-mi -1`` refused with the
reference's messages; ``--check`` prints the reference's posture lines
for every shipped config the port reads and refuses the others.
"""

import contextlib
import functools
import glob
import io
import json
import os
import shutil
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from rnb_tpu import benchmark as jax_benchmark
from rnb_tpu import config as jax_config
from rnb_tpu import health as jax_health
from rnb_tpu import metrics as jax_metrics
from rnb_tpu import stacksampler as jax_stacksampler
from rnb_tpu import statusz as jax_statusz
from rnb_tpu import trace as jax_trace
from rnb_tpu.decode import get_decoder as jax_get_decoder
from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.models.r2p1d.model import _shared_apply
from rnb_tpu.models.r2p1d.sampler import R2P1DSampler as JaxSampler
from rnb_tpu_torch import benchmark, health, metrics, stacksampler, statusz
from rnb_tpu_torch import trace
from rnb_tpu_torch.config import ConfigError, load_config, parse_config
from rnb_tpu_torch.decode import write_y4m
from rnb_tpu_torch.models.r2p1d import model as port_model
from rnb_tpu_torch.models.r2p1d.checkpoint import (filter_layer_range,
                                                   from_jax_variables)
from rnb_tpu_torch.models.r2p1d.network import (R2Plus1DClassifier,
                                                cast_compute_weights)
from rnb_tpu_torch.parse_utils import read_meta, summarize
from rnb_tpu_torch.whatif import job_config as whatif_job_config
from torch_job_checks import assert_both_checks_pass

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPERATOR = os.path.join(REPO, "configs/rnb-fused-yuv-operator.json")
SHIPPED = sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))


@pytest.fixture(autouse=True)
def _no_installed_hooks():
    for module in (metrics, trace, jax_metrics, jax_trace):
        module.ACTIVE = None
    yield
    for module in (metrics, trace, jax_metrics, jax_trace):
        module.ACTIVE = None


def _get(server, path):
    url = "http://127.0.0.1:%d%s" % (server.port, path)
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(server, path):
    url = "http://127.0.0.1:%d%s" % (server.port, path)
    request = urllib.request.Request(url, data=b"", method="POST")
    try:
        with urllib.request.urlopen(request, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@contextlib.contextmanager
def _serving(*servers):
    for server in servers:
        server.start()
    try:
        yield servers
    finally:
        for server in servers:
            server.stop()


# -- the /whatif query vocabulary ---------------------------------------------

@pytest.mark.parametrize("query", [
    "replicas_step1=4&service_scale_step0=0.5&arrival_scale=2&pool_rows=30",
    "replicas_step2=%2B1", "replicas_step0=-1", "",
    "shard_degree_step1=4&replicas_step0=2", "shard_degree_step1=1",
    "service_scale_step3=1.25&arrival_scale=0.5"])
def test_parse_whatif_query_equals_the_reference(query):
    assert statusz.parse_whatif_query(query) \
        == jax_statusz.parse_whatif_query(query)


@pytest.mark.parametrize("query", [
    "bogus=1", "replicas_step2=+1", "shard_degree_step1=0",
    "shard_degree=2", "replicas_stepx=1", "pool_rows=a",
    "arrival_scale="])
def test_parse_whatif_query_refuses_as_the_reference(query):
    with pytest.raises(ValueError) as theirs:
        jax_statusz.parse_whatif_query(query)
    with pytest.raises(ValueError) as ours:
        statusz.parse_whatif_query(query)
    assert str(ours.value) == str(theirs.value)


# -- settings and config rules ------------------------------------------------

@pytest.mark.parametrize("raw", [None, {}, {"enabled": False},
                                 {"port": 8123, "allow_actions": True,
                                  "sample_hz": 0},
                                 {"sample_hz": 10}])
def test_operator_settings_equal_the_reference(raw):
    ours = statusz.OperatorSettings.from_config(raw)
    theirs = jax_statusz.OperatorSettings.from_config(raw)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert [getattr(ours, k) for k in ours.__slots__] \
            == [getattr(theirs, k) for k in theirs.__slots__]
    assert stacksampler.DEFAULT_SAMPLE_HZ \
        == jax_stacksampler.DEFAULT_SAMPLE_HZ


def _operator_raw(**keys):
    with open(OPERATOR) as f:
        raw = json.load(f)
    for key, value in keys.items():
        if value is None:
            raw.pop(key, None)
        else:
            raw[key] = value
    return raw


def test_the_operator_config_reads_as_shipped():
    cfg = load_config(OPERATOR, platform="cpu")
    assert cfg.operator == {"enabled": True, "port": 0,
                            "allow_actions": False, "sample_hz": 25}
    assert cfg.whatif is None
    cfg = parse_config(_operator_raw(whatif={"enabled": True}),
                       platform="cpu")
    assert cfg.whatif == {"enabled": True}


@pytest.mark.parametrize("key,value", [
    ("operator", "yes"), ("operator", {"enable": True}),
    ("operator", {"enabled": 1}), ("operator", {"allow_actions": "no"}),
    ("operator", {"port": -1}), ("operator", {"port": 70000}),
    ("operator", {"port": True}), ("operator", {"port": 8.5}),
    ("operator", {"sample_hz": -1}), ("operator", {"sample_hz": True}),
    ("whatif", "on"), ("whatif", {"enabled": True, "depth": 2}),
    ("whatif", {"enabled": "yes"}),
])
def test_bad_keys_are_refused_with_the_reference_s_message(key, value):
    raw = _operator_raw(**{key: value})
    with pytest.raises(jax_config.ConfigError) as theirs:
        jax_config.parse_config(raw)
    with pytest.raises(ConfigError) as ours:
        parse_config(raw, platform="cpu")
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("metrics_key", [None, {"enabled": False}])
def test_whatif_without_metrics_is_refused_as_the_reference(metrics_key):
    raw = _operator_raw(whatif={"enabled": True}, metrics=metrics_key)
    with pytest.raises(jax_config.ConfigError) as theirs:
        jax_config.parse_config(raw)
    with pytest.raises(ConfigError, match="'whatif' requires an enabled "
                       "root 'metrics' key") as ours:
        parse_config(raw, platform="cpu")
    assert str(ours.value) == str(theirs.value)
    # a disabled whatif needs nothing
    raw["whatif"] = {"enabled": False}
    assert parse_config(raw, platform="cpu").whatif == {"enabled": False}


# -- byte-equal bodies --------------------------------------------------------

NOW = 1.7e9 + 12.5


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both servers' module clocks read NOW."""
    clock = types.SimpleNamespace(time=lambda: NOW)
    for module in (statusz, jax_statusz):
        monkeypatch.setattr(module, "time", clock)


class _Flag:
    def __init__(self, value):
        self.value = value


@pytest.mark.parametrize("flag", [-1, 0, 3])
@pytest.mark.parametrize("evicted", [False, True])
def test_healthz_is_byte_equal_to_the_reference_s(tmp_path, fixed_clock,
                                                  flag, evicted):
    boards = []
    for module in (health, jax_health):
        board = module.LaneHealthBoard((3, 4), module.HealthSettings())
        if evicted:
            board.evict(4, "test kill")
        boards.append(board)
    servers = [module.OperatorServer(
        module.OperatorSettings(), job_dir=None, job_id="hz",
        boards={1: board}, termination=_Flag(flag),
        window={"t0": NOW - 2.25})
        for module, board in zip((statusz, jax_statusz), boards)]
    with _serving(*servers):
        ours, theirs = (_get(server, "/healthz") for server in servers)
    assert ours == theirs and ours[0] == 200
    payload = json.loads(ours[1])
    assert payload["window_s"] == 2.25
    assert payload["status"] == ("degraded" if evicted else
                                 {-1: "ok", 0: "draining"}.get(flag,
                                                               "terminating"))


def test_healthz_without_boards_is_the_reference_s(tmp_path, fixed_clock):
    servers = [module.OperatorServer(module.OperatorSettings(),
                                     job_dir=str(tmp_path / name))
               for module, name in ((statusz, "a"), (jax_statusz, "b"))]
    for name in ("a", "b"):
        (tmp_path / name).mkdir()
    with _serving(*servers):
        ours, theirs = (_get(server, "/healthz") for server in servers)
    assert ours == theirs
    assert json.loads(ours[1])["lanes"] == {}


def _feed(registry, seed):
    """A seeded stream of counters, gauges, observations and marks, then
    one snapshot."""
    rng = np.random.default_rng(seed)
    now = 1.7e9
    for i in range(300):
        now += float(rng.exponential(0.01))
        op = int(rng.integers(0, 4))
        if op == 0:
            registry.inc_counter("client.requests", int(rng.integers(1, 3)))
        elif op == 1:
            registry.set_gauge("autotune.target_rows",
                               int(rng.integers(1, 16)))
        elif op == 2:
            registry.observe_ms(("exec1.model_call", "exec0.model_call",
                                 "exec1.device_sync")[i % 3],
                                float(rng.lognormal(0.0, 2.0)))
        else:
            registry.mark_rate("client.arrivals", 1, now=now)
    registry.snapshot(now)


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_is_byte_equal_to_the_reference_s(tmp_path, seed):
    registries = [module.MetricsRegistry(module.MetricsSettings())
                  for module in (metrics, jax_metrics)]
    for registry in registries:
        _feed(registry, seed)
    servers = [module.OperatorServer(module.OperatorSettings(),
                                     metrics_registry=registry)
               for module, registry in zip((statusz, jax_statusz),
                                           registries)]
    with _serving(*servers):
        want = registries[0].render_exposition()
        ours, theirs = (_get(server, "/metrics") for server in servers)
        # live: a bump shows on the next scrape, in both
        for registry in registries:
            registry.inc_counter("client.requests", 2)
        again = [_get(server, "/metrics") for server in servers]
    assert ours == theirs and ours[0] == 200
    assert ours[1].decode() == want
    assert again[0] == again[1] and again[0] != ours
    assert servers[0].summary() == servers[1].summary() == {
        "scrapes": 2, "actions": 0, "denied": 0, "errors": 0}


def test_whatif_answers_as_the_reference_s(tmp_path, fixed_clock):
    raw = {"pipeline": [{"queue_groups": [{"devices": [0]}]},
                        {"queue_groups": [{"devices": [1]}]}]}
    registries = []
    for module in (metrics, jax_metrics):
        registry = module.MetricsRegistry(module.MetricsSettings())
        for i in range(20):
            registry.observe_ms("exec0.model_call", 4.0 + i % 3)
            registry.observe_ms("exec1.model_call", 8.0 + i % 5)
        registry.slo_tracked = 20
        registry.snapshot(now=NOW)
        registries.append(registry)
    servers = [module.OperatorServer(
        module.OperatorSettings(), metrics_registry=registry,
        config_raw=raw, window={"t0": NOW - 2.0})
        for module, registry in zip((statusz, jax_statusz), registries)]
    with _serving(*servers):
        for query in ("/whatif?service_scale_step1=0.5",
                      "/whatif?replicas_step1=%2B1&arrival_scale=2",
                      "/whatif?bogus=1", "/whatif"):
            ours, theirs = (_get(server, query) for server in servers)
            assert ours == theirs
    payload = json.loads(ours[1])
    assert payload["calibrated"] is True and payload["stages"] == 2
    assert servers[0].summary() == servers[1].summary() == {
        "scrapes": 3, "actions": 0, "denied": 0, "errors": 1}


# -- the stack sampler ---------------------------------------------------------

@pytest.mark.parametrize("name", [
    "client", "runner-s0-g0-i1", "runner-s1-g0-i0", "rnb-decode_3",
    "rnb-decode", "rnb-transfer", "MainThread", "metrics-flusher",
    "stack-sampler", "operator-server", "devobs-worker"])
def test_role_of_a_thread_is_the_reference_s(name):
    assert stacksampler.role_of(name) == jax_stacksampler.role_of(name)


def _synthetic(sampler, seed):
    rng = np.random.default_rng(seed)
    roles = ["client", "runner-s0-g0-i0", "runner-s1-g0-i0", "rnb-decode"]
    frames = ["run", "loop", "get", "call", "wait", "replay", "decode"]
    for tick in range(50):
        with sampler._lock:
            sampler.samples += 1
        for role in roles:
            if rng.random() < 0.8:
                depth = int(rng.integers(1, 5))
                stack = tuple(frames[int(i)] for i in
                              rng.integers(0, len(frames), depth))
                sampler.record(role, stack, now=100.0 + tick / 25.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_folded_stacks_equal_the_reference_s(tmp_path, seed):
    ours = stacksampler.StackSampler(sample_hz=25.0)
    theirs = jax_stacksampler.StackSampler(sample_hz=25.0)
    _synthetic(ours, seed)
    _synthetic(theirs, seed)
    assert ours.folded_lines() == theirs.folded_lines()
    assert ours.summary() == theirs.summary()
    assert ours.trace_events() == theirs.trace_events()
    ours.write_folded(str(tmp_path / "a"))
    theirs.write_folded(str(tmp_path / "b"))
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    # the artifact re-sums to the summary's total
    total = sum(int(line.rpartition(" ")[2])
                for line in (tmp_path / "a").read_text().splitlines())
    assert total == ours.summary()["total"]


def test_the_folded_math_on_a_known_stream():
    sampler = stacksampler.StackSampler(sample_hz=10.0)
    for tick in range(3):
        with sampler._lock:
            sampler.samples += 1
        sampler.record("client", ("run", "poisson", "sleep"),
                       now=100.0 + tick)
        sampler.record("runner-s0-g0-i0",
                       ("run", "loop", "get" if tick % 2 else "call"),
                       now=100.0 + tick)
    assert sampler.summary() == {"samples": 3, "threads": 2, "folded": 3,
                                 "total": 6}
    assert sampler.folded_lines() == [
        "client;run;poisson;sleep 3", "runner-s0-g0-i0;run;loop;call 2",
        "runner-s0-g0-i0;run;loop;get 1"]
    events = sampler.trace_events()
    assert len(events) == 6 and all(e[3] == 0.1 for e in events)
    assert {e[4] for e in events} == {"stacks:client",
                                      "stacks:runner-s0-g0-i0"}


def test_the_sampler_sees_a_live_runner_thread_and_stops():
    stop = threading.Event()
    thread = threading.Thread(target=lambda: stop.wait(10.0),
                              name="runner-s9-g0-i0", daemon=True)
    thread.start()
    try:
        sampler = stacksampler.StackSampler(sample_hz=200.0)
        sampler.start()
        deadline = time.monotonic() + 5.0
        while sampler.samples < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        sampler.stop()
        ticks = sampler.samples
        assert ticks >= 3
        time.sleep(0.05)
        assert sampler.samples == ticks
        assert any(key[0] == "runner-s9-g0-i0" for key in sampler._folded)
    finally:
        stop.set()
        thread.join()
    off = stacksampler.StackSampler(sample_hz=0.0)
    off.start()
    assert off._thread is None


# -- the server ---------------------------------------------------------------

def test_the_server_binds_loopback_and_shuts_down(tmp_path):
    server = statusz.OperatorServer(statusz.OperatorSettings(),
                                    job_dir=str(tmp_path), job_id="life")
    with _serving(server):
        record = json.loads((tmp_path / "operator.json").read_text())
        assert record["host"] == "127.0.0.1" and record["port"] == server.port
        assert record["job_id"] == "life" and record["allow_actions"] is False
        assert record["endpoints"] == list(jax_statusz.ENDPOINTS)
        assert server._httpd.server_address[0] == "127.0.0.1"
        assert _get(server, "/healthz")[0] == 200
    with pytest.raises(OSError):
        urllib.request.urlopen("http://127.0.0.1:%d/healthz" % server.port,
                               timeout=0.5)


def test_statusz_stacks_and_unknown_routes(tmp_path):
    topology = {"steps": [
        {"step": 0, "model": "rnb_tpu_torch.models.r2p1d.model."
         "R2P1DFusingLoader", "groups": 1, "instances": 1,
         "replica_lanes": []},
        {"step": 1, "model": "rnb_tpu_torch.models.r2p1d.model.R2P1DRunner",
         "groups": 1, "instances": 1, "replica_lanes": []}]}
    server = statusz.OperatorServer(
        statusz.OperatorSettings(), job_dir=str(tmp_path), job_id="sz",
        topology=topology, queue_probes=[("queue.e0.depth", lambda: 7, 50)])
    with _serving(server):
        code, body = _get(server, "/statusz")
        assert code == 200
        body = body.decode()
        for section in ("Pipeline topology", "Queue depths", "Replica lanes",
                        "SLO", "Memory owners", "Compute", "Stack sampler"):
            assert section in body
        assert "R2P1DRunner" in body and ">7<" in body
        code, body = _get(server, "/stacks")
        assert code == 200 and b"operator-server" in body
        code, body = _get(server, "/nope")
        assert code == 404
        assert json.loads(body)["endpoints"] == list(statusz.ENDPOINTS)
        assert _get(server, "/metrics")[0] == 503
        assert _get(server, "/whatif")[0] == 503
    assert server.summary() == {"scrapes": 2, "actions": 0, "denied": 0,
                                "errors": 3}


def test_actions_are_gated_and_counted(tmp_path):
    registry = metrics.MetricsRegistry(metrics.MetricsSettings(),
                                       job_dir=str(tmp_path), job_id="fl")
    registry.bridge = metrics.SpanBridge(registry, ring_events=64)
    trace.ACTIVE = registry.bridge
    with trace.span("exec0.model_call", 1):
        pass
    trace.ACTIVE = None
    denied = statusz.OperatorServer(statusz.OperatorSettings(),
                                    metrics_registry=registry)
    with _serving(denied):
        for route in ("/flight", "/capture"):
            code, body = _post(denied, route)
            assert code == 403 and b"allow_actions" in body
        assert _post(denied, "/other")[0] == 404
    assert denied.summary() == {"scrapes": 0, "actions": 0, "denied": 2,
                                "errors": 1}

    class Plane:
        def __init__(self):
            self.requests = []

        def request_capture(self, trigger):
            self.requests.append(trigger)

    plane = Plane()
    allowed = statusz.OperatorServer(
        statusz.OperatorSettings(allow_actions=True),
        metrics_registry=registry, devobs_plane=plane)
    with _serving(allowed):
        assert _post(allowed, "/flight")[0] == 200
        assert _post(allowed, "/capture")[0] == 200
        assert plane.requests == ["operator"]
        allowed.devobs_plane = None
        assert _post(allowed, "/capture")[0] == 503
    assert allowed.summary() == {"scrapes": 0, "actions": 2, "denied": 0,
                                 "errors": 1}
    registry.tick()  # the flusher services the armed dump
    dump = str(tmp_path / "flight-0.json")
    assert trace.validate_trace(dump) == []
    assert jax_trace.validate_trace(dump) == []
    with open(dump) as f:
        assert json.load(f)["otherData"]["flight_trigger"] == "forced"


def test_the_statusz_memory_section_peeks_without_sampling(tmp_path):
    from rnb_tpu_torch.memledger import MemLedger
    ledger = MemLedger(watermark_bytes=10)
    ledger.register("params", "cpu:0", "w", 64)
    assert ledger.peek() is None
    plane = types.SimpleNamespace(ledger=ledger, meters={})
    server = statusz.OperatorServer(statusz.OperatorSettings(),
                                    devobs_plane=plane)
    assert "no ledger sample yet" in server.statusz_html()
    ledger.sample()
    assert ledger.watermark_hits == 1
    html_page = server.statusz_html()
    assert "total 64 bytes (peak 64)" in html_page
    assert ledger.watermark_hits == 1 and ledger.peek()["total"] == 64


# -- the slice as a whole -------------------------------------------------------

LS = (1, 1, 1, 1)
CLASSES = 10
REQUESTS = 24


def _dataset(root, videos=6, frames=40):
    rng = np.random.default_rng(0)
    for i in range(videos):
        label = os.path.join(root, "label%d" % (i % 2))
        os.makedirs(label, exist_ok=True)
        write_y4m(os.path.join(label, "v%02d.y4m" % i),
                  rng.integers(0, 256, (frames, 112, 112, 3),
                               dtype=np.uint8), colorspace="420")
    return root


def _reduced(tmp, name, **keys):
    raw = _operator_raw(**keys)
    loader, runner = raw["pipeline"]
    loader.update(max_clips=3, row_buckets=[1, 3], fuse=3)
    runner.update(max_rows=3, row_buckets=[1, 3], layer_sizes=list(LS),
                  num_classes=CLASSES)
    path = os.path.join(tmp, name + ".json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


class _Scraper(threading.Thread):
    """Reads the run's operator.json, waits for the window, then scrapes
    every GET route and POSTs /flight."""

    def __init__(self, log_base):
        super().__init__(daemon=True)
        self.log_base, self.calls, self.error = log_base, {}, None

    def _call(self, url, route, method="GET"):
        request = urllib.request.Request(
            url + route, method=method,
            data=b"" if method == "POST" else None)
        try:
            with urllib.request.urlopen(request, timeout=30) as r:
                self.calls[method + " " + route] = (r.status, r.read())
        except urllib.error.HTTPError as e:
            self.calls[method + " " + route] = (e.code, e.read())
        return self.calls[method + " " + route]

    def run(self):
        try:
            record, deadline = None, time.time() + 300
            while record is None and time.time() < deadline:
                for root, _dirs, files in os.walk(self.log_base):
                    if "operator.json" in files:
                        with open(os.path.join(root, "operator.json")) as f:
                            record = json.load(f)
                time.sleep(0.02)
            url = record["url"]
            while json.loads(self._call(url, "/healthz")[1])["window_s"] \
                    <= 0:
                time.sleep(0.02)
            while b"snapshot seq" not in self._call(url, "/statusz")[1]:
                time.sleep(0.02)
            # after the first snapshot, so the live exposition holds
            # counters to hold against the teardown's
            for route in ("/metrics", "/stacks"):
                self._call(url, route)
            # calibrated once a snapshot holds a completed dispatch of
            # each step
            while not json.loads(self._call(
                    url, "/whatif?replicas_step1=2")[1])["calibrated"]:
                time.sleep(0.02)
            self._call(url, "/flight", "POST")
        except Exception as e:  # read by the tests
            self.error = e


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The reduced operator run (actions allowed, trace and whatif on,
    scraped live) and the same config without the key, on the JAX
    package's weights."""
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

    tmp = str(tmp_path_factory.mktemp("operator"))
    runs, scraper = {}, None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_model, "shared_network", shared_network)
        mp.setenv("RNB_TPU_DATA_ROOT", _dataset(os.path.join(tmp, "data")))
        for label, keys in (
                ("operator", dict(
                    operator={"enabled": True, "port": 0,
                              "allow_actions": True, "sample_hz": 50},
                    metrics={"enabled": True, "interval_ms": 50},
                    trace={"enabled": True}, whatif={"enabled": True})),
                ("off", dict(operator=None))):
            log_base = os.path.join(tmp, "logs-" + label)
            if label == "operator":
                scraper = _Scraper(log_base)
                scraper.start()
            sink = {}
            # the operator run serves long enough for the scraper to find
            # a calibrated snapshot on a loaded host
            result = run_benchmark(
                _reduced(tmp, label, **keys), mean_interval_ms=15,
                num_videos=2 * REQUESTS if label == "operator" else REQUESTS,
                log_base=log_base, print_progress=False, seed=0,
                platform="cpu", outputs_sink=sink)
            assert result.termination_flag == 0
            runs[label] = (result, sink)
    scraper.join(timeout=60)
    return weights, runs, scraper


def _jax_logits(weights, video, n):
    decoder = jax_get_decoder(video)
    starts = JaxSampler(consecutive_frames=8).sample(
        decoder.num_frames(video), video_id=video)[:3]
    rows = np.asarray(decoder.decode_clips_yuv(video, starts, 8, 112, 112))
    assert len(rows) == n
    pool = np.zeros((3,) + rows.shape[1:], np.uint8)
    pool[:n] = rows
    return np.asarray(_jax_apply()(weights, pool))[:n]


@functools.lru_cache(maxsize=None)
def _jax_apply():
    """The JAX stages' forward, built once for every request."""
    return _shared_apply(1, 5, CLASSES, LS, pixel_path="yuv420")


@pytest.mark.parametrize("label", ["operator", "off"])
def test_the_slice_serves_the_jax_logits(served, label):
    weights, runs, _ = served
    result, sink = runs[label]
    assert result.num_completed >= REQUESTS and len(sink) \
        == result.num_completed
    for video, logits, _stamps in sink.values():
        want = _jax_logits(weights, video, len(logits))
        bound = 0.02 * float(np.abs(want).max())
        assert logits.shape == want.shape
        assert np.abs(logits - want).max() <= bound
    assert summarize(result.log_dir)["footing_problems"] == []


def test_the_live_scrape_answered_every_route(served):
    _, runs, scraper = served
    result, _ = runs["operator"]
    assert scraper.error is None and not scraper.is_alive()
    codes = {route: code for route, (code, _body) in scraper.calls.items()}
    assert codes == {"GET /healthz": 200, "GET /metrics": 200,
                     "GET /stacks": 200, "GET /statusz": 200,
                     "GET /whatif?replicas_step1=2": 200,
                     "POST /flight": 200}
    whatif = json.loads(scraper.calls["GET /whatif?replicas_step1=2"][1])
    assert whatif["calibrated"] is True and whatif["spec"] == {
        "replicas": {"step1": 2}}
    assert result.operator_scrapes >= 5 and result.operator_actions == 1
    assert result.operator_denied == result.operator_errors == 0
    assert result.metrics_dumps >= 1
    # the live counters never exceed the teardown exposition's
    final = _prom_counters((open(os.path.join(result.log_dir,
                                              "metrics.prom")).read()))
    live = _prom_counters(scraper.calls["GET /metrics"][1].decode())
    assert live and all(value <= final[name] for name, value in live.items())


def _prom_counters(text):
    kinds, out = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            kinds[name] = kind
        elif line and not line.startswith("#"):
            name, _, value = line.partition(" ")
            if kinds.get(name) == "counter":
                out[name] = int(float(value))
    return out


def test_the_run_writes_the_operator_artifacts(served):
    _, runs, _ = served
    result, _ = runs["operator"]
    files = set(os.listdir(result.log_dir))
    assert {"operator.json", "stacks.folded", "trace.json", "metrics.jsonl",
            "metrics.prom", "flight-0.json", "operator.json"} <= files
    # the config copy whatif recomputes from
    assert whatif_job_config(result.log_dir)["operator"]["sample_hz"] == 50
    with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
        text = f.read()
    assert ("Operator: scrapes=%d actions=%d denied=%d errors=%d\n" % (
        result.operator_scrapes, result.operator_actions,
        result.operator_denied, result.operator_errors)) in text
    assert ("Stacks: samples=%d threads=%d folded=%d total=%d\n" % (
        result.stacks_samples, result.stacks_threads, result.stacks_folded,
        result.stacks_total)) in text
    assert "Whatif: stages=2 calibrated=1 pred_vps_milli=%d " \
        "bottleneck_step=%d\n" % (result.whatif_pred_vps_milli,
                                  result.whatif_bottleneck_step) in text
    with open(os.path.join(result.log_dir, "stacks.folded")) as f:
        roles = {line.split(";", 1)[0] for line in f}
    assert {"client", "runner-s1-g0-i0"} <= roles
    # the sampler's tiles joined the trace on stacks:<role> tracks
    assert any(name.startswith("stacks:")
               for name in jax_trace.track_names(
                   os.path.join(result.log_dir, "trace.json")))
    assert jax_trace.validate_trace(os.path.join(result.log_dir,
                                                 "trace.json")) == []


def _reference_parse_utils():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import parse_utils
    finally:
        sys.path.pop(0)
    return parse_utils


def _reference_meta(log_dir):
    """The keys the reference's checks read, from the port's log-meta."""
    meta = read_meta(os.path.join(log_dir, "log-meta.txt"))
    out = {}
    for head, prefix in (("Whatif", "whatif_"), ("Operator", "operator_"),
                         ("Stacks", "stacks_"), ("Metrics", "metrics_")):
        for key, value in meta["lines"].get(head, {}).items():
            out[prefix + key] = int(value)
    start, end = meta["window"]
    out["wall_time_s"] = end - start
    return out


def _reference_problems(log_dir):
    parse_utils = _reference_parse_utils()
    meta = _reference_meta(log_dir)
    return (parse_utils._check_operator(log_dir, meta)
            + parse_utils._check_whatif(log_dir, meta))


def test_the_reference_s_checks_pass_on_the_port_s_job(served):
    _, runs, _ = served
    for label in ("operator", "off"):
        assert _reference_problems(runs[label][0].log_dir) == []


@pytest.mark.parametrize("cook", ["folded", "whatif", "operator.json"])
def test_both_checks_catch_cooked_logs(served, tmp_path, cook):
    _, runs, _ = served
    job = str(tmp_path / "job")
    shutil.copytree(runs["operator"][0].log_dir, job)
    if cook == "folded":
        path = os.path.join(job, "stacks.folded")
        lines = open(path).read().splitlines()
        stack, _, count = lines[0].rpartition(" ")
        lines[0] = "%s %d" % (stack, int(count) + 5)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        want = "sum to"
    elif cook == "whatif":
        path = os.path.join(job, "log-meta.txt")
        text = open(path).read()
        milli = runs["operator"][0].whatif_pred_vps_milli
        text = text.replace("pred_vps_milli=%d " % milli,
                            "pred_vps_milli=%d " % (milli + 5))
        with open(path, "w") as f:
            f.write(text)
        want = "pred_vps_milli"
    else:
        os.remove(os.path.join(job, "operator.json"))
        want = "operator.json is missing"
    ours = summarize(job)["footing_problems"]
    theirs = _reference_problems(job)
    assert any(want in p for p in ours), ours
    assert any(want in p for p in theirs), theirs


def test_without_the_key_nothing_is_added(served):
    _, runs, _ = served
    result, _ = runs["off"]
    assert sorted(os.listdir(result.log_dir)) == [
        "cpu0-group0-0.txt", "log-meta.txt", "metrics.jsonl", "metrics.prom"]
    with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
        lines = f.read().splitlines()
    heads = [line.split(":")[0] for line in lines if ":" in line]
    assert heads == ["Args", "Termination flag", "Faults", "Device",
                     "Pixel path", "Decode backend", "Completed", "Padding",
                     "Staging", "Compiles", "Warmup", "Metrics", "Slo",
                     "Kernels"]
    # the Args line keeps the parent's keys: no batch_size at the default
    assert sorted(json.loads(lines[0].partition(": ")[2])) == [
        "config", "mean_interval_ms", "num_videos", "platform",
        "queue_size", "seed"]
    assert (result.operator_scrapes, result.stacks_samples,
            result.whatif_stages) == (0, 0, 0)
    # the timing table holds the untraced stamps only
    with open(os.path.join(result.log_dir, "cpu0-group0-0.txt")) as f:
        assert f.readline().split() == [
            "enqueue_filename", "runner0_start", "inference0_start",
            "inference0_finish", "runner1_start", "inference1_start",
            "inference1_finish", "device0", "device1"]


# -- the CLI --------------------------------------------------------------------

def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            code = main(argv)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [["-v", "0"], ["-qs", "0"], ["-mi", "-1"],
                                  ["-b", "0"], ["-v", "-3"], ["-v", "x"],
                                  ["-mi", "1.5"]])
def test_the_cli_refuses_what_the_reference_refuses(argv):
    ours = _cli(benchmark.main, argv + ["--check", "-c", OPERATOR])
    theirs = _cli(jax_benchmark.main, argv + ["--check", "-c", OPERATOR])
    assert ours[0] == theirs[0] == 2
    assert ours[2].splitlines()[-1] == theirs[2].splitlines()[-1]


def test_batch_size_lands_in_the_args_line(tmp_path, monkeypatch):
    seen = {}

    def run(**kwargs):
        seen.update(kwargs)
        return types.SimpleNamespace(throughput_vps=0.0, log_dir="x",
                                     termination_flag=0)

    monkeypatch.setattr(benchmark, "run_benchmark", run)
    monkeypatch.setattr(benchmark, "asdict", lambda result: {})
    code, _out, _err = _cli(benchmark.main, ["-b", "4", "-mi", "0", "-v",
                                             "2", "--platform", "cpu"])
    assert code == 0 and seen["batch_size"] == 4
    assert seen["mean_interval_ms"] == 0 and seen["num_videos"] == 2


READABLE = list(SHIPPED)
#: configs the port does not read: the two mesh configs with a key of a
#: part still to port (a mesh over several cards needs the NCCL reduce)
UNREAD = [os.path.join(REPO, "configs", name) for name in (
    "r2p1d-mesh-yuv.json", "r2p1d-mesh.json")]


def test_the_port_reads_41_of_the_shipped_configs():
    # the netedge configs read since the edge was ported, the three
    # scale-out configs since the replica lanes were, the two mesh
    # configs since the mesh stage was: every shipped config
    read = 0
    for path in SHIPPED:
        load_config(path, platform="cpu")
        read += 1
    assert len(SHIPPED) == 41 and read == 41


@pytest.mark.parametrize("config", READABLE,
                         ids=[os.path.basename(p) for p in READABLE])
def test_check_prints_the_reference_s_posture(config):
    path = os.path.relpath(config, REPO)
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        ours = _cli(benchmark.main, ["--check", "-c", path])
        theirs = _cli(jax_benchmark.main, ["--check", "-c", path])
    finally:
        os.chdir(cwd)
    assert ours[0] == theirs[0] == 0
    assert ours[1].splitlines()[:-1] == theirs[1].splitlines()[:-1]
    assert ours[1].splitlines()[-1] == "rnb_tpu_torch is ready to go!"


@pytest.mark.parametrize("config", UNREAD,
                         ids=[os.path.basename(p) for p in UNREAD])
def test_check_refuses_a_config_the_port_does_not_read(config, tmp_path):
    with open(config) as f:
        raw = json.load(f)
    # a pixel path no stage of the port has (nor the reference's)
    raw["pipeline"][1]["pixel_path"] = "nv12"
    path = str(tmp_path / os.path.basename(config))
    with open(path, "w") as f:
        json.dump(raw, f)
    code, out, err = _cli(benchmark.main, ["--check", "-c", path])
    assert code == 1 and out == ""
    assert "is not yet ported to rnb_tpu_torch" in err


def test_the_sampler_ticks_over_the_window_only(tmp_path, monkeypatch):
    """A --profile or --xprof session's reads come after the window and
    may take seconds on the card: the sampler stops at the window's end,
    so its ticks stay within the cadence the checks hold them to. Here
    the session's stop is made to take 4 s."""
    from rnb_tpu_torch import profiler as profiler_mod
    from rnb_tpu_torch.benchmark import run_benchmark
    flush = profiler_mod.flush

    def slow_flush():
        flush()
        time.sleep(4.0)

    monkeypatch.setattr(profiler_mod, "flush", slow_flush)
    monkeypatch.setenv("RNB_TPU_DATA_ROOT",
                       _dataset(str(tmp_path / "data"), videos=2))
    config = _reduced(str(tmp_path), "sampled", operator={
        "enabled": True, "sample_hz": 200})
    result = run_benchmark(config, mean_interval_ms=0, num_videos=6,
                           log_base=str(tmp_path / "logs"),
                           print_progress=False, seed=0, platform="cpu",
                           xprof=True)
    assert result.termination_flag == 0
    window = result.total_time_s
    bound = 200 * window * 1.5 + 25  # parse_utils' upper tolerance
    assert 0 < result.stacks_samples <= bound
    # ticking on through the slow stop would have passed it
    assert 200 * (window + 4.0) > bound
    assert summarize(result.log_dir)["footing_problems"] == []
    assert _reference_problems(result.log_dir) == []


@pytest.mark.parametrize("label", ["operator", "off"])
def test_both_check_jobs_pass_the_operator_job_dirs(served, label):
    assert_both_checks_pass(served[1][label][0].log_dir)
