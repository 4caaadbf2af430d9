"""The port's device observability plane (``rnb_tpu_torch.devobs``,
``memledger``) held to the JAX package's, and a devobs run end to end on
the CPU.

The same seeded inputs (numpy) go through both packages:

* the footprint ledger: the same register and sample sequence gives
  equal records and ``snapshot()`` s (dedupe, peaks, watermark
  episodes), and an undeclared owner raises the same error;
* the compute meters: fed the same dispatches, ``compute_summary`` and
  ``metrics_poll`` are equal, with and without a peak;
* the trace merge: fed the same fabricated captures and model_call
  spans, ``device_events`` is equal;
* the capture budget and the trigger hooks; the ``devobs`` root key's
  accept and reject cases, with the same messages;
* ``parse_utils``: the port's devobs check finds exactly what the
  reference's ``_check_devobs`` finds in a served job directory and in
  tampered copies of it (owner footing, cooked ``tflops_milli``,
  malformed detail, ...).

The slice: a reduced copy of ``configs/rnb-fused-yuv-devobs.json`` (3-row
buckets, layer sizes (1, 1, 1, 1), 10 classes) served by the port's
``run_benchmark(platform="cpu")`` on the JAX package's seeded weights,
with one forced capture: logits held to the JAX stages' within 2% of the
logit scale (the bound of ``tests/test_torch_metrics.py``), the port's
checks green with ``Compute:`` rows equal to the clips completed, the
capture read by the reference's ``scripts/device_busy.py`` and its
artifact check, ``trace.json`` with a ``device:`` track passing the
reference's ``validate_trace``; the same config without the key keeps
the pre-devobs files and stamp header byte for byte.

On the CPU the allocator holds no CUDA bytes: ``live_bytes=0`` and
``reconciled=0``, which the check accepts ("not reconciled"); only
``live_bytes > 0`` with ``reconciled=0`` is a violation.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from rnb_tpu import config as jax_config
from rnb_tpu import devobs as jax_devobs
from rnb_tpu import memledger as jax_memledger
from rnb_tpu import metrics as jax_metrics
from rnb_tpu import trace as jax_trace
from rnb_tpu.decode import get_decoder as jax_get_decoder
from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.models.r2p1d import flops as jax_flops
from rnb_tpu.models.r2p1d.model import _shared_apply
from rnb_tpu.models.r2p1d.sampler import R2P1DSampler as JaxSampler
from rnb_tpu_torch import devobs, memledger, metrics, profiler, trace
from rnb_tpu_torch.config import ConfigError, parse_config
from rnb_tpu_torch.decode import write_y4m
from rnb_tpu_torch.models.r2p1d import model as port_model
from rnb_tpu_torch.models.r2p1d.checkpoint import (filter_layer_range,
                                                   from_jax_variables)
from rnb_tpu_torch.models.r2p1d.network import (R2Plus1DClassifier,
                                                cast_compute_weights)
from rnb_tpu_torch.parse_utils import devobs_problems, read_meta, summarize

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "rnb-fused-yuv-devobs.json")
LS = (1, 1, 1, 1)
CLASSES = 10
REQUESTS = 12
MIB = 1 << 20


@pytest.fixture(autouse=True)
def _no_installed_hooks():
    modules = (devobs, memledger, metrics, trace, jax_devobs,
               jax_memledger, jax_metrics, jax_trace)
    for module in modules:
        module.ACTIVE = None
    yield
    for module in modules:
        module.ACTIVE = None


# -- the footprint ledger --------------------------------------------------

def _ledger_script(seed):
    """A seeded sequence of ledger calls: ("register", owner, device, key,
    value, live) with value an int or a holder index, ("set", holder,
    bytes) and ("sample",)."""
    rng = np.random.default_rng(seed)
    owners = memledger.MEM_OWNERS
    steps = []
    for _ in range(40):
        kind = rng.choice(["register", "set", "sample"], p=[0.3, 0.4, 0.3])
        if kind == "register":
            value = (int(rng.integers(0, 3)) if rng.random() < 0.5
                     else int(rng.integers(0, 40)) * MIB)
            steps.append(("register", owners[int(rng.integers(len(owners)))],
                          "cuda:%d" % int(rng.integers(2)),
                          int(rng.integers(6)), value,
                          bool(rng.random() < 0.5),
                          rng.random() < 0.5))
        elif kind == "set":
            steps.append(("set", int(rng.integers(3)),
                          int(rng.integers(0, 60)) * MIB))
        else:
            steps.append(("sample",))
    return steps


def _play(module, script, watermark):
    ledger = module.MemLedger(watermark_bytes=watermark)
    holders = [0, 0, 0]
    records = []
    for step in script:
        if step[0] == "register":
            _, owner, device, key, value, live, probe = step
            source = ((lambda i=value % 3: holders[i]) if probe
                      else value)
            ledger.register(owner, device, key, source, live=live)
        elif step[0] == "set":
            holders[step[1]] = step[2]
        else:
            records.append(ledger.sample())
    return records, ledger.snapshot()


@pytest.mark.parametrize("seed", range(6))
def test_ledger_records_and_snapshots_equal_the_reference(seed):
    script = _ledger_script(seed)
    watermark = 48 * MIB
    ours = _play(memledger, script, watermark)
    theirs = _play(jax_memledger, script, watermark)
    assert ours == theirs
    snapshot = ours[1]
    assert sum(o["bytes"] for o in snapshot["owners"].values()) \
        == snapshot["total_bytes"] <= snapshot["peak_bytes"]


def test_watermark_episodes_count_each_crossing_once(capsys):
    holder = [0]
    for module in (memledger, jax_memledger):
        ledger = module.MemLedger(watermark_bytes=10)
        seen = []
        ledger.on_watermark = seen.append
        ledger.register("cache", "cuda:0", "k", lambda: holder[0])
        for value in (5, 12, 30, 3, 10, 11, 0, 9):
            holder[0] = value
            ledger.sample()
        assert ledger.watermark_hits == 2 and seen == [12, 10]
        assert ledger.snapshot()["watermark_hits"] == 2
    assert capsys.readouterr().err.count("crossed the 10 B watermark") == 4


@pytest.mark.parametrize("owner", ["activations", "Params", "", "pages"])
def test_an_undeclared_owner_raises_the_reference_error(owner):
    with pytest.raises(ValueError) as ours:
        memledger.MemLedger().register(owner, "cuda:0", "k", 1)
    with pytest.raises(ValueError) as theirs:
        jax_memledger.MemLedger().register(owner, "cuda:0", "k", 1)
    assert str(ours.value) == str(theirs.value)


def test_owners_are_the_reference_s():
    assert memledger.MEM_OWNERS == jax_memledger.MEM_OWNERS


def test_a_shared_key_counts_once_and_a_dying_probe_is_skipped():
    ledger = memledger.MemLedger()
    ledger.register("params", "cuda:0", ("params", 1), 100, live=True)
    ledger.register("params", "cuda:0", ("params", 1), 100, live=True)
    ledger.register("cache", "cuda:0", "c", lambda: 1 // 0)
    assert ledger.sample() == {"total": 100, "owners": {"params": 100},
                               "devices": {"cuda:0": 100}}


def test_on_the_cpu_the_ledger_is_not_reconciled_and_the_check_accepts_it():
    ledger = memledger.MemLedger()
    ledger.register("params", "cpu", "p", 100, live=True)
    assert ledger.reconcile() == (0, False)
    plane = devobs.DevObsPlane(devobs.DevObsSettings())
    plane.ledger.register("params", "cpu", "p", 100, live=True)
    summary = plane.memory_summary()
    assert (summary["live_bytes"], summary["reconciled"]) == (0, 0)


def test_the_module_hook_is_one_none_test_when_off():
    memledger.register("undeclared-but-off", "cuda:0", "k", 1)
    ledger = memledger.MemLedger()
    memledger.ACTIVE = ledger
    memledger.register("page_pool", "cuda:0", "k", 7, live=True)
    assert ledger.sample()["owners"] == {"page_pool": 7}


def test_the_pager_registers_its_arenas_and_shared_pools():
    from rnb_tpu_torch.pager import Pager, PagerSettings
    ledger = memledger.MemLedger()
    memledger.ACTIVE = ledger
    pager = Pager(PagerSettings(page_rows=2))
    arena = pager.create_arena("clips", (4,), torch.float32,
                               budget_bytes=1024)
    pool = torch.zeros((3, 5), dtype=torch.float32)
    pager.adopt_shared("pool", pool)
    assert ledger.sample()["owners"] == {"page_pool": arena.nbytes + 60}
    assert pager.owns(pool)


# -- compute meters, polls and summaries ------------------------------------

def _plane_pair(**settings):
    return (devobs.DevObsPlane(devobs.DevObsSettings(**settings)),
            jax_devobs.DevObsPlane(jax_devobs.DevObsSettings(**settings)))


def _feed(plane, module, seed, peak):
    rng = np.random.default_rng(seed)
    plane._peak_resolved = True
    plane._peak_tflops = peak
    for step in range(int(rng.integers(1, 4))):
        meter = module.StageComputeMeter(
            step, int(rng.integers(1, 10**11)),
            devices=int(rng.integers(1, 3)),
            bytes_per_row=(None if rng.random() < 0.5
                           else float(rng.integers(1, 10**9))))
        plane.meters[step] = meter
        for _ in range(int(rng.integers(0, 30))):
            meter.note(int(rng.integers(0, 16)), float(rng.random() / 50))
    plane.ledger.register("params", "cuda:0", "p", int(rng.integers(10**8)),
                          live=True)
    plane.ledger.register("staging", "cuda:0", "s", int(rng.integers(10**7)))
    return float(rng.random() * 5 + 0.01), int(rng.integers(1, 3))


@pytest.mark.parametrize("peak", [None, 989.4, 197.0])
@pytest.mark.parametrize("seed", range(4))
def test_compute_summary_and_poll_equal_the_reference(seed, peak):
    ours, theirs = _plane_pair()
    window, used = _feed(ours, devobs, seed, peak)
    assert _feed(theirs, jax_devobs, seed, peak) == (window, used)
    assert ours.compute_summary(window, used) \
        == theirs.compute_summary(window, used)
    assert ours.metrics_poll() == theirs.metrics_poll()
    for step, meter in ours.meters.items():
        assert meter.achieved_tflops() \
            == theirs.meters[step].achieved_tflops()


def test_a_plane_with_no_meter_still_counts_its_captures():
    ours, theirs = _plane_pair()
    assert ours.compute_summary(1.0, 1) == theirs.compute_summary(1.0, 1)
    assert ours.compute_summary(1.0, 1)["stages"] == 0


def test_a_cpu_stage_has_no_peak():
    plane = devobs.DevObsPlane(devobs.DevObsSettings())
    from rnb_tpu_torch.devices import DeviceSpec
    runner = port_model.R2P1DRunner("cpu", num_classes=CLASSES,
                                    layer_sizes=LS, max_rows=2,
                                    row_buckets=[2], num_warmups=0)
    plane.add_stage(runner, 1, DeviceSpec(0, "cpu"))
    assert plane._peak() is None
    assert plane.compute_summary(1.0, 1)["mfu_e4"] == -1
    assert set(plane.ledger.sample()["owners"]) == {"params"}


# -- the trace merge ----------------------------------------------------------

def _spans_and_captures(seed):
    rng = np.random.default_rng(seed)
    events = []
    t = 1.7e9
    for rid in range(12):
        t0 = t + float(rng.random() / 100)
        step = int(rng.integers(2))
        events.append(("exec%d.model_call" % step, "X", t0,
                       float(rng.random() / 50), "runner-s%d" % step,
                       None if rng.random() < 0.2 else rid, None))
        events.append(("exec%d.publish" % step, "X", t0, 0.001, "r", rid,
                       None))
        t = t0
    captures = []
    for index in range(2):
        intervals = []
        for plane in ("/device:GPU:0", "/host:CPU"):
            base = int(rng.integers(10**9))
            for _ in range(int(rng.integers(1, 20))):
                s = base + int(rng.integers(10**8))
                intervals.append(("k%d" % int(rng.integers(5)), s,
                                  s + int(rng.integers(10**6)), plane))
        anchors = {}
        for _n, _s, e, plane in intervals:
            anchors[plane] = max(anchors.get(plane, 0),
                                 e + int(rng.integers(2)) * 1000)
        t1 = 1.7e9 + float(rng.random() / 10)
        captures.append((index, "forced", t1 - 0.25, t1,
                         sorted(intervals, key=lambda iv: iv[1]),
                         len(intervals), None, anchors))
    return events, captures


@pytest.mark.parametrize("seed", range(4))
def test_device_events_equal_the_reference(seed):
    events, captures = _spans_and_captures(seed)
    spans = devobs.model_call_spans(events)
    assert spans == jax_devobs.model_call_spans(events)
    ours, theirs = _plane_pair()
    for cap in captures:
        ours.captures.append(devobs._Capture(*cap))
        theirs.captures.append(jax_devobs._Capture(*cap))
    got = ours.device_events(spans)
    assert got == theirs.device_events(spans)
    assert {e[4] for e in got} == {"device:/device:GPU:0",
                                   "device:/host:CPU"}


# -- capture budget and triggers -------------------------------------------

def test_the_capture_budget_and_hooks_equal_the_reference():
    ours, theirs = _plane_pair(max_captures=2)
    for plane in (ours, theirs):
        plane.request_capture("forced")
        plane.on_trigger("queue_saturation", {"depth": 1})
        plane.on_trigger("slo_burn", None)
        plane._watermark_capture(10)
    assert ours._capture_requests == theirs._capture_requests \
        == ["forced", "queue_saturation"]
    assert ours.captures_skipped == theirs.captures_skipped == 2
    quiet = devobs.DevObsPlane(devobs.DevObsSettings(
        capture_on_trigger=False))
    quiet.on_trigger("slo_burn", None)
    quiet._watermark_capture(10)
    assert quiet._capture_requests == []


def test_with_a_registry_the_watermark_arms_one_capture_through_the_hook():
    plane = devobs.DevObsPlane(devobs.DevObsSettings(watermark_mb=1))
    registry = metrics.MetricsRegistry(metrics.MetricsSettings())
    registry.trigger_hooks.append(plane.on_trigger)
    metrics.ACTIVE = registry
    plane.ledger.register("params", "cuda:0", "p", 2 * MIB)
    plane.ledger.sample()
    assert plane._capture_requests == [metrics.TRIGGER_MEMORY_WATERMARK]
    # the recorder is disarmed (no ring): the hook fired all the same
    assert registry.num_triggers == 0


@pytest.mark.parametrize("raw", [
    None, {}, {"enabled": False}, {"watermark_mb": 256},
    {"capture_window_ms": 300, "max_captures": 2, "capture_max_ops": 10,
     "sample_hz": 5, "capture_on_trigger": False}])
def test_settings_equal_the_reference(raw):
    ours = devobs.DevObsSettings.from_config(raw)
    theirs = jax_devobs.DevObsSettings.from_config(raw)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert {k: getattr(ours, k) for k in ours.__slots__} \
            == {k: getattr(theirs, k) for k in theirs.__slots__}


# -- the devobs root key -------------------------------------------------------

@pytest.mark.parametrize("value", [
    {"enabled": True, "watermark_mb": 256},
    {"enabled": False},
    {"capture_window_ms": 0, "max_captures": 1, "sample_hz": 0.5},
    {"watermark_mb": 1.5, "capture_max_ops": 100},
    "on",
    {"xplane": True},
    {"enabled": "yes"},
    {"capture_on_trigger": 1},
    {"capture_window_ms": -1},
    {"capture_window_ms": True},
    {"max_captures": 0},
    {"capture_max_ops": 2.5},
    {"watermark_mb": 0},
    {"sample_hz": False}])
def test_the_devobs_key_is_accepted_and_refused_as_the_reference(value):
    with open(CONFIG) as f:
        raw = json.load(f)
    raw["devobs"] = value
    try:
        jax_config.parse_config(json.loads(json.dumps(raw)))
        theirs = None
    except Exception as e:  # the reference's own error type
        theirs = str(e)
    try:
        cfg = parse_config(raw, platform="cpu")
        ours = None
    except ConfigError as e:
        ours = str(e)
    assert ours == theirs
    if ours is None:
        assert cfg.devobs == value


def test_the_shipped_devobs_config_reads():
    from rnb_tpu_torch.config import load_config
    cfg = load_config(CONFIG, platform="cpu")
    assert cfg.devobs == {"enabled": True, "watermark_mb": 256}
    assert devobs.DevObsSettings.from_config(cfg.devobs).watermark_mb == 256


# -- the slice as a whole ------------------------------------------------------

def _dataset(root, videos=6, frames=40):
    rng = np.random.default_rng(0)
    for i in range(videos):
        label = os.path.join(root, "label%d" % (i % 2))
        os.makedirs(label, exist_ok=True)
        write_y4m(os.path.join(label, "v%02d.y4m" % i),
                  rng.integers(0, 256, (frames, 112, 112, 3),
                               dtype=np.uint8), colorspace="420")
    return root


def _reduced(tmp, name, devobs_on):
    with open(CONFIG) as f:
        raw = json.load(f)
    if not devobs_on:
        del raw["devobs"]
    loader, runner = raw["pipeline"]
    loader.update(max_clips=3, row_buckets=[1, 3], fuse=3)
    runner.update(max_rows=3, row_buckets=[1, 3], layer_sizes=list(LS),
                  num_classes=CLASSES)
    path = os.path.join(tmp, name + ".json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The reduced devobs cell (one forced capture) and the same config
    without the key, on the JAX package's weights."""
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

    tmp = str(tmp_path_factory.mktemp("devobs"))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_model, "shared_network", shared_network)
        mp.setenv("RNB_TPU_DATA_ROOT", _dataset(os.path.join(tmp, "data")))
        for label, on in (("devobs", True), ("off", False)):
            if on:
                mp.setenv(devobs.FORCE_ENV, "1")
            else:
                mp.delenv(devobs.FORCE_ENV, raising=False)
            sink = {}
            result = run_benchmark(
                _reduced(tmp, label, on), mean_interval_ms=0,
                num_videos=REQUESTS, log_base=os.path.join(tmp, "logs"),
                print_progress=False, seed=0, platform="cpu",
                outputs_sink=sink)
            assert result.termination_flag == 0
            assert devobs.ACTIVE is None and memledger.ACTIVE is None
            assert not profiler._capturing
            runs[label] = (result, sink)
    return weights, runs, tmp


def _jax_logits(weights, video, n):
    decoder = jax_get_decoder(video)
    starts = JaxSampler(consecutive_frames=8).sample(
        decoder.num_frames(video), video_id=video)[:3]
    rows = np.asarray(decoder.decode_clips_yuv(video, starts, 8, 112, 112))
    assert len(rows) == n
    pool = np.zeros((3,) + rows.shape[1:], np.uint8)
    pool[:n] = rows
    apply = _shared_apply(1, 5, CLASSES, LS, pixel_path="yuv420")
    return np.asarray(apply(weights, pool))[:n]


@pytest.mark.parametrize("label", ["devobs", "off"])
def test_the_slice_serves_the_jax_logits(served, label):
    weights, runs, _ = served
    result, sink = runs[label]
    assert result.num_completed == len(sink) == REQUESTS
    for video, logits, _stamps in sink.values():
        want = _jax_logits(weights, video, len(logits))
        bound = 0.02 * float(np.abs(want).max())
        assert logits.shape == want.shape
        assert np.abs(logits - want).max() <= bound


def test_the_devobs_run_checks_with_rows_equal_to_the_clips(served):
    _, runs, _ = served
    result, _ = runs["devobs"]
    assert summarize(result.log_dir)["footing_problems"] == []
    assert result.compute_stages == 1
    assert result.compute_rows == result.clips_completed > 0
    step1 = result.compute_stage_detail["step1"]
    assert step1["rows"] == result.clips_completed
    assert step1["flops_per_row"] == jax_flops.range_flops_per_clip(
        num_classes=CLASSES, layer_sizes=LS)
    assert step1["mfu_busy"] is None and result.compute_mfu_e4 == -1
    assert step1["ai_flops_per_byte"] is None
    assert result.compute_captures == 1 and result.compute_captures_skipped == 0
    assert set(result.memory_owner_detail) == {"params", "staging"}
    assert (result.memory_live_bytes, result.memory_reconciled) == (0, 0)
    assert result.memory_watermark_bytes == 256 * MIB
    assert result.memory_watermark_hits == 0


def test_the_capture_is_read_by_the_reference_tools(served, monkeypatch,
                                                    capsys):
    _, runs, _ = served
    log_dir = runs["devobs"][0].log_dir
    path = os.path.join(log_dir, "devobs-capture-0.txt")
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "# t0_ns t1_ns plane op_name"
    assert lines[2].startswith("# trigger forced ops_total ")
    assert len(lines) > 3
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    import device_busy
    import parse_utils as jax_parse_utils
    assert jax_parse_utils._check_capture_artifact(path) == []
    assert device_busy.main([log_dir]) == 0
    out = capsys.readouterr().out
    assert "== devobs-capture-0.txt" in out and "Compute: " in out


def test_the_trace_holds_a_device_track(served):
    _, runs, _ = served
    path = os.path.join(runs["devobs"][0].log_dir, "trace.json")
    assert jax_trace.validate_trace(path) == []
    assert "device:/host:CPU" in trace.track_names(path)


def test_without_the_key_nothing_is_added(served):
    _, runs, _ = served
    on, off = runs["devobs"][0], runs["off"][0]
    assert sorted(os.listdir(off.log_dir)) == [
        "cpu0-group0-0.txt", "log-meta.txt", "metrics.jsonl",
        "metrics.prom", "trace.json"]
    assert sorted(os.listdir(on.log_dir)) == sorted(
        os.listdir(off.log_dir) + ["devobs-capture-0.txt"])

    def heads(log_dir):
        with open(os.path.join(log_dir, "log-meta.txt")) as f:
            return [line.split(":")[0] for line in f.read().splitlines()
                    if ":" in line]
    devobs_heads = {"Compute", "Compute stages", "Memory", "Memory owners"}
    assert not devobs_heads & set(heads(off.log_dir))
    assert [h for h in heads(on.log_dir) if h not in devobs_heads] \
        == heads(off.log_dir)
    # the stamp header of the timing table, byte for byte
    tables = []
    for result in (on, off):
        with open(os.path.join(result.log_dir, "cpu0-group0-0.txt")) as f:
            tables.append(f.readline())
    assert tables[0] == tables[1]
    assert off.compute_stages == off.memory_owners == 0


def _reference_view(log_dir, dest):
    """The job directory as the reference's reader takes it: the window
    line and the four devobs lines of log-meta, and the capture files."""
    os.makedirs(dest)
    for name in os.listdir(log_dir):
        if name.startswith("devobs-capture-"):
            shutil.copy(os.path.join(log_dir, name), dest)
    with open(os.path.join(log_dir, "log-meta.txt")) as f:
        lines = [line for line in f.read().splitlines()
                 if line.startswith(("Compute", "Memory"))
                 or (len(line.split()) == 2
                     and line.replace(".", "").replace(" ", "").isdigit())]
    with open(os.path.join(dest, "log-meta.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return dest


def _edit_meta(log_dir, head, edit):
    path = os.path.join(log_dir, "log-meta.txt")
    with open(path) as f:
        lines = f.read().splitlines()
    out = []
    for line in lines:
        if line.startswith(head + ": "):
            line = head + ": " + edit(line[len(head) + 2:])
        out.append(line)
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def _kv_edit(key, value):
    def edit(rest):
        return " ".join("%s=%s" % (k, value if k == key else v)
                        for k, v in (kv.split("=") for kv in rest.split()))
    return edit


def _json_edit(fn):
    def edit(rest):
        obj = json.loads(rest)
        fn(obj)
        return json.dumps(obj, sort_keys=True)
    return edit


def _append(path, text):
    with open(path, "a") as f:
        f.write(text)


def _owner_plus_one(obj):
    obj["params"]["bytes"] += 1
    obj["params"]["peak_bytes"] += 1


TAMPERS = {
    "clean": lambda d: None,
    "owner_footing": lambda d: _edit_meta(d, "Memory owners",
                                          _json_edit(_owner_plus_one)),
    "cooked_tflops": lambda d: _edit_meta(d, "Compute",
                                          _kv_edit("tflops_milli", 900)),
    "malformed_detail": lambda d: _edit_meta(
        d, "Compute stages",
        _json_edit(lambda o: o["step1"].update(rows="many"))),
    "stage_flops": lambda d: _edit_meta(
        d, "Compute stages",
        _json_edit(lambda o: o["step1"].update(flops=7))),
    "mfu_over_one": lambda d: _edit_meta(d, "Compute",
                                         _kv_edit("mfu_e4", 12000)),
    "watermark_unreached": lambda d: _edit_meta(
        d, "Memory", _kv_edit("watermark_hits", 1)),
    "reconciled_without_live": lambda d: _edit_meta(
        d, "Memory", _kv_edit("reconciled", 1)),
    "live_unreconciled": lambda d: _edit_meta(
        d, "Memory", _kv_edit("live_bytes", 4096)),
    "undeclared_owner": lambda d: _edit_meta(
        d, "Memory owners",
        _json_edit(lambda o: o.update(ghost={"bytes": 0, "peak_bytes": 0}))),
    "capture_missing": lambda d: os.remove(
        os.path.join(d, "devobs-capture-0.txt")),
    "capture_overrun": lambda d: _append(
        os.path.join(d, "devobs-capture-0.txt"), "1 2 /x op\n"),
}


@pytest.mark.parametrize("tamper", list(TAMPERS))
def test_the_check_finds_what_the_reference_finds(served, tmp_path,
                                                  monkeypatch, tamper):
    _, runs, _ = served
    job = str(tmp_path / "job")
    shutil.copytree(runs["devobs"][0].log_dir, job)
    TAMPERS[tamper](job)
    ours = devobs_problems(job, read_meta(os.path.join(job, "log-meta.txt")))
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    import parse_utils as jax_parse_utils
    ref = _reference_view(job, str(tmp_path / "ref"))
    theirs = jax_parse_utils._check_devobs(ref,
                                           jax_parse_utils.parse_meta(ref))
    assert ours == theirs
    assert bool(ours) == (tamper != "clean")
    if tamper != "clean":
        assert summarize(job)["footing_problems"]
        from rnb_tpu_torch.parse_utils import main
        assert main([job]) == 1
