"""Segment-parallel serving in the port, held to the JAX package.

The same numpy inputs, made from a seed, go through the JAX package's
function and the port's: ``split_segments`` (bitwise, pad rows included),
``TimeCard.fork``/``merge`` (keys, order, device trails, errors),
``R2P1DAggregator`` (class id and merged keys), the config reader on
``num_segments``/``aggregate``/``trace``, and the one-card segment copy
of ``configs/r2p1d-segment.json`` end to end through
``run_benchmark(platform="cpu")`` against the JAX stages on the same
videos with the same weights. Reduced: 3-clip videos of 2 frames, layer
sizes (1, 1, 1, 1), 8 classes, 1-row segments; widths as published.
"""

import glob
import io
import json
import os

import numpy as np
import pytest
import torch

import jax

from rnb_tpu import config as jax_config
from rnb_tpu import runner as jax_runner
from rnb_tpu import telemetry as jax_telemetry
from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.models.r2p1d import model as jax_model
from rnb_tpu.stage import PaddedBatch as JaxPaddedBatch
from rnb_tpu_torch.benchmark import _bulk_queue_size
from rnb_tpu_torch.config import ConfigError, load_config, parse_config
from rnb_tpu_torch.models.r2p1d import model as port_model
from rnb_tpu_torch.models.r2p1d.checkpoint import (filter_layer_range,
                                                   from_jax_variables)
from rnb_tpu_torch.models.r2p1d.network import (R2Plus1DClassifier,
                                                cast_compute_weights)
from rnb_tpu_torch.parse_utils import read_table, summarize
from rnb_tpu_torch.runner import split_segments
from rnb_tpu_torch.stage import PaddedBatch
from rnb_tpu_torch.telemetry import (CONTENT_STAMPS, TimeCard,
                                     TimeCardList, TimeCardSummary)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEGMENT_CONFIG = os.path.join(REPO, "configs/r2p1d-segment.json")
LS = (1, 1, 1, 1)
CLASSES = 8
FRAMES = 2
SEGMENTS = 3
REQUESTS = 9
LOADER = dict(max_clips=3, consecutive_frames=FRAMES,
              num_clips_population=[1, 3], weights=[2, 1])


def _segment_copy_raw():
    """The one-card copy: every device index >= 0 becomes 0."""
    with open(SEGMENT_CONFIG) as f:
        raw = json.load(f)
    for step in raw["pipeline"]:
        for group in step["queue_groups"]:
            group["devices"] = [0 if d >= 0 else d
                                for d in group["devices"]]
    return raw


# -- split_segments ----------------------------------------------------

def _payload(valid, seed):
    """Two tensors of 15 rows (uint8 frames and float32 features) made
    from a seed, both with ``valid`` meaningful rows."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (15, 2, 3), dtype=np.uint8),
            rng.standard_normal((15, 4)).astype(np.float32))


@pytest.mark.parametrize("num_segments", [1, 2, 3, 4])
@pytest.mark.parametrize("valid", list(range(16)))
def test_split_segments_bitwise_the_reference(valid, num_segments):
    arrays = _payload(valid, seed=100 * valid + num_segments)
    port = split_segments(tuple(PaddedBatch(torch.from_numpy(a), valid)
                                for a in arrays), num_segments)
    ref = jax_runner.split_segments(
        tuple(JaxPaddedBatch(jax.numpy.asarray(a), valid) for a in arrays),
        num_segments)
    assert len(port) == len(ref) == num_segments
    seg_rows = -(-15 // num_segments)
    for seg_idx, (mine, theirs) in enumerate(zip(port, ref)):
        assert len(mine) == len(theirs) == 2
        assert sum(p[0].valid for p in port) == valid
        for pb, want, array in zip(mine, theirs, arrays):
            got = pb.data.numpy()
            assert pb.valid == want.valid
            assert got.dtype == np.asarray(want.data).dtype
            assert got.tobytes() == np.asarray(want.data).tobytes()
            if num_segments == 1:
                assert got.tobytes() == array.tobytes()
                continue
            # the pad rows are the next segment's rows, not zeros; zeros
            # only past the end of the batch
            q, r = divmod(valid, num_segments)
            start = q * seg_idx + min(seg_idx, r)
            inside = max(0, min(seg_rows, 15 - start))
            assert got.shape[0] == seg_rows
            assert got[:inside].tobytes() == \
                array[start:start + inside].tobytes()
            assert not got[inside:].any()


def test_split_segments_spreads_the_remainder_from_the_front():
    arrays = _payload(11, seed=7)
    segments = split_segments(tuple(PaddedBatch(torch.from_numpy(a), 11)
                                    for a in arrays), 3)
    assert [seg[0].valid for seg in segments] == [4, 4, 3]
    # segment 2 starts at row 8; its pad rows 11 and 12 are batch rows,
    # not zeros
    assert segments[2][0].data.numpy().tobytes() == \
        arrays[0][8:13].tobytes()
    assert segments[2][1].data.numpy()[3:].any()
    # views: no segment inside the batch is a copy
    base = torch.from_numpy(arrays[0].copy())
    views = split_segments((PaddedBatch(base, 11),), 3)
    assert [v[0].data.data_ptr() for v in views] == [
        base[start].data_ptr() for start in (0, 4, 8)]


# -- TimeCard fork / merge ---------------------------------------------

def _both(stamps_before, devices_before):
    """The same card in both packages."""
    cards = []
    for module in (jax_telemetry, None):
        tc = (module.TimeCard(17) if module else TimeCard(17))
        for key, at in stamps_before:
            tc.record(key, at=at)
        for label in devices_before:
            tc.add_device(label)
        tc.num_clips = 11
        cards.append(tc)
    return cards


def _forked_pair(devices, order):
    """Both packages' merged card of three forks whose step-1 devices are
    ``devices`` and which reach the merge in ``order``."""
    merged = []
    for tc in _both([("enqueue_filename", 1.0), ("runner0_start", 1.5),
                     ("inference0_finish", 2.0)], ["cuda:0"]):
        kids = [tc.fork(i) for i in range(3)]
        for i, kid in enumerate(kids):
            kid.add_device(devices[i])
            kid.record("runner1_start", at=3.0 + i)
            kid.record("inference1_finish", at=4.0 + 0.5 * i)
            kid.add_device("host")
            kid.record("runner2_start", at=5.0 + i)
        merged.append(type(tc).merge([kids[i] for i in order]))
    return merged


@pytest.mark.parametrize("devices,order", [
    (("cuda:0", "cuda:0", "cuda:0"), (0, 1, 2)),
    (("cuda:0", "cuda:0", "cuda:0"), (2, 0, 1)),
    (("cuda:1", "cuda:2", "cuda:3"), (1, 2, 0)),
    (("cuda:0", "cuda:0", "cuda:1"), (0, 2, 1)),
])
def test_merge_matches_the_reference(devices, order):
    ref, port = _forked_pair(devices, order)
    assert list(port.timings.items()) == list(ref.timings.items())
    assert list(port.timings)[:4] == [
        "enqueue_filename", "runner0_start", "inference0_finish",
        "runner1_start-0"]
    assert port.devices == ref.devices
    assert port.devices[1] == (("cuda:0",) if len(set(devices)) == 1
                               else tuple(devices))
    assert port.id == ref.id == 17 and port.sub_id is None
    assert port.num_clips == ref.num_clips == 11


def test_fork_carries_the_content_stamps():
    tc = TimeCard(3)
    values = dict(num_clips=5, video="v.y4m", row0=2, cache_hit=False,
                  cache_coalesced=True, feature_hit=False, pad_rows=4,
                  deadline_s=12.5, redispatched=1, hedge_copy=True,
                  hedge_resolved=False)
    for key, value in values.items():
        setattr(tc, key, value)
    assert set(values) == set(CONTENT_STAMPS)
    tc.record("a", at=1.0)
    tc.feature_plan = object()  # transient: never forked
    kids = [tc.fork(i) for i in range(2)]
    for kid in kids:
        assert {k: getattr(kid, k) for k in values} == values
        assert kid.feature_plan is None
        kid.record("b")
    merged = TimeCard.merge(kids)
    assert {k: getattr(merged, k) for k in values} == values


def _card_errors(module):
    """Each invalid fork or merge, as both packages are asked it."""
    def twice():
        module.TimeCard(1).fork(0).fork(1)

    def keys():
        a, b = module.TimeCard(1).fork(0), module.TimeCard(1).fork(1)
        a.record("x", at=1.0)
        module.TimeCard.merge([a, b])

    def points():
        parent = module.TimeCard(1)
        a = parent.fork(0)
        parent.record("x", at=1.0)
        b = parent.fork(1)
        a.record("x", at=1.0)
        module.TimeCard.merge([a, b])

    def duplicate():
        parent = module.TimeCard(1)
        module.TimeCard.merge([parent.fork(0), parent.fork(0)])

    def unforked():
        module.TimeCard.merge([module.TimeCard(1)])

    def empty():
        module.TimeCard.merge([])

    return dict(twice=twice, keys=keys, points=points, duplicate=duplicate,
                unforked=unforked, empty=empty)


class _PortCards:
    TimeCard = TimeCard


@pytest.mark.parametrize("case", ["twice", "keys", "points", "duplicate",
                                  "unforked", "empty"])
def test_fork_and_merge_refuse_what_the_reference_refuses(case):
    with pytest.raises(Exception) as ref:
        _card_errors(jax_telemetry)[case]()
    with pytest.raises(Exception) as port:
        _card_errors(_PortCards)[case]()
    assert type(port.value) is type(ref.value)
    assert str(port.value) == str(ref.value)


def test_a_fused_list_cannot_be_forked():
    with pytest.raises(NotImplementedError):
        TimeCardList([TimeCard(0)]).fork(0)


def test_summary_table_stays_rectangular_like_the_reference():
    """Segments on one device collapse to one column, on several they
    take one each; narrower rows are padded with '-' (the JAX test of
    the same name's inputs, and a mixed run)."""
    reports = []
    for module in (jax_telemetry, None):
        summary = (module.TimeCardSummary() if module
                   else TimeCardSummary())
        for labels in (("tpu:0", "tpu:1"), ("tpu:0", "tpu:0")):
            parent = (module.TimeCard(0) if module else TimeCard(0))
            parent.record("a", at=1.0)
            kids = [parent.fork(i) for i in range(2)]
            for kid, label in zip(kids, labels):
                kid.add_device(label)
                kid.record("b", at=2.0)
            summary.register(type(parent).merge(kids))
        buf = io.StringIO()
        summary.save_full_report(buf)
        reports.append(buf.getvalue())
    assert reports[1] == reports[0]
    lines = reports[1].splitlines()
    assert lines[0].split() == ["a", "b-0", "b-1", "device0-0",
                                "device0-1"]
    assert lines[1].split()[-2:] == ["tpu:0", "tpu:1"]
    assert lines[2].split()[-2:] == ["tpu:0", "-"]


# -- R2P1DAggregator ---------------------------------------------------

@pytest.mark.parametrize("valid,order", [
    ((1, 0, 0), (0, 1, 2)),   # a 1-clip request: two empty segments
    ((1, 1, 1), (2, 1, 0)),
    ((2, 2, 1), (1, 0, 2)),
    ((5, 5, 5), (0, 2, 1)),
])
def test_aggregator_matches_the_reference(valid, order):
    rng = np.random.default_rng(sum(valid))
    logits = [rng.standard_normal((5, 400)).astype(np.float32)
              for _ in range(3)]
    outputs = []
    for module, batch, aggregator in (
            (jax_telemetry, JaxPaddedBatch,
             jax_model.R2P1DAggregator(None, aggregate=3)),
            (None, PaddedBatch,
             port_model.R2P1DAggregator(torch.device("cpu"), aggregate=3))):
        parent = (module.TimeCard(9) if module else TimeCard(9))
        parent.record("enqueue_filename", at=1.0)
        kids = [parent.fork(i) for i in range(3)]
        results = []
        for i in order:
            kids[i].record("inference1_finish", at=2.0 + i)
            data = (logits[i] if module else torch.from_numpy(logits[i]))
            results.append(aggregator((batch(data, valid[i]),), None,
                                      kids[i]))
        assert [r[2] is None for r in results] == [True, True, False]
        assert results[-1][0] is None
        outputs.append(results[-1])
    (_, ref_id, ref_card), (_, port_id, port_card) = outputs
    assert isinstance(port_id, int) and port_id == ref_id
    assert list(port_card.timings.items()) == list(ref_card.timings.items())
    # the class id is the argmax of the sum over the valid rows
    total = sum(l[:v].sum(axis=0) for l, v in zip(logits, valid))
    assert port_id == int(np.argmax(total))


def test_aggregator_of_one_passes_the_card_through():
    agg = port_model.R2P1DAggregator(torch.device("cpu"), aggregate=1)
    tc = TimeCard(0)
    out = agg((PaddedBatch(torch.eye(4), 2),), None, tc)
    assert out[2] is tc and out[1] == 0
    with pytest.raises(ValueError, match="aggregate"):
        port_model.R2P1DAggregator(torch.device("cpu"), aggregate=0)
    assert port_model.R2P1DAggregator.output_shape_for(aggregate=3) is None


# -- the config reader -------------------------------------------------

def test_segment_copy_reads_as_the_reference_reads_it():
    raw = _segment_copy_raw()
    jax_cfg = jax_config.parse_config(json.loads(json.dumps(raw)))
    cfg = parse_config(raw, platform="cpu")
    assert [s.num_segments for s in cfg.steps] == \
        [s.num_segments for s in jax_cfg.steps] == [3, 1, 1]
    assert [s.model.rpartition(".")[2] for s in cfg.steps] == [
        "R2P1DLoader", "R2P1DRunner", "R2P1DAggregator"]
    runners = cfg.steps[1].groups[0].devices
    assert [d.label for d in runners] == ["cpu:0"] * 7
    assert cfg.steps[2].groups[0].devices[0].label == "host"
    assert cfg.steps[2].kwargs == {"aggregate": 3}
    assert cfg.steps[1].kwargs["max_rows"] == 5
    assert cfg.num_runners == 9
    # bulk queues hold every segment and the exit markers
    assert _bulk_queue_size(cfg, 100) == 300 + 9 + 10 + 1


def _one_device_configs():
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "*.json"))):
        with open(path) as f:
            raw = json.load(f)
        devices = [d for s in raw["pipeline"] for g in s["queue_groups"]
                   for d in g.get("devices", ())]
        if max(devices) <= 0:
            out.append(os.path.basename(path))
    return out


def test_seventeen_of_the_one_device_configs_read():
    """All 23 one-device configs now read (the name counts the configs
    read before the metrics, autotune, devobs and operator planes and the
    network edge were ported); none is refused."""
    read, refused = [], {}
    for name in _one_device_configs():
        try:
            load_config(os.path.join(REPO, "configs", name),
                        platform="cpu")
            read.append(name)
        except ConfigError as e:
            refused[name] = str(e)
    assert len(read) + len(refused) == 23 and len(read) == 23
    assert {"rnb-fused-yuv-traced.json", "rnb-fused-yuv-metrics.json",
            "rnb-fused-yuv-autotune.json", "rnb-fused-yuv-devobs.json",
            "rnb-fused-yuv-operator.json", "rnb-netedge-loopback.json",
            "rnb-netedge-off.json"} <= set(read)
    assert refused == {}


def test_the_tiny_shed_config_now_reads():
    """``configs/r2p1d-tiny-shed.json`` (its first unported key was
    ``overload_policy``) reads on the CPU as the reference reads it, and
    with the devobs and operator planes, the step-level ``shard`` key and
    the network edge's ``netedge`` and ``health`` keys ported 36 of the
    41 shipped configs read."""
    path = os.path.join(REPO, "configs", "r2p1d-tiny-shed.json")
    cfg = load_config(path, platform="cpu")
    with open(path) as f:
        jax_cfg = jax_config.parse_config(json.load(f))
    assert cfg.overload_policy == jax_cfg.overload_policy == "shed"
    assert [(s.max_retries, s.retry_backoff_ms) for s in cfg.steps] == \
        [(s.max_retries, s.retry_backoff_ms) for s in jax_cfg.steps] == \
        [(2, 5.0), (0, 10.0)]
    assert [s.model.rpartition(".")[2] for s in cfg.steps] == [
        "R2P1DLoader", "R2P1DRunner"]
    read = 0
    names = sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))
    for name in names:
        try:
            load_config(name, platform="cpu")
            read += 1
        except ConfigError:
            pass
    assert (read, len(names)) == (39, 41)


def _mutated(case):
    raw = _segment_copy_raw()
    loader, runner, aggregator = raw["pipeline"]
    if case == "zero":
        loader["num_segments"] = 0
    elif case == "float":
        loader["num_segments"] = 1.5
    elif case == "last":
        aggregator["num_segments"] = 3
    elif case == "buckets":
        loader["row_buckets"] = [1, 15]
    elif case == "slots":
        loader["num_shared_tensors"] = 2
    elif case == "default-slots":
        del loader["num_shared_tensors"]
        loader["num_segments"] = 11
    elif case == "ragged":
        raw["ragged"] = {"enabled": True}
    elif case.startswith("trace-"):
        raw["trace"] = {"trace-enabled": {"enabled": "yes"},
                        "trace-hz": {"sample_hz": -1},
                        "trace-events": {"max_events": 0},
                        "trace-key": {"enabled": True, "hz": 5},
                        "trace-type": [1]}[case]
    return raw


@pytest.mark.parametrize("case", [
    "zero", "float", "last", "buckets", "slots", "default-slots", "ragged",
    "trace-enabled", "trace-hz", "trace-events", "trace-key", "trace-type"])
def test_config_refusals_carry_the_reference_message(case):
    raw = _mutated(case)
    with pytest.raises(jax_config.ConfigError) as ref:
        jax_config.parse_config(json.loads(json.dumps(raw)))
    with pytest.raises(ConfigError) as port:
        parse_config(raw, platform="cpu")
    assert str(port.value) == str(ref.value)


def test_disabled_or_absent_trace_key_reads():
    raw = _segment_copy_raw()
    assert parse_config(raw, platform="cpu").trace is None
    raw["trace"] = {"enabled": False}
    assert parse_config(raw, platform="cpu").trace == {"enabled": False}
    from rnb_tpu_torch.trace import TraceSettings
    assert TraceSettings.from_config({"enabled": False}) is None
    settings = TraceSettings.from_config({"sample_hz": 5})
    assert (settings.enabled, settings.sample_hz, settings.max_events) == (
        True, 5.0, 200000)


# -- the segment copy end to end ---------------------------------------

@pytest.fixture(scope="module")
def weights():
    return jax_ckpt.load_or_init(1, 5, CLASSES, LS, None)


@pytest.fixture
def bridged_networks(weights, monkeypatch):
    """The port's stages build their networks from the JAX weights."""
    state = from_jax_variables(weights)

    def shared_network(start, end, num_classes, layer_sizes, device,
                       dtype=torch.bfloat16, factored_shortcut=False):
        assert (num_classes, tuple(layer_sizes)) == (CLASSES, LS)
        net = R2Plus1DClassifier(start, end, num_classes, layer_sizes,
                                 factored_shortcut, dtype=dtype)
        net.load_state_dict(filter_layer_range(state, start, end),
                            strict=True)
        return cast_compute_weights(net).to(device).eval()

    monkeypatch.setattr(port_model, "shared_network", shared_network)


def _reduced_segment_copy(tmp_path):
    raw = _segment_copy_raw()
    loader, runner, _aggregator = raw["pipeline"]
    loader.update(LOADER)
    runner.update(max_rows=1, consecutive_frames=FRAMES,
                  layer_sizes=list(LS), num_classes=CLASSES, num_warmups=1)
    path = str(tmp_path / "r2p1d-segment-1card.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _jax_class_ids(videos):
    """The JAX stages on the same videos: loader, split, three runners,
    aggregator; returns {video: (class id, summed logits, clips)}."""
    device = jax.devices()[0]
    loader = jax_model.R2P1DLoader(device, num_warmups=0, **LOADER)
    runner = jax_model.R2P1DRunner(
        device, start_index=1, end_index=5, num_classes=CLASSES,
        layer_sizes=LS, max_rows=1, consecutive_frames=FRAMES,
        num_warmups=0)
    aggregator = jax_model.R2P1DAggregator(None, aggregate=SEGMENTS)
    out = {}
    for rid, video in enumerate(videos):
        card = jax_telemetry.TimeCard(rid)
        tensors, _nt, card = loader(None, video, card)
        total = np.zeros(CLASSES, np.float32)
        result = None
        for seg_idx, seg in enumerate(jax_runner.split_segments(
                tensors, SEGMENTS)):
            logits, nt, fork = runner(seg, None, card.fork(seg_idx))
            total += np.asarray(logits[0].data, np.float32)[
                :logits[0].valid].sum(axis=0)
            result = aggregator(logits, nt, fork)
        out[video] = (result[1], total, int(tensors[0].valid))
    return out


def test_segment_copy_serves_the_class_ids_of_the_jax_stages(
        tmp_path, monkeypatch, bridged_networks):
    from rnb_tpu_torch.benchmark import run_benchmark
    monkeypatch.delenv("RNB_TPU_DATA_ROOT", raising=False)
    sink = {}
    result = run_benchmark(_reduced_segment_copy(tmp_path),
                           mean_interval_ms=0, num_videos=REQUESTS,
                           log_base=str(tmp_path / "logs"),
                           print_progress=False, seed=0, platform="cpu",
                           outputs_sink=sink)
    assert result.termination_flag == 0
    assert result.num_completed == REQUESTS
    assert sorted(sink) == list(range(REQUESTS))
    want = _jax_class_ids([sink[rid][0] for rid in range(REQUESTS)])
    held = 0
    for rid, (video, pred, _stamps) in sorted(sink.items()):
        assert video == "synth://kinetics/video-%04d" % rid
        assert isinstance(pred, int) and 0 <= pred < CLASSES
        ref_id, total, _clips = want[video]
        top2 = np.sort(total)[-2:]
        # bf16 on both sides: hold the id wherever the reference's top-2
        # margin on the summed logits exceeds twice the 2% bound
        if top2[1] - top2[0] > 0.04 * float(np.abs(total).max()):
            assert pred == ref_id
            held += 1
    assert held >= REQUESTS // 2
    # every request went through three segment forwards and one merge
    assert result.compiles["step1"]["steady_calls"] == SEGMENTS * REQUESTS
    stats = summarize(result.log_dir)
    assert stats["emissions_by_step"] == {
        "0": REQUESTS, "1": SEGMENTS * REQUESTS, "2": REQUESTS}
    assert stats["requests"] == REQUESTS and stats["footing_problems"] == []
    (table,) = [n for n in os.listdir(result.log_dir)
                if n.endswith("-0.txt")]
    keys, rows = read_table(os.path.join(result.log_dir, table))
    assert keys[:4] == ["enqueue_filename", "runner0_start",
                        "inference0_start", "inference0_finish"]
    assert keys[4:7] == ["runner1_start-0", "runner1_start-1",
                         "runner1_start-2"]
    assert keys[-1] == "inference2_finish" and len(rows) == REQUESTS
    # end-to-end latency ends at the aggregator's merge
    for row in rows:
        assert row[-1] == max(row)
    # the merged cards count each request's clips once
    assert result.clips_completed == sum(v[2] for v in want.values())
