"""The port's unfused multi-step pipeline as a whole, on the CPU.

``run_benchmark(platform="cpu")`` serves reduced copies of the shipped
topologies — ``r2p1d-whole`` (and a ragged copy, and its yuv420 twin),
``r2p1d-split-1chip``, ``rnb-1chip`` and ``r2p1d-nopipeline-1chip`` —
over the synthetic ids both packages decode byte for byte, and every
request's logits (or class id) are held to the JAX package's own stages
(``R2P1DLoader`` -> ``R2P1DRunner``) run on the same videos with the
same weights: the JAX package's seeded init, carried into the port with
``from_jax_variables``. Both compute in bf16; the bound is stated in
``_assert_logits_close``. Reduced: 3-clip videos of 2 frames, layer
sizes (1, 1, 1, 1), 8 classes; widths as published.

Also here: the executor's payload checks on a mid-pipeline feature map,
and the config reader on the new topologies.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from rnb_tpu import telemetry as jax_telemetry
from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.models.r2p1d import model as jax_model
from rnb_tpu_torch.config import ConfigError, load_config, parse_config
from rnb_tpu_torch.models.r2p1d import model as port_model
from rnb_tpu_torch.models.r2p1d.checkpoint import (filter_layer_range,
                                                   from_jax_variables)
from rnb_tpu_torch.models.r2p1d.network import (R2Plus1DClassifier,
                                                cast_compute_weights)
from rnb_tpu_torch.parse_utils import read_table, summarize
from rnb_tpu_torch.runner import _store_outputs, validate_payload
from rnb_tpu_torch.stage import PaddedBatch, RaggedBatch
from rnb_tpu_torch.telemetry import TimeCard, TimeCardList

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LS = (1, 1, 1, 1)
CLASSES = 8
FRAMES = 2
REQUESTS = 10
LOADER = dict(max_clips=3, consecutive_frames=FRAMES,
              num_clips_population=[1, 3], weights=[2, 1],
              row_buckets=[1, 3])
NETWORK = dict(layer_sizes=list(LS), num_classes=CLASSES)
#: name -> (shipped config, ragged copy?)
TOPOLOGIES = {
    "whole": ("configs/r2p1d-whole.json", False),
    "whole-ragged": ("configs/r2p1d-whole.json", True),
    "whole-yuv": ("configs/r2p1d-whole-yuv.json", False),
    "split": ("configs/r2p1d-split-1chip.json", False),
    "rnb": ("configs/rnb-1chip.json", False),
    "nopipeline": ("configs/r2p1d-nopipeline-1chip.json", False),
}


def _reduced(name, tmp_path):
    """A copy of a shipped config cut to a CPU-sized pipeline."""
    config, ragged = TOPOLOGIES[name]
    with open(os.path.join(REPO, config)) as f:
        raw = json.load(f)
    for step in raw["pipeline"]:
        kind = step["model"].rpartition(".")[2]
        if kind in ("R2P1DLoader", "R2P1DSingleStep"):
            step.update(LOADER)
        if kind in ("R2P1DRunner", "R2P1DSingleStep"):
            step.update(NETWORK)
        if kind == "R2P1DRunner":
            step.update(max_rows=3, consecutive_frames=FRAMES,
                        row_buckets=[2, 3] if name == "rnb" else [1, 3])
        if kind == "Batcher":
            step.update(max_rows=3, consecutive_frames=FRAMES)
            for group in step["queue_groups"]:
                if "batch" in group:
                    group.update(batch=2, row_buckets=[2, 3])
    if ragged:
        raw["ragged"] = {"enabled": True}
        raw["pipeline"][-1]["ragged_chunk_rows"] = 1
    path = str(tmp_path / (name + ".json"))
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


@pytest.fixture(scope="module")
def weights():
    """The JAX package's seeded init: what its stages load when no
    checkpoint is named."""
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


class _JaxStages:
    """The JAX package's stages, built once per topology and asked for
    one video's logits at a time."""

    def __init__(self):
        self._stages = {}
        self._logits = {}

    def _chain(self, pixel_path, ranges):
        key = (pixel_path, ranges)
        if key not in self._stages:
            device = jax.devices()[0]
            loader = jax_model.R2P1DLoader(
                device, num_warmups=0, pixel_path=pixel_path, **LOADER)
            runners = [jax_model.R2P1DRunner(
                device, start_index=s, end_index=e, num_classes=CLASSES,
                layer_sizes=LS, max_rows=3, consecutive_frames=FRAMES,
                num_warmups=0, row_buckets=[1, 3], pixel_path=pixel_path)
                for s, e in ranges]
            self._stages[key] = (loader, runners)
        return self._stages[key]

    def logits(self, video, pixel_path="rgb", ranges=((1, 5),)):
        key = (video, pixel_path, ranges)
        if key not in self._logits:
            loader, runners = self._chain(pixel_path, ranges)
            card = jax_telemetry.TimeCard(0)
            tensors, nt, card = loader(None, video, card)
            for runner in runners:
                tensors, nt, card = runner(tensors, nt, card)
            self._logits[key] = np.asarray(
                tensors[0].data)[:tensors[0].valid]
        return self._logits[key]


@pytest.fixture(scope="module")
def jax_stages():
    return _JaxStages()


def _assert_logits_close(got, want):
    # bf16 on both sides with the same rounding points; what differs is
    # the accumulation order inside the convs (XLA vs oneDNN), re-rounded
    # to bf16 at ~20 points: bound 2% of the logit scale, the bound of
    # tests/test_torch_slice.py, and the argmax must agree wherever the
    # top-2 margin exceeds twice that bound
    bound = 0.02 * float(np.abs(want).max())
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= bound
    for g, w in zip(got, want):
        top2 = np.sort(w)[-2:]
        if top2[1] - top2[0] > 2 * bound:
            assert g.argmax() == w.argmax()


def _run(name, tmp_path, monkeypatch):
    from rnb_tpu_torch.benchmark import run_benchmark
    monkeypatch.delenv("RNB_TPU_DATA_ROOT", raising=False)
    sink = {}
    result = run_benchmark(_reduced(name, tmp_path), mean_interval_ms=0,
                           num_videos=REQUESTS,
                           log_base=str(tmp_path / "logs"),
                           print_progress=False, seed=0, platform="cpu",
                           outputs_sink=sink)
    assert result.termination_flag == 0
    assert result.num_completed == REQUESTS and result.device == "cpu"
    assert sorted(sink) == list(range(REQUESTS))
    with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
        meta = f.read()
    return result, sink, meta


@pytest.mark.parametrize("name", ["whole", "whole-ragged", "whole-yuv",
                                  "split", "rnb"])
def test_pipeline_logits_match_the_jax_stages(name, tmp_path, monkeypatch,
                                              bridged_networks, jax_stages):
    result, sink, meta = _run(name, tmp_path, monkeypatch)
    pixel_path = "yuv420" if name == "whole-yuv" else "rgb"
    ranges = ((1, 4), (5, 5)) if name == "split" else ((1, 5),)
    clips = 0
    for rid, (video, logits, stamps) in sorted(sink.items()):
        assert video == "synth://kinetics/video-%04d" % rid
        want = jax_stages.logits(video, pixel_path, ranges)
        assert logits.shape == want.shape == (logits.shape[0], CLASSES)
        _assert_logits_close(logits, want)
        assert stamps == {"cache_hit": None, "cache_coalesced": False,
                          "feature_hit": False}
        clips += logits.shape[0]
    assert {v[1].shape[0] for v in sink.values()} == {1, 3}
    assert result.clips_completed == clips
    assert "Pixel path: %s\n" % pixel_path in meta
    assert "Decode backend: synth\n" in meta
    assert "Completed: requests=%d clips=%d\n" % (REQUESTS, clips) in meta
    assert ("Ragged: pool_rows=3 emissions=%d rows=%d "
            % (REQUESTS, clips) in meta) == (name == "whole-ragged")
    steps = {"split": 3, "rnb": 3}.get(name, 2)
    (table,) = [n for n in os.listdir(result.log_dir)
                if n.endswith("-0.txt")]
    keys, rows = read_table(os.path.join(result.log_dir, table))
    assert len(rows) == REQUESTS
    assert keys[0] == "enqueue_filename"
    assert keys[1:] == [k % s for s in range(steps) for k in (
        "runner%d_start", "inference%d_start", "inference%d_finish")]
    stats = summarize(result.log_dir)
    assert stats["requests"] == REQUESTS and stats["pixel_path"] == pixel_path
    assert stats["clips_per_s"] * stats["window_s"] == pytest.approx(clips)
    if name == "rnb":
        # small videos were fused two to a batch; large ones passed alone
        small = sum(v[1].shape[0] == 1 for v in sink.values())
        assert stats["emissions"] == -(-small // 2) + REQUESTS - small
        with open(os.path.join(result.log_dir, table)) as f:
            header, first = f.read().splitlines()[:2]
        assert header.split()[-3:] == ["device0", "device1", "device2"]
        assert first.split()[-3:] == ["cpu:0", "host", "cpu:0"]
        # the loader counts every clip once, the batchers again
        assert result.total_rows > clips
    else:
        assert stats["emissions"] == REQUESTS
        assert result.total_rows == clips and result.pad_rows == 0


def test_single_step_emits_the_class_ids_of_the_jax_logits(
        tmp_path, monkeypatch, bridged_networks, jax_stages):
    result, sink, meta = _run("nopipeline", tmp_path, monkeypatch)
    checked = 0
    for rid, (video, pred, _stamps) in sorted(sink.items()):
        assert isinstance(pred, int) and 0 <= pred < CLASSES
        want = jax_stages.logits(video).sum(axis=0)
        top2 = np.sort(want)[-2:]
        # the class id is the argmax over the summed clip logits; hold it
        # wherever the JAX margin exceeds the bf16 bound on that sum
        if top2[1] - top2[0] > 0.04 * float(np.abs(want).max()):
            assert pred == int(want.argmax())
            checked += 1
    assert checked >= REQUESTS // 2
    assert "Pixel path: rgb\n" in meta
    keys, rows = read_table(os.path.join(result.log_dir, "cpu0-group0-0.txt"))
    assert keys == ["enqueue_filename", "runner0_start", "inference0_start",
                    "inference0_finish"] and len(rows) == REQUESTS
    # the embedded loader and runner share the row buckets: no pad rows
    assert result.total_rows == result.clips_completed
    assert result.pad_rows == 0
    assert summarize(result.log_dir)["runner_wait_ms"] is None


# -- the executor's payload checks -------------------------------------

def test_validate_payload_on_feature_maps_pools_and_no_tensor():
    declared = port_model.R2P1DRunner.output_shape_for(
        start_index=1, end_index=4, max_rows=15)
    assert declared == ((15, 2, 14, 14, 256),)
    fmap = torch.zeros((1, 2, 14, 14, 256))
    validate_payload(declared, (PaddedBatch(fmap, 1),), "step 1")
    with pytest.raises(ValueError, match="trailing dims"):
        validate_payload(declared, (PaddedBatch(fmap[..., :128], 1),),
                         "step 1")
    with pytest.raises(ValueError, match="row axis"):
        validate_payload(((1, 2, 14, 14, 256),),
                         (PaddedBatch(torch.zeros((3, 2, 14, 14, 256)), 3),),
                         "step 1")
    pool = torch.zeros((15, 2, 14, 14, 256))
    validate_payload(declared, (RaggedBatch(pool, 4, (0, 1, 4)),), "step 1")
    with pytest.raises(ValueError, match="partition"):
        validate_payload(declared, (RaggedBatch(pool, 4, (0, 1, 3)),),
                         "step 1")
    # a stage that declares no tensor (the single step) must emit none
    assert port_model.R2P1DSingleStep.output_shape_for() is None
    validate_payload(None, None, "step 0")
    with pytest.raises(ValueError, match="declares no tensor"):
        validate_payload(None, (PaddedBatch(fmap, 1),), "step 0")


def test_outputs_sink_takes_rows_by_row0_and_a_class_id():
    cards = [TimeCard(i) for i in range(2)]
    for tc, (row0, n) in zip(cards, ((0, 1), (1, 2))):
        tc.row0, tc.num_clips, tc.video = row0, n, "v%d" % tc.id
    rows = torch.arange(4.0).reshape(4, 1)
    sink = {}
    _store_outputs(sink, (PaddedBatch(rows, 3),), None, TimeCardList(cards))
    assert sink[0][1].tolist() == [[0.0]]
    assert sink[1][1].tolist() == [[1.0], [2.0]]
    _store_outputs(sink, None, 7, cards[0])
    assert sink[0][:2] == ("v0", 7)


# -- the config reader -------------------------------------------------

@pytest.mark.parametrize("config,models,selectors", [
    ("r2p1d-whole", ["R2P1DLoader", "R2P1DRunner"], None),
    ("r2p1d-whole-yuv", ["R2P1DLoader", "R2P1DRunner"], None),
    ("r2p1d-split-1chip", ["R2P1DLoader", "R2P1DRunner", "R2P1DRunner"],
     None),
    ("rnb-1chip", ["R2P1DLoader", "Batcher", "R2P1DRunner"],
     "LargeSmallSelector"),
    ("r2p1d-nopipeline-1chip", ["R2P1DSingleStep"], None),
])
def test_unfused_configs_read_unchanged(config, models, selectors):
    cfg = load_config(os.path.join(REPO, "configs", config + ".json"),
                      platform="cpu")
    assert [s.model.rpartition(".")[2] for s in cfg.steps] == models
    assert all(s.model.startswith("rnb_tpu_torch.") for s in cfg.steps)
    first = cfg.steps[0].groups[0]
    assert first.queue_selector == (
        "rnb_tpu_torch.models.r2p1d.model.LargeSmallSelector" if selectors
        else "rnb_tpu_torch.selector.RoundRobinSelector")
    if config == "rnb-1chip":
        assert first.out_queues == [0, 1]
        batcher = cfg.steps[1]
        assert [g.devices[0].label for g in batcher.groups] == ["host"] * 2
        assert batcher.groups[0].devices[0].resolve() == torch.device("cpu")
        # a group's own model keys win over the step's
        assert batcher.kwargs_for_group(0) == {"batch": 6,
                                               "row_buckets": [6, 15]}
        assert batcher.kwargs_for_group(1) == {}
        assert cfg.num_runners == 4
    if config == "r2p1d-split-1chip":
        assert [(s.kwargs["start_index"], s.kwargs["end_index"])
                for s in cfg.steps[1:]] == [(1, 4), (5, 5)]
    if config == "r2p1d-whole":
        assert cfg.steps[0].kwargs["prefetch"] == 4
        assert cfg.steps[0].num_shared_tensors == 100


def _whole_raw():
    with open(os.path.join(REPO, "configs/r2p1d-whole.json")) as f:
        return json.load(f)


def test_rgb_is_a_pixel_path_of_every_stage():
    raw = _whole_raw()
    for step in raw["pipeline"]:
        step["pixel_path"] = "rgb"
    cfg = parse_config(raw, platform="cpu")
    assert [s.kwargs["pixel_path"] for s in cfg.steps] == ["rgb", "rgb"]
    with open(os.path.join(REPO, "configs/rnb-fused-yuv-big.json")) as f:
        fused = json.load(f)
    for step in fused["pipeline"]:
        step["pixel_path"] = "rgb"
    assert parse_config(fused, platform="cpu").steps[0].kwargs[
        "pixel_path"] == "rgb"


@pytest.mark.parametrize("where,key,value", [
    ("loader", "raw_output", True),
    ("loader", "staging_slots", 4),
    ("loader", "transfer_async", True),
    ("runner", "ckpt_path", "r2p1d.npz"),
    ("runner", "async_dispatch", True),
    ("group", "replicas", 2),
    ("group", "queue_selector", "rnb_tpu.selector.ReplicaSelector"),
])
def test_keys_of_unported_parts_stay_refused(where, key, value):
    raw = _whole_raw()
    target = {"root": raw, "loader": raw["pipeline"][0],
              "runner": raw["pipeline"][1],
              "group": raw["pipeline"][0]["queue_groups"][0]}[where]
    target[key] = value
    if (where, key) == ("group", "queue_selector"):
        # ported with the replica lanes: on an ordinary edge it reads, as
        # in the reference (and routes round-robin there)
        assert parse_config(raw, platform="cpu").steps[0].groups[
            0].queue_selector == "rnb_tpu_torch.selector.ReplicaSelector"
        return
    if (where, key) == ("loader", "raw_output"):
        # ported with the mesh stage: the loader reads it
        assert parse_config(raw, platform="cpu").steps[0].kwargs[
            "raw_output"] is True
        return
    if (where, key) == ("runner", "ckpt_path"):
        # ported with the checkpoint store: the runner reads it
        assert parse_config(raw, platform="cpu").steps[1].kwargs[
            "ckpt_path"] == "r2p1d.npz"
        return
    if key in ("staging_slots", "transfer_async", "async_dispatch"):
        # ported with the loader and launch keys: the plain loader reads
        # its staging slots; transfer_async reads too, and the stage
        # refuses it with the reference's message; async_dispatch is a
        # step key
        config = parse_config(raw, platform="cpu")
        if key == "async_dispatch":
            assert config.steps[1].async_dispatch is True
            assert key not in config.steps[1].kwargs
            return
        assert config.steps[0].kwargs[key] == value
        if key == "transfer_async":
            with pytest.raises(ValueError, match="transfer_async requires "
                               "a stage that emits asynchronously"):
                port_model.R2P1DLoader(None, transfer_async=True)
        return
    with pytest.raises(ConfigError, match="not yet ported"):
        parse_config(raw, platform="cpu")


@pytest.mark.parametrize("where,value", [
    ("root", 3),       # unknown to both readers
    ("loader", 3),     # the loader's 'row_buckets' refuses segments
    ("runner", 3),     # the last step may have none
    ("loader", 2.5),   # not a positive integer
])
def test_num_segments_refused_with_the_reference_message(where, value):
    from rnb_tpu import config as jax_config
    raw = _whole_raw()
    target = {"root": raw, "loader": raw["pipeline"][0],
              "runner": raw["pipeline"][1]}[where]
    target["num_segments"] = value
    with pytest.raises(jax_config.ConfigError) as jax_error:
        jax_config.parse_config(json.loads(json.dumps(raw)))
    with pytest.raises(ConfigError) as port_error:
        parse_config(raw, platform="cpu")
    if where == "root":
        # a step key on the root: both readers refuse it as a key they
        # do not read there
        assert "unknown root key(s) ['num_segments']" in str(
            jax_error.value)
        assert str(port_error.value) == ("root key 'num_segments' is not "
                                         "yet ported to rnb_tpu_torch")
    else:
        assert str(port_error.value) == str(jax_error.value)


@pytest.mark.parametrize("key,value", [("enable_autotune", True),
                                       ("autotune", False),
                                       ("take_shed", True),
                                       ("deadline_ms", 50)])
def test_batcher_autotune_and_shedding_keys_stay_refused(key, value):
    with open(os.path.join(REPO, "configs/rnb-1chip.json")) as f:
        raw = json.load(f)
    raw["pipeline"][1][key] = value
    if key == "autotune":
        # a step's opt-out of the root controller is read, as the
        # reference reads it; on a queue group it is no key of the
        # reference's and stays refused below
        config = parse_config(raw, platform="cpu")
        assert config.steps[1].autotune is False
        assert key not in config.steps[1].kwargs
    else:
        with pytest.raises(ConfigError, match="not yet ported"):
            parse_config(raw, platform="cpu")
    raw["pipeline"][1].pop(key)
    raw["pipeline"][1]["queue_groups"][0][key] = value
    with pytest.raises(ConfigError, match="not yet ported"):
        parse_config(raw, platform="cpu")


def test_queue_wiring_is_checked():
    raw = _whole_raw()
    raw["pipeline"][1]["queue_groups"][0]["in_queue"] = 3
    with pytest.raises(ConfigError, match="do not match"):
        parse_config(raw, platform="cpu")
    raw = _whole_raw()
    raw["pipeline"][1]["queue_groups"][0]["out_queues"] = [1]
    with pytest.raises(ConfigError, match="last step"):
        parse_config(raw, platform="cpu")
