"""The clip-sharded mesh stage in the port (``rnb_tpu_torch.parallel``,
``R2P1DMeshRunner``, the loader's ``raw_output``) held to the JAX
package's, on the CPU.

JAX runs its ``shard_map`` step on the 8 virtual CPU devices of
``tests/conftest.py`` (its jnp paths); the port's mesh members all lie on
the CPU, where its ingest wrappers run their plain versions. Inputs come
from numpy seeds, and the JAX package's seeded init is carried into the
port with ``from_jax_variables``. Size: the reference's ``TINY`` of
``tests/test_mesh_stage.py`` (2 clips of 2 frames, layer sizes (1, 1, 1,
1), 8 classes) at the published 112 x 112. What is held:

* a mesh over two distinct devices raises; members may repeat one;
* ``distributed``: single-process mode, a partial environment refused
  with the reference's message, a multi-process launch refused as not
  yet ported, by ``run_benchmark`` too;
* the sharded step: per-video logits within the JAX package's own
  sharded bound in bf16 (rtol = atol = 2e-2, ``tests/test_parallel.py``)
  with equal argmax, and within 5e-4 in float32 (the network's bound),
  for rgb and yuv420 over divisible and padded clip axes; masked clips
  change nothing;
* the stage: ``tests/test_mesh_stage.py``'s cases, the loader's
  ``raw_output`` and its refusals, the pipeline's edge shapes and dtypes,
  ``compute_profile``, the handoff target, the drain's accounting,
  ``--check`` and the config reader; end to end, rgb and yuv420
  pipelines on ``run_benchmark`` with every request's class the JAX
  stages' (an odd count completed by ``flush``, ``finalize`` called
  before the finish barrier), and a drain that fails failing the run.
"""

import json
import os
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from rnb_tpu import config as jax_config
from rnb_tpu import telemetry as jax_telemetry
from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.models.r2p1d import model as jax_model
from rnb_tpu.models.r2p1d.flops import range_flops_per_clip as jax_flops
from rnb_tpu.parallel import distributed as jax_distributed
from rnb_tpu.parallel.sharded import ShardedInference as JaxSharded
from rnb_tpu.stage import PaddedBatch as JaxPadded
from rnb_tpu_torch import handoff
from rnb_tpu_torch.config import ConfigError, load_config, parse_config
from rnb_tpu_torch.control import TerminationFlag
from rnb_tpu_torch.devices import DeviceSpec
from rnb_tpu_torch.models.r2p1d import model as port_model
from rnb_tpu_torch.models.r2p1d.checkpoint import (filter_layer_range,
                                                   from_jax_variables)
from rnb_tpu_torch.models.r2p1d.network import (R2Plus1DClassifier,
                                                cast_compute_weights)
from rnb_tpu_torch.parallel import distributed, mesh
from rnb_tpu_torch.parallel.sharded import ShardedInference
from rnb_tpu_torch.parse_utils import summarize
from rnb_tpu_torch.runner import _store_outputs, finish_outputs
from rnb_tpu_torch.stage import PaddedBatch
from rnb_tpu_torch.telemetry import TimeCard, TimeCardList
from torch_job_checks import assert_both_checks_pass

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_CONFIGS = {"rgb": os.path.join(REPO, "configs", "r2p1d-mesh.json"),
                "yuv420": os.path.join(REPO, "configs",
                                       "r2p1d-mesh-yuv.json")}
LS = (1, 1, 1, 1)
CLASSES = 8
TINY = dict(max_clips=2, consecutive_frames=2, num_classes=CLASSES,
            layer_sizes=list(LS), num_warmups=1)
CPU = torch.device("cpu")
#: the JAX package's sharded bound (tests/test_parallel.py) in bf16, the
#: network's in float32 (tests/test_torch_network.py)
BF16_TOL = 2e-2
F32_TOL = 5e-4


@pytest.fixture(scope="module")
def weights():
    """The JAX package's seeded init: what its mesh stage loads."""
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


def _cpu(n):
    return [CPU] * n


# -- the mesh --------------------------------------------------------------

def test_a_mesh_over_two_distinct_devices_raises_not_yet_ported():
    with pytest.raises(NotImplementedError,
                       match=r"a mesh over 2 distinct devices \(cuda:0, "
                             r"cuda:1\) is not yet ported.*NCCL.*ROADMAP"):
        mesh.Mesh([[torch.device("cuda", 0)], [torch.device("cuda", 1)]],
                  ("dp", "sp"))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        port_model.R2P1DMeshRunner(
            CPU, [DeviceSpec(0, "cpu"), torch.device("cuda", 1)], **TINY)
    # members may repeat one device, which a jax Mesh cannot
    one = mesh.Mesh(np.array([[CPU] * 4] * 2, dtype=object), ("dp", "sp"))
    assert one.device == CPU and one.shape == {"dp": 2, "sp": 4}
    with pytest.raises(ValueError, match="cannot carry axes"):
        mesh.Mesh(np.array([CPU] * 4, dtype=object), ("dp", "sp"))


# -- distributed -------------------------------------------------------

def _environment(monkeypatch, env):
    for key in distributed.ENV:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)


def test_single_process_mode(monkeypatch):
    _environment(monkeypatch, {"RNB_TPU_NUM_PROCESSES": "0"})
    assert distributed.maybe_initialize() is False
    assert jax_distributed.maybe_initialize() is False


@pytest.mark.parametrize("env", [{"RNB_TPU_NUM_PROCESSES": "2"},
                                 {"RNB_TPU_PROCESS_ID": "1"},
                                 {"RNB_TPU_NUM_PROCESSES": "2",
                                  "RNB_TPU_PROCESS_ID": "0"}])
def test_a_partial_environment_is_refused_as_the_reference(env,
                                                           monkeypatch):
    _environment(monkeypatch, env)
    with pytest.raises(RuntimeError) as theirs:
        jax_distributed.maybe_initialize()
    with pytest.raises(RuntimeError) as ours:
        distributed.maybe_initialize()
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("env", [
    {"RNB_TPU_COORDINATOR": "127.0.0.1:1"},
    {"RNB_TPU_COORDINATOR": "127.0.0.1:1", "RNB_TPU_NUM_PROCESSES": "2",
     "RNB_TPU_PROCESS_ID": "1"}])
def test_a_multi_process_launch_is_refused_as_not_yet_ported(env,
                                                             monkeypatch):
    _environment(monkeypatch, env)
    with pytest.raises(NotImplementedError,
                       match=r"multi-process run \(RNB_TPU_COORDINATOR="
                             r"127.0.0.1:1\) is not yet ported.*NCCL"):
        distributed.maybe_initialize()


def test_run_benchmark_refuses_a_multi_process_launch(monkeypatch,
                                                      tmp_path):
    from rnb_tpu_torch.benchmark import run_benchmark
    _environment(monkeypatch, {"RNB_TPU_COORDINATOR": "127.0.0.1:1",
                               "RNB_TPU_NUM_PROCESSES": "2",
                               "RNB_TPU_PROCESS_ID": "0"})
    with pytest.raises(NotImplementedError, match="not yet ported"):
        run_benchmark(MESH_CONFIGS["rgb"], mean_interval_ms=0, num_videos=1,
                      log_base=str(tmp_path / "logs"), print_progress=False,
                      platform="cpu")
    assert not (tmp_path / "logs").exists()


# -- the sharded step ------------------------------------------------------

TINY_SI = dict(max_clips=TINY["max_clips"],
               consecutive_frames=TINY["consecutive_frames"],
               num_classes=CLASSES)


def _network(weights, dtype):
    """The port's [1..5] network on the JAX package's weights."""
    net = R2Plus1DClassifier(1, 5, CLASSES, LS, dtype=dtype)
    net.load_state_dict(from_jax_variables(weights), strict=True)
    return cast_compute_weights(net).eval()


def _mesh(dp, sp):
    return mesh.Mesh(np.array(_cpu(dp * sp), dtype=object).reshape(dp, sp),
                     ("dp", "sp"))


def _sharded_pair(weights, dp, sp, pixel_path, dtype):
    jax_mesh_ = JaxMesh(np.array(jax.devices()[:dp * sp]).reshape(dp, sp),
                        ("dp", "sp"))
    theirs = JaxSharded(jax_mesh_, variables=weights, pixel_path=pixel_path,
                        dtype=jnp.float32 if dtype == torch.float32
                        else jnp.bfloat16, layer_sizes=LS, **TINY_SI)
    ours = ShardedInference(_mesh(dp, sp), network=_network(weights, dtype),
                            pixel_path=pixel_path, **TINY_SI)
    return theirs, ours


def _videos(si, n, seed):
    rng = np.random.default_rng(seed)
    videos = rng.integers(0, 256, si.batch_shape(n), dtype=np.uint8)
    valid = [int(v) for v in rng.integers(1, si.max_clips + 1, n)]
    return videos, valid


@torch.inference_mode()
def _step(si, videos, valid):
    return si.step(torch.from_numpy(videos), si.place_mask(valid))


MESHES = [(2, 2), (1, 3), (4, 2), (2, 1)]


@pytest.mark.parametrize("dp,sp", MESHES, ids=["dp%d-sp%d" % m
                                                 for m in MESHES])
@pytest.mark.parametrize("pixel_path", ["rgb", "yuv420"])
def test_the_sharded_step_matches_the_reference_in_bf16(weights, pixel_path,
                                                        dp, sp):
    theirs, ours = _sharded_pair(weights, dp, sp, pixel_path,
                                 torch.bfloat16)
    assert ours.padded_clips == theirs.padded_clips
    assert ours.batch_shape(dp) == theirs.batch_shape(dp)
    videos, valid = _videos(ours, 2 * dp, seed=10 * dp + sp)
    want = np.asarray(theirs.run(*theirs.place(videos, valid)))
    got = _step(ours, videos, valid).numpy()
    assert got.shape == want.shape == (2 * dp, CLASSES)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("dp,sp", MESHES, ids=["dp%d-sp%d" % m
                                                 for m in MESHES])
@pytest.mark.parametrize("pixel_path", ["rgb", "yuv420"])
def test_the_sharded_step_matches_the_reference_in_float32(
        weights, pixel_path, dp, sp):
    theirs, ours = _sharded_pair(weights, dp, sp, pixel_path, torch.float32)
    videos, valid = _videos(ours, dp, seed=7 + dp + sp)
    want = np.asarray(theirs.run(*theirs.place(videos, valid)))
    got = _step(ours, videos, valid).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("pixel_path", ["rgb", "yuv420"])
def test_scribbling_on_masked_clips_changes_nothing(weights, pixel_path):
    _, ours = _sharded_pair(weights, 1, 3, pixel_path, torch.bfloat16)
    videos, _ = _videos(ours, 2, seed=3)
    valid = [1, 2]
    got = _step(ours, videos, valid)
    scribbled = videos.copy()
    scribbled[0, 1:] = 255
    again = _step(ours, scribbled, valid)
    assert torch.equal(got, again)
    # the mask decides: all rows valid moves the first video's logits
    assert not torch.equal(_step(ours, scribbled, [2, 2])[0], got[0])


def test_the_sharded_step_refuses_what_the_reference_refuses(weights):
    net = _network(weights, torch.bfloat16)
    with pytest.raises(ValueError, match=r"lacks axis 'dp'/'sp'"):
        ShardedInference(mesh.Mesh([[CPU] * 2] * 2, ("dp", "cp")),
                         network=net, **TINY_SI)
    with pytest.raises(ValueError, match="pixel_path must be 'rgb' or "
                                         "'yuv420', got 'dct'"):
        ShardedInference(_mesh(2, 2), network=net, pixel_path="dct",
                         **TINY_SI)
    ours = ShardedInference(_mesh(2, 2), network=net, **TINY_SI)
    videos, valid = _videos(ours, 3, seed=1)
    with pytest.raises(ValueError, match="multiple of the mesh's dp size"):
        _step(ours, videos, valid)


# -- the loader's raw_output ---------------------------------------------

@pytest.mark.parametrize("kwargs", [
    dict(pixel_path="dct"), dict(ragged=True),
    dict(row_buckets=[1, 2])])
def test_raw_output_refusals_carry_the_reference_s_messages(kwargs):
    loader_kwargs = dict(max_clips=2, consecutive_frames=2, num_warmups=0,
                         raw_output=True, **kwargs)
    with pytest.raises(ValueError) as theirs:
        jax_model.R2P1DLoader(jax.devices()[0], **loader_kwargs)
    with pytest.raises(ValueError) as ours:
        port_model.R2P1DLoader(CPU, **loader_kwargs)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("pixel_path", ["rgb", "yuv420"])
def test_raw_output_ships_the_reference_s_wire_rows(pixel_path):
    loader_kwargs = dict(max_clips=2, consecutive_frames=2, num_warmups=0,
                         raw_output=True, pixel_path=pixel_path,
                         num_clips_population=[1, 2], weights=[1, 1])
    theirs = jax_model.R2P1DLoader(jax.devices()[0], **loader_kwargs)
    ours = port_model.R2P1DLoader(CPU, **loader_kwargs)
    assert ours.compiles is None and ours.raw_output
    for i in range(4):
        video = "synth://kinetics/video-%04d" % i
        (want,), _, _ = theirs(None, video, jax_telemetry.TimeCard(i))
        (got,), _, card = ours(None, video, TimeCard(i))
        assert got.data.dtype == torch.uint8 and got.valid == want.valid
        assert np.array_equal(got.data.numpy(), np.asarray(want.data))
        assert card.num_clips == want.valid


@pytest.mark.parametrize("kwargs", [
    dict(), dict(raw_output=True), dict(pixel_path="yuv420"),
    dict(pixel_path="yuv420", raw_output=True), dict(pixel_path="dct")])
def test_the_edge_of_both_mesh_configs_matches(kwargs):
    """The loader's declared output against the mesh stage's input, as the
    reference declares them: the pipeline check of the two configs."""
    assert port_model.R2P1DLoader.output_dtype_for(**kwargs) == \
        jax_model.R2P1DLoader.output_dtype_for(**kwargs)
    if kwargs.get("pixel_path") == "dct":
        return
    assert port_model.R2P1DMeshRunner.input_shape_for(**kwargs) == \
        jax_model.R2P1DMeshRunner.input_shape_for(**kwargs)
    assert port_model.R2P1DMeshRunner.input_dtype_for(**kwargs) == \
        jax_model.R2P1DMeshRunner.input_dtype_for(**kwargs) == "uint8"


@pytest.mark.parametrize("pixel_path", sorted(MESH_CONFIGS))
def test_the_shipped_mesh_configs_read_and_connect(pixel_path):
    path = MESH_CONFIGS[pixel_path]
    cfg = load_config(path, platform="cpu")
    with open(path) as f:
        jax_cfg = jax_config.parse_config(json.load(f))
    assert [s.model.rpartition(".")[2] for s in cfg.steps] == [
        s.model.rpartition(".")[2] for s in jax_cfg.steps] == [
        "R2P1DLoader", "R2P1DMeshRunner"]
    loader, stage = (s.kwargs for s in cfg.steps)
    assert loader["raw_output"] is True
    assert [d.spec for d in stage["mesh_devices"]] == list(range(8))
    assert all(d.resolve() == CPU for d in stage["mesh_devices"])
    assert (stage["dp"], stage["sync_preds"]) == (2, False)
    assert stage.get("pixel_path", "rgb") == loader.get("pixel_path",
                                                        "rgb")
    out_shape = port_model.R2P1DLoader.output_shape_for(**loader)
    out_dtype = port_model.R2P1DLoader.output_dtype_for(**loader)
    assert out_shape == port_model.R2P1DMeshRunner.input_shape_for(**stage)
    assert out_dtype == port_model.R2P1DMeshRunner.input_dtype_for(**stage)


@pytest.mark.parametrize("value", [[], [0, "1"], [0, -1], 3, [True]])
def test_bad_mesh_devices_are_refused(value):
    with open(MESH_CONFIGS["rgb"]) as f:
        raw = json.load(f)
    raw["pipeline"][1]["mesh_devices"] = value
    with pytest.raises(ConfigError, match="'mesh_devices' must be a "
                                          "non-empty list"):
        parse_config(raw, platform="cpu")


# -- the stage -----------------------------------------------------------

def _jax_mesh_stage(n, **kwargs):
    return jax_model.R2P1DMeshRunner(device=jax.devices()[0],
                                     mesh_devices=list(range(n)),
                                     **TINY, **kwargs)


def _port_mesh_stage(n, **kwargs):
    return port_model.R2P1DMeshRunner(
        CPU, [DeviceSpec(i, "cpu") for i in range(n)], **TINY, **kwargs)


@pytest.mark.parametrize("n", [2, 3], ids=["divisible", "padded"])
def test_the_stage_matches_a_single_device_forward(n, weights,
                                                   bridged_networks):
    """``tests/test_mesh_stage.py``'s cases: the mesh's class id is the
    argmax of a plain forward's summed clip logits, and the reference's;
    over 3 members the 2-clip axis is padded to 3."""
    ours = _port_mesh_stage(n)
    theirs = _jax_mesh_stage(n)
    assert ours._si.padded_clips == theirs._si.padded_clips == (
        2 if n == 2 else 3)
    net = port_model.shared_network(1, 5, CLASSES, LS, CPU)
    rng = np.random.default_rng(n)
    clips = rng.integers(0, 256, (2, 2, 112, 112, 3), dtype=np.uint8)
    for valid in (1, 2):
        _, pred, card = ours((PaddedBatch(torch.from_numpy(clips), valid),),
                             None, TimeCard(valid))
        assert card.id == valid and pred.shape == (1,)
        with torch.inference_mode():
            plain = net(port_model.normalize_u8(
                torch.from_numpy(clips[:valid]))).sum(dim=0)
        _, their_pred, _ = theirs((JaxPadded(jnp.asarray(clips), valid),),
                                  None, jax_telemetry.TimeCard(valid))
        assert int(pred[0]) == int(plain.argmax()) == int(
            np.asarray(their_pred)[0])


def test_the_stage_refuses_a_pixel_path_mismatch(bridged_networks):
    ours = _port_mesh_stage(2, pixel_path="yuv420")
    rgb = torch.zeros((2, 2, 112, 112, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="pixel_path"):
        ours((PaddedBatch(rgb, 1),), None, TimeCard(0))
    with pytest.raises(ValueError, match=r"dp=3 must divide "
                                         r"len\(mesh_devices\)=4"):
        _port_mesh_stage(4, dp=3)
    with pytest.raises(ValueError, match="the mesh's members lie on meta"):
        port_model.R2P1DMeshRunner(CPU, ["meta", "meta"], **TINY)


def test_the_stage_fuses_dp_videos_and_flushes_a_partial_batch(
        bridged_networks):
    ours = _port_mesh_stage(4, dp=2, sync_preds=False, max_inflight=1)
    singles = _port_mesh_stage(2)
    rng = np.random.default_rng(5)
    clips = [torch.from_numpy(rng.integers(0, 256, (2, 2, 112, 112, 3),
                                           dtype=np.uint8))
             for _ in range(3)]
    want = [int(singles((PaddedBatch(c, 1 + i % 2),), None,
                        TimeCard(i))[1][0]) for i, c in enumerate(clips)]
    assert ours((PaddedBatch(clips[0], 1),), None, TimeCard(0)) == (
        None, None, None)
    _, preds, cards = ours((PaddedBatch(clips[1], 2),), None, TimeCard(1))
    assert isinstance(cards, TimeCardList) and len(cards) == 2
    assert preds.tolist() == want[:2]
    ours((PaddedBatch(clips[2], 1),), None, TimeCard(2))
    _, preds, card = ours.flush()
    # the dp axis padded with a zero video: its prediction rides along
    assert isinstance(card, TimeCard) and card.id == 2
    assert preds.shape == (2,) and int(preds[0]) == want[2]
    assert ours.flush() is None
    ours.finalize()
    assert not ours._inflight
    assert ours.compiles.snapshot()["warmup"] == 1


class _Event:
    """A dispatch's completion event, finished or not."""

    def __init__(self, done):
        self.done, self.waited = done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True


def test_the_drain_waits_for_the_unretired_dispatches_only(
        bridged_networks):
    ours = _port_mesh_stage(2)
    events = [_Event(True), _Event(False), _Event(False)]
    ours._inflight = deque(events)
    ours.finalize()
    assert ours.drained == 2 and not ours._inflight
    assert [e.waited for e in events] == [False, True, True]


def test_a_final_step_stores_each_card_s_class_id():
    cards = [TimeCard(i) for i in range(2)]
    for tc in cards:
        tc.video = "v%d" % tc.id
    sink = {}
    _store_outputs(sink, None, torch.tensor([5, 3]), TimeCardList(cards))
    _store_outputs(sink, None, torch.tensor([6, 0]), TimeCard(7))
    # the ids reach the host after the run, as Python ints
    finish_outputs(sink)
    assert {rid: v[1] for rid, v in sink.items()} == {0: 5, 1: 3, 7: 6}
    assert all(type(v[1]) is int for v in sink.values())


def test_compute_profile_counts_the_distinct_devices(bridged_networks):
    ours = _port_mesh_stage(4, dp=2)
    profile = ours.compute_profile()
    assert profile["devices"] == 1  # the reference counts 4 members
    assert profile["flops_per_row"] == int(jax_flops(
        1, 5, consecutive_frames=2, num_classes=CLASSES, layer_sizes=LS))
    assert profile["params_bytes"] > 0 and profile["pool_bytes"] == 0
    assert profile["params_key"] == ("params", id(ours._si.network))


def test_the_handoff_targets_the_mesh_s_device(bridged_networks):
    ours = _port_mesh_stage(2)
    assert ours.input_sharding() == CPU
    assert port_model.StageModel(CPU).input_sharding() is None
    edge = handoff.EdgeHandoff(handoff.HandoffSettings("device"),
                               DeviceSpec(0, "cpu"), "step0->step1",
                               model=ours)
    pb = PaddedBatch(torch.zeros((2, 2, 112, 112, 3), dtype=torch.uint8),
                     1)
    (taken,) = edge.take((pb,))
    assert taken is pb
    assert edge.snapshot()["d2d_edges"] == 1
    assert edge.snapshot()["d2d_bytes"] == 0


# -- end to end -----------------------------------------------------------

def _reduced(pixel_path, tmp_path, dp):
    """A shipped mesh config cut to a CPU-sized pipeline, on one device:
    4 members, dp as given."""
    with open(MESH_CONFIGS[pixel_path]) as f:
        raw = json.load(f)
    loader, stage = raw["pipeline"]
    loader.update(max_clips=2, consecutive_frames=2, num_warmups=1,
                  num_clips_population=[1, 2], weights=[3, 1],
                  num_shared_tensors=8)
    stage.update(mesh_devices=[0, 0, 0, 0], dp=dp, **TINY)
    for step in raw["pipeline"]:
        for group in step["queue_groups"]:
            group["devices"] = [0]
    path = str(tmp_path / ("mesh-%s.json" % pixel_path))
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


@pytest.mark.parametrize("pixel_path,dp,requests", [
    ("rgb", 2, 7), ("yuv420", 2, 6), ("rgb", 1, 5)])
def test_the_pipeline_serves_the_jax_stages_classes(
        pixel_path, dp, requests, tmp_path, monkeypatch, bridged_networks):
    from rnb_tpu_torch.benchmark import run_benchmark
    monkeypatch.delenv("RNB_TPU_DATA_ROOT", raising=False)
    finalized = []
    finalize = port_model.R2P1DMeshRunner.finalize

    def spy(self):
        finalized.append(len(self._inflight))
        finalize(self)

    monkeypatch.setattr(port_model.R2P1DMeshRunner, "finalize", spy)
    sink = {}
    result = run_benchmark(_reduced(pixel_path, tmp_path, dp),
                           mean_interval_ms=0, num_videos=requests,
                           log_base=str(tmp_path / "logs"),
                           print_progress=False, seed=0, platform="cpu",
                           outputs_sink=sink)
    assert result.termination_flag == \
        TerminationFlag.TARGET_NUM_VIDEOS_REACHED
    assert result.num_completed == requests == len(sink)
    assert finalized == [0]
    loader = jax_model.R2P1DLoader(
        jax.devices()[0], max_clips=2, consecutive_frames=2, num_warmups=0,
        raw_output=True, pixel_path=pixel_path,
        num_clips_population=[1, 2], weights=[3, 1])
    stage = _jax_mesh_stage(4, pixel_path=pixel_path)
    for rid, (video, pred, _stamps) in sorted(sink.items()):
        assert video == "synth://kinetics/video-%04d" % rid
        tensors, _, card = loader(None, video, jax_telemetry.TimeCard(rid))
        _, want, _ = stage(tensors, None, card)
        assert isinstance(pred, int) and pred == int(np.asarray(want)[0])
    with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
        meta = f.read()
    assert "Pixel path: %s\n" % pixel_path in meta
    assert "Decode backend: synth\n" in meta
    compiles = json.loads(meta.split("Compiles: ", 1)[1].splitlines()[0])
    # one dispatch a dp videos, a flushed partial batch among them
    assert compiles["step1"] == {"warmup": 1, "steady_new": 0,
                                 "steady_calls": -(-requests // dp)}
    stats = summarize(result.log_dir)
    assert stats["requests"] == requests and stats["pixel_path"] == pixel_path
    assert stats["footing_problems"] == []
    assert_both_checks_pass(result.log_dir)


def test_a_drain_that_fails_fails_the_run(tmp_path, monkeypatch,
                                          bridged_networks):
    from rnb_tpu_torch.benchmark import run_benchmark
    monkeypatch.delenv("RNB_TPU_DATA_ROOT", raising=False)

    def fault(self):
        raise RuntimeError("a device fault while draining")

    monkeypatch.setattr(port_model.R2P1DMeshRunner, "finalize", fault)
    result = run_benchmark(_reduced("rgb", tmp_path, 2), mean_interval_ms=0,
                           num_videos=3, log_base=str(tmp_path / "logs"),
                           print_progress=False, seed=0, platform="cpu")
    assert result.termination_flag == TerminationFlag.INTERNAL_ERROR
