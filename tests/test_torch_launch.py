"""A served launch of several processes, held to the JAX package on the
CPU.

Launches of two processes (``rnb_tpu_torch.tools.launch``: each its own
interpreter, the three ``RNB_TPU_*`` variables set, a free port of the
loopback) run ``tests/torch_launch_children.py`` over a gloo group: each
process serves the whole config with ``run_benchmark(platform="cpu")``,
as the reference's processes do, and its mesh stage's members span the
processes. The configs are launch copies (``tools.launch.launch_copy``)
of the shipped mesh configs at ``tests/test_mesh_stage.py``'s TINY (2
clips of 2 frames, layer sizes (1, 1, 1, 1), 8 classes, 112 x 112): the
loader on the host (-1) with ``raw_output``, the mesh stage homed on
member 0 over members [0, 1], rgb at dp 1 (so sp 2: every dispatch
gathers over the ring of the two processes) and yuv420 at dp 2 (each
process its own video row, no collective), ``sync_preds`` false as
shipped, the weights the JAX package's seeded init carried with
``from_jax_variables`` into a checkpoint file (``ckpt_path``).

The reference is the JAX package's one-process served run of the same
copy over 2 of ``tests/conftest.py``'s virtual devices: its
``run_benchmark`` serves the layout, and its stages give every request's
class id (its loader, then its mesh stage in the port's dispatch order)
and, in float32, every dispatch's logits (its ``ShardedInference``).
What is held: class ids equal; float32 logits within 5e-4 (the
network's bound) and bf16 logits within the sharded bound of
``tests/test_torch_mesh.py`` with equal argmax; an odd request count
completed by ``flush``; completions equal in both processes; each
process's job directory (``-p<index>``) clean under both packages'
``check_job``; a stage on the other process's member refused, naming
it; a config without a mesh stage served by the CLI in both processes;
a stream that diverges in one process (a dead letter through that
process's ``RNB_FAULT_PLAN``) ending both runs with the ring's error
within a shortened cap; the served stage's host waits (``peers.
host_waits``) at its ``finalize`` only, and with ``sync_preds`` one a
dispatch. Every launch has a timeout that kills its processes.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import torch_launch_children  # noqa: F401  (the children's module)
from rnb_tpu import telemetry as jax_telemetry
from rnb_tpu.benchmark import run_benchmark as jax_run_benchmark
from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.models.r2p1d import model as jax_model
from rnb_tpu.parallel.sharded import ShardedInference as JaxSharded
from rnb_tpu.stage import PaddedBatch as JaxPadded
from rnb_tpu_torch.config import ConfigError, load_config, parse_config
from rnb_tpu_torch.control import TerminationFlag
from rnb_tpu_torch.devices import DeviceResolutionError, DeviceSpec
from rnb_tpu_torch.models.r2p1d.checkpoint import (from_jax_variables,
                                                   save_checkpoint)
from rnb_tpu_torch.parallel import distributed, mesh
from rnb_tpu_torch.parallel.sharded import ShardedInference
from rnb_tpu_torch.runner import finish_outputs
from rnb_tpu_torch.stage import ANOTHER_PROCESS
from rnb_tpu_torch.tools import launch as launch_tool
from torch_job_checks import assert_both_checks_pass

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SHIPPED = {"rgb": "r2p1d-mesh", "yuv420": "r2p1d-mesh-yuv"}
#: the launch copies' dp: rgb gathers over the ring, yuv420 does not
DP = {"rgb": 1, "yuv420": 2}
PROCESSES = 2
LS = (1, 1, 1, 1)
CLASSES = 8
TINY = dict(max_clips=2, consecutive_frames=2, num_classes=CLASSES,
            layer_sizes=list(LS), num_warmups=1)
SAMPLER = dict(max_clips=2, consecutive_frames=2,
               num_clips_population=[1, 2], weights=[3, 1])
#: an odd count: the yuv420 copy's last dispatch is padded by flush
REQUESTS = 5
SEED = 0
BF16_TOL = 2e-2
F32_TOL = 5e-4
#: seconds a launch may take before its processes are killed
LAUNCH_TIMEOUT_S = 240.0
#: the ring's wait cap in the diverging launches, and the seconds a
#: diverged run may take at most past it
CAP_S = 3.0
SLACK_S = 20.0
#: process 1 dead-letters request 2 at its loader
DEAD_LETTER = {"faults": [{"step": 0, "kind": "permanent",
                           "request_ids": [2]}]}


def _shipped(name):
    with open(os.path.join(REPO, "configs", name + ".json")) as f:
        return json.load(f)


def _copy(pixel_path, ckpt_path=None, **stage_keys):
    """The TINY launch copy of a shipped mesh config, as a dict."""
    raw = launch_tool.launch_copy(_shipped(SHIPPED[pixel_path]), PROCESSES,
                                  DP[pixel_path])
    loader, stage = raw["pipeline"]
    loader.update(SAMPLER, num_warmups=1, num_shared_tensors=8)
    stage.update(TINY, **stage_keys)
    if ckpt_path is not None:
        stage["ckpt_path"] = ckpt_path
    return raw


def _write(raw, path):
    with open(path, "w") as f:
        json.dump(raw, f)
    return str(path)


def _env():
    env = dict(os.environ, PYTHONPATH=HERE)
    for key in distributed.ENV + ("RNB_TPU_DATA_ROOT", "RNB_FAULT_PLAN"):
        env.pop(key, None)
    return env


def _launch(out, case, **args):
    """Run ``case`` of the children as a launch of two processes; every
    process must exit 0 in time. Returns each process's saved results
    and how each ended."""
    args["out"] = str(out)
    ended = launch_tool.launch(
        PROCESSES, [sys.executable, "-m", "torch_launch_children", case,
                    str(out), json.dumps(args)],
        LAUNCH_TIMEOUT_S, env=_env(), cwd=HERE)
    results = []
    for e in ended:
        assert e.returncode == 0, "process %d of %s: %s\n%s" % (
            e.index, case, "killed at the timeout" if e.returncode is None
            else "exit %d" % e.returncode, e.stderr[-4000:])
        got = torch.load(str(out / ("result-%d.pt" % e.index)),
                         weights_only=False)
        assert "error" not in got, got.get("error")
        results.append(got)
    return results, ended


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX package's seeded init, and a port checkpoint file of it."""
    variables = jax_ckpt.load_or_init(1, 5, CLASSES, LS, None)
    path = tmp_path_factory.mktemp("weights") / "tiny.pt"
    save_checkpoint(str(path), from_jax_variables(variables))
    return variables, str(path)


#: each pixel path's runs in its served launch, by name
RUNS = {"rgb": ("bf16", "f32", "sync"), "yuv420": ("bf16", "f32")}


@pytest.fixture(scope="module")
def served(weights, tmp_path_factory):
    """``get(pixel_path)``: one launch a pixel path, run once a module,
    serving its copy in bf16 and in float32 (rgb also with
    ``sync_preds``), then refusing a copy whose loader lies on member 0
    (process 0's). Returns {run name: [process 0's, process 1's]} and
    each process's refusal."""
    launched = {}

    def get(pixel_path):
        if pixel_path not in launched:
            out = tmp_path_factory.mktemp("served-" + pixel_path)
            runs = []
            for name in RUNS[pixel_path]:
                keys = {"sync_preds": True} if name == "sync" else {}
                runs.append(dict(
                    config=_write(_copy(pixel_path, weights[1], **keys),
                                  out / (name + ".json")),
                    videos=REQUESTS, seed=SEED,
                    dtype="float32" if name == "f32" else "bfloat16"))
            refused = _copy(pixel_path, weights[1])
            refused["pipeline"][0]["queue_groups"][0]["devices"] = [0]
            results, _ = _launch(out, "served", runs=runs,
                                 refused=_write(refused,
                                                out / "refused.json"))
            launched[pixel_path] = (
                {name: [r["runs"][i] for r in results]
                 for i, name in enumerate(RUNS[pixel_path])},
                [(r["refused"], r.get("run_benchmark")) for r in results])
        return launched[pixel_path]
    return get


class JaxReference:
    """The JAX package's one-process stages over 2 virtual devices for
    one pixel path: its loader's rows of every request, its mesh stage's
    class ids in the port's dispatch order, and its float32 logits."""

    def __init__(self, pixel_path, variables):
        self.pixel_path = pixel_path
        self.dp = DP[pixel_path]
        self.loader = jax_model.R2P1DLoader(
            jax.devices()[0], raw_output=True, pixel_path=pixel_path,
            num_warmups=0, **SAMPLER)
        self.stage = jax_model.R2P1DMeshRunner(
            device=jax.devices()[0], mesh_devices=[0, 1], dp=self.dp,
            pixel_path=pixel_path, **TINY)
        self.f32 = JaxSharded(
            JaxMesh(np.array(jax.devices()[:PROCESSES]).reshape(
                self.dp, PROCESSES // self.dp), ("dp", "sp")),
            variables=variables, pixel_path=pixel_path, dtype=jnp.float32,
            layer_sizes=LS, max_clips=TINY["max_clips"],
            consecutive_frames=TINY["consecutive_frames"],
            num_classes=CLASSES)
        self._rows = {}

    def rows(self, rid):
        """Request ``rid``'s (data, valid clips) from the JAX loader."""
        if rid not in self._rows:
            video = "synth://kinetics/video-%04d" % rid
            (pb,), _, _ = self.loader(None, video,
                                      jax_telemetry.TimeCard(rid))
            self._rows[rid] = (np.asarray(pb.data), int(pb.valid))
        return self._rows[rid]

    def classes(self, dispatches):
        """Request id -> class id of the JAX mesh stage, fed the
        requests of ``dispatches`` in order (a partial one flushed)."""
        out = {}
        for ids in dispatches:
            for rid in ids:
                data, valid = self.rows(rid)
                _, preds, _ = self.stage(
                    (JaxPadded(jnp.asarray(data), valid),),
                    None, jax_telemetry.TimeCard(rid))
            if len(ids) < self.dp:
                _, preds, _ = self.stage.flush()
            for rid, pred in zip(ids, np.asarray(preds)):
                out[rid] = int(pred)
        return out

    def logits(self, ids):
        """The float32 logits (dp, classes) of one dispatch of ``ids``,
        padded with zero videos of no valid clip."""
        datas, valids = [], []
        for rid in ids:
            data, valid = self.rows(rid)
            datas.append(data)
            valids.append(valid)
        while len(datas) < self.dp:
            datas.append(np.zeros_like(datas[0]))
            valids.append(0)
        return np.asarray(self.f32.run(*self.f32.place(np.stack(datas),
                                                       valids)))


@pytest.fixture(scope="module")
def reference(weights):
    made = {}

    def get(pixel_path):
        if pixel_path not in made:
            made[pixel_path] = JaxReference(pixel_path, weights[0])
        return made[pixel_path]
    return get


PIXEL_PATHS = sorted(DP)


def _rows_of(rank, dp):
    """The rows of a dispatch whose logits process ``rank`` computes: the
    one video at dp 1, its own at dp 2."""
    return slice(rank, rank + 1) if dp == PROCESSES else slice(0, 1)


# -- the reference serves the layout ---------------------------------------

@pytest.mark.parametrize("pixel_path", PIXEL_PATHS)
def test_the_reference_serves_the_launch_copy_in_one_process(
        pixel_path, tmp_path, monkeypatch):
    # the loader on the host (-1) with raw_output, the mesh stage homed
    # on 0 over members [0, 1]: the JAX package serves this layout
    monkeypatch.delenv("RNB_TPU_DATA_ROOT", raising=False)
    monkeypatch.delenv("RNB_FAULT_PLAN", raising=False)
    path = _write(_copy(pixel_path), tmp_path / "copy.json")
    result = jax_run_benchmark(path, mean_interval_ms=0,
                               num_videos=REQUESTS,
                               log_base=str(tmp_path / "logs"),
                               print_progress=False, seed=SEED)
    assert result.termination_flag == \
        TerminationFlag.TARGET_NUM_VIDEOS_REACHED


# -- the served launch -----------------------------------------------------

@pytest.mark.parametrize("pixel_path", PIXEL_PATHS)
def test_every_request_s_class_is_the_reference_s(pixel_path, served,
                                                  reference):
    runs, _ = served(pixel_path)
    first, second = runs["bf16"]
    # both processes dispatched the same requests in the same order
    assert [ids for ids, _ in first["dispatches"]] == [
        ids for ids, _ in second["dispatches"]]
    want = reference(pixel_path).classes(
        [ids for ids, _ in first["dispatches"]])
    assert sorted(want) == list(range(REQUESTS))
    held = {}
    for rank, run in enumerate(runs["bf16"]):
        # run_benchmark brought the sink to the host (finish_outputs)
        for rid, (video, pred) in run["sink"].items():
            assert video == "synth://kinetics/video-%04d" % rid
            assert pred == want[rid], (rank, rid)
            held.setdefault(rid, set()).add(rank)
    # every request's class in some process: both at dp 1, at dp 2 the
    # process that computed its row
    assert sorted(held) == list(range(REQUESTS))
    if DP[pixel_path] == 1:
        assert all(ranks == {0, 1} for ranks in held.values())
    else:
        assert all(len(ranks) == 1 for ranks in held.values())


@pytest.mark.parametrize("pixel_path", PIXEL_PATHS)
def test_float32_logits_are_the_reference_s_within_the_bound(
        pixel_path, served, reference):
    runs, _ = served(pixel_path)
    ref = reference(pixel_path)
    for rank, run in enumerate(runs["f32"]):
        assert len(run["logits"]) == len(run["dispatches"])
        for (ids, _), got in zip(run["dispatches"], run["logits"]):
            want = ref.logits(ids)[_rows_of(rank, DP[pixel_path])]
            assert got.dtype == torch.float32 and got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                       atol=F32_TOL)


@pytest.mark.parametrize("pixel_path", PIXEL_PATHS)
def test_bf16_logits_are_the_reference_s_with_equal_argmax(
        pixel_path, served, reference):
    runs, _ = served(pixel_path)
    ref = reference(pixel_path)
    for rank, run in enumerate(runs["bf16"]):
        for (ids, _), got in zip(run["dispatches"], run["logits"]):
            want = ref.logits(ids)[_rows_of(rank, DP[pixel_path])]
            np.testing.assert_allclose(got.numpy(), want, rtol=BF16_TOL,
                                       atol=BF16_TOL)
            assert (got.numpy().argmax(-1) == want.argmax(-1)).all()


def test_an_odd_request_count_is_completed_by_flush(served):
    runs, _ = served("yuv420")
    for run in runs["bf16"]:
        ids = [ids for ids, _ in run["dispatches"]]
        # two full dispatches, then the fifth request padded by flush
        assert ids == [[0, 1], [2, 3], [4]]
        assert run["compiles"]["step1"] == {
            "warmup": 1, "steady_new": 0, "steady_calls": 3}
        assert run["completed"] == REQUESTS


@pytest.mark.parametrize("pixel_path", PIXEL_PATHS)
def test_completions_are_equal_in_both_processes(pixel_path, served):
    runs, _ = served(pixel_path)
    for name in RUNS[pixel_path]:
        flags = [run["flag"] for run in runs[name]]
        completed = [run["completed"] for run in runs[name]]
        assert flags == [TerminationFlag.TARGET_NUM_VIDEOS_REACHED] * 2
        assert completed == [REQUESTS] * 2, name


@pytest.mark.parametrize("pixel_path", PIXEL_PATHS)
def test_each_process_writes_a_clean_job_directory_of_its_own(pixel_path,
                                                              served):
    runs, _ = served(pixel_path)
    dirs = [run["log_dir"] for run in runs["bf16"]]
    assert [d.rstrip("/").rsplit("-", 1)[1] for d in dirs] == ["p0", "p1"]
    for log_dir in dirs:
        assert_both_checks_pass(log_dir)


@pytest.mark.parametrize("pixel_path", PIXEL_PATHS)
def test_a_stage_on_the_other_process_s_member_is_refused_naming_it(
        pixel_path, served):
    # the copy's loader on member 0: process 0 serves it, process 1
    # refuses it at config load, before any device is touched
    _, refused = served(pixel_path)
    assert refused[0] == (None, None)
    message, again = refused[1]
    assert message == again
    assert "device 0 is the member of process 0 of the launch, so " \
           "process 1 cannot serve a stage there" in message


@pytest.mark.parametrize("pixel_path", PIXEL_PATHS)
def test_the_served_stage_waits_at_its_finalize_only(pixel_path, served):
    runs, _ = served(pixel_path)
    for run in runs["bf16"] + runs["f32"]:
        assert [waits for _, waits in run["dispatches"]] == [0] * len(
            run["dispatches"])
        assert run["finalize_waits"] == [1]


def test_with_sync_preds_the_stage_waits_once_a_dispatch(served):
    runs, _ = served("rgb")
    for run in runs["sync"]:
        assert [waits for _, waits in run["dispatches"]] == [1] * REQUESTS
        assert run["finalize_waits"] == [1]


@pytest.mark.parametrize("pixel_path", PIXEL_PATHS)
def test_a_stream_that_diverges_in_one_process_ends_both_runs(
        pixel_path, weights, tmp_path):
    # process 1 dead-letters request 2: at dp 1 its agreement at the end
    # meets process 0's last dispatch on the ring (the tables disagree);
    # at dp 2 the two processes' dispatch counts and digests differ
    path = _write(_copy(pixel_path, weights[1]), tmp_path / "copy.json")
    results, ended = _launch(
        tmp_path, "diverged", cap_s=CAP_S, plan_in=[1], plan=DEAD_LETTER,
        run=dict(config=path, videos=REQUESTS, seed=SEED))
    for rank, (run, e) in enumerate(zip(results, ended)):
        assert run["flag"] == TerminationFlag.INTERNAL_ERROR, rank
        assert run["seconds"] < CAP_S + SLACK_S
        ring = "ring sp:cpu,cpu:0,1" if DP[pixel_path] == 1 \
            else "ring mesh:cpu,cpu:0,1"
        errors = [line for line in e.stderr.splitlines()
                  if line.startswith(("RuntimeError: ring",
                                      "ValueError: ring"))]
        assert errors and all(ring in line for line in errors), e.stderr
        if DP[pixel_path] == 1:
            assert any("the processes' tables disagree" in line
                       for line in errors)
        else:
            assert any("the processes of the mesh served different "
                       "streams (process 0 dispatches 3" in line
                       for line in errors)
    # process 1 served one request fewer
    assert len(results[1]["dispatches"]) < REQUESTS


def test_a_config_without_a_mesh_stage_serves_in_both_processes(tmp_path):
    # the tiny two-step config with both stages on the host, served by
    # the benchmark's CLI in each process, which leaves the launch
    path = _write(launch_tool.launch_copy(_shipped("r2p1d-tiny"),
                                          PROCESSES, 1),
                  tmp_path / "tiny.json")
    logs = tmp_path / "logs"
    ended = launch_tool.launch(
        PROCESSES, [sys.executable, "-m", "rnb_tpu_torch.benchmark",
                    "--platform", "cpu", "-c", path, "-mi", "0", "-v", "4",
                    "--seed", "0", "--log-base", str(logs)],
        LAUNCH_TIMEOUT_S, env=_env(), cwd=REPO)
    for e in ended:
        assert e.returncode == 0, e.stderr[-4000:]
        assert "Throughput: " in e.stdout
    dirs = sorted(os.listdir(str(logs)))
    assert [d.rsplit("-", 1)[1] for d in dirs] == ["p0", "p1"]
    for d in dirs:
        with open(str(logs / d / "log-meta.txt")) as f:
            assert "Completed: requests=4 " in f.read()
        assert_both_checks_pass(str(logs / d))


# -- the pieces, in one process --------------------------------------------

def test_the_launch_copy_homes_mesh_stages_and_hosts_the_rest():
    raw = _shipped("r2p1d-mesh")
    copy = launch_tool.launch_copy(raw, 4, 2)
    loader, stage = copy["pipeline"]
    assert loader["queue_groups"][0]["devices"] == [-1]
    assert stage["queue_groups"][0]["devices"] == [0]
    assert (stage["mesh_devices"], stage["dp"]) == ([0, 1, 2, 3], 2)
    assert raw["pipeline"][1]["mesh_devices"] == list(range(8))


@pytest.fixture
def stand_in_launch(monkeypatch):
    """``join(count, index)``: this process as process ``index`` of a
    launch of ``count`` (no group is joined)."""
    def join(count, index):
        monkeypatch.setattr(distributed, "_launch",
                            distributed.Launch(count, index, None))
    return join


def test_a_device_index_names_a_global_member_in_a_launch(stand_in_launch):
    stand_in_launch(2, 1)
    assert [DeviceSpec(d, "cpu").owner for d in (-1, 0, 1)] == [1, 0, 1]
    assert DeviceSpec(0, "cpu").member() == mesh.Member(0, torch.device(
        "cpu"))
    with pytest.raises(DeviceResolutionError,
                       match="names device 2 but a launch of 2 processes "
                             "has 2 members, one a process"):
        DeviceSpec(2, "cpu").resolve()


@pytest.mark.parametrize("index", [0, 1])
def test_the_mesh_stage_runs_on_this_process_s_member(index,
                                                      stand_in_launch):
    stand_in_launch(2, index)
    cfg = parse_config(_copy("rgb"), platform="cpu")
    loader, stage = cfg.steps
    assert [d.spec for d in loader.groups[0].devices] == [-1]
    assert [d.spec for d in stage.groups[0].devices] == [index]
    assert [d.owner for d in stage.kwargs["mesh_devices"]] == [0, 1]


@pytest.mark.parametrize("home,count,message", [
    (2, 3, "the mesh stage's home device 2 is not a member of its mesh "
           r"\[0, 1\]"),
    (0, 3, r"process 2 of the launch owns no member of the mesh \[0, 1\] "
           r"\(its members lie in processes \[0, 1\]\)"),
    (0, 1, None)])
def test_a_mesh_stage_a_launch_cannot_serve_is_refused(home, count, message,
                                                       stand_in_launch):
    raw = _copy("rgb")
    raw["pipeline"][1]["queue_groups"][0]["devices"] = [home]
    if count > 1:
        stand_in_launch(count, 2)
        with pytest.raises(ConfigError, match=message):
            parse_config(raw, platform="cpu")
    else:
        # one process: the indices name this process's devices, as before
        assert parse_config(raw, platform="cpu").steps[1].groups[0]\
            .devices[0].spec == 0


def test_finish_outputs_drops_the_rows_of_another_process():
    sink = {0: ("v0", torch.tensor(ANOTHER_PROCESS), {}),
            1: ("v1", torch.tensor(5), {})}
    finish_outputs(sink)
    assert sink == {1: ("v1", 5, {})}


def _sharded(weights, members, axes):
    from rnb_tpu_torch.models.r2p1d import checkpoint as port_ckpt
    return ShardedInference(
        mesh.build_mesh(members, axes=axes),
        variables=port_ckpt.load_checkpoint(weights[1]), layer_sizes=LS,
        max_clips=3, consecutive_frames=TINY["consecutive_frames"],
        num_classes=CLASSES)


def test_in_one_process_the_block_is_the_whole_batch(weights):
    si = _sharded(weights, [torch.device("cpu")] * 2, {"dp": 1, "sp": 2})
    rng = np.random.default_rng(3)
    videos = rng.integers(0, 256, si.batch_shape(2), dtype=np.uint8)
    vids, mask = si.block(torch.from_numpy(videos), [1, 3])
    assert torch.equal(vids, torch.from_numpy(videos))
    assert torch.equal(mask, si.place_mask([1, 3]))
    assert si.rows(2) == (0, 2) and si.stream_ring is None
    si.agree([1, 2], ("a", "b"))  # nothing in one process


@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("dp", [1, 2])
def test_a_process_s_block_is_its_rows_and_clips(weights, stand_in_launch,
                                                 index, dp):
    # 3 clips padded to 4 over sp 2: member 1's shard is clip 2 and a
    # zero row of mask 0
    stand_in_launch(2, index)
    cpu = torch.device("cpu")
    si = _sharded(weights, [mesh.Member(p, cpu) for p in range(2)],
                  {"dp": dp, "sp": 2 // dp})
    rng = np.random.default_rng(4)
    videos = torch.from_numpy(rng.integers(0, 256, si.batch_shape(2),
                                           dtype=np.uint8))
    vids, mask = si.block(videos, [3, 2])
    whole = torch.cat([videos, videos.new_zeros(videos[:, :1].shape)], 1)
    full = torch.cat([si.place_mask([3, 2]), torch.zeros(2, 1)], 1)
    if dp == 1:
        clips = slice(2 * index, 2 * index + 2)
        assert torch.equal(vids, whole[:, clips])
        assert torch.equal(mask, full[:, clips])
        assert si.rows(2) == (0, 2) and si.stream_ring is si.sp_ring
    else:
        assert torch.equal(vids, videos[index:index + 1])
        assert torch.equal(mask, si.place_mask([3, 2])[index:index + 1])
        assert si.rows(2) == (index, index + 1) and si.sp_ring is None
        assert si.stream_ring.processes == (0, 1)


def test_the_launch_tool_gives_one_process_its_own_variable(tmp_path):
    ended = launch_tool.launch(
        PROCESSES, [sys.executable, "-c",
                    "import os; print(os.environ.get('RNB_ONLY', '-'))"],
        60.0, env=_env(), env_of={1: {"RNB_ONLY": "here"}})
    assert [e.stdout.strip() for e in ended] == ["-", "here"]


def test_load_config_of_a_shipped_copy_needs_its_members(stand_in_launch):
    # the shipped mesh config names 8 members: a launch of 2 has 2
    stand_in_launch(2, 0)
    with pytest.raises(ConfigError, match="names device 2 but a launch of "
                                          "2 processes has 2 members"):
        load_config(os.path.join(REPO, "configs", "r2p1d-mesh.json"),
                    platform="cpu")
