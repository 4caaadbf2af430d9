"""Narrowed one-card copies of the shipped configs that no other CPU test
serves, each served through both packages on the same seeded weights.

:func:`narrowed` keeps a config's topology as shipped: its steps, its
groups and the instances each builds, its selectors, Batchers and
queues, with every device index >= 0 made 0 (the one-card mapping of
``chip_smoke.one_card_copy``; the host stays the host). It narrows only
the geometry, as ``tests/test_torch_containment.py`` cuts its copies:
layer sizes (1, 1, 1, 1), 8 classes, 2 frames a clip, at most 3 clips a
request (1 or 3, weighted 2:1) and 3-row buckets; a loader's ``fuse`` is
cut to 3, a batch group's ``batch`` to at most 3 and a Batcher's
``shapes`` to 3 rows of 2 frames. ``r2p1d-tiny`` keeps its own reduced
geometry (8 classes, layer sizes (1, 1, 1, 1), 2 frames, 1 or 2 clips).

:class:`Served` runs a copy through the port's ``run_benchmark`` (CPU,
``outputs_sink`` and ``stages_sink``) and the JAX package's, over the
``synth://`` ids both packages decode byte for byte, with the port's
networks built from the JAX package's seeded variables
(``from_jax_variables``, the ``shared_network`` patch of
``tests/test_torch_containment.py``). :class:`JaxStages` gives the JAX
package's own stages' logits for one video.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from rnb_tpu import telemetry as jax_telemetry
from rnb_tpu.benchmark import run_benchmark as jax_run_benchmark
from rnb_tpu.config import load_config as jax_load_config
from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.models.r2p1d import model as jax_model
from rnb_tpu_torch.benchmark import run_benchmark
from rnb_tpu_torch.models.r2p1d import model as port_model
from rnb_tpu_torch.models.r2p1d.checkpoint import (filter_layer_range,
                                                   from_jax_variables)
from rnb_tpu_torch.models.r2p1d.network import (R2Plus1DClassifier,
                                                cast_compute_weights)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the shipped configs that served on the card first in the same slice
#: as these tests, in the order the smoke serves them
CONFIGS = ("rnb-fused-yuv", "rnb-1chip-yuv", "rnb-fused-yuv-xl",
           "r2p1d-tiny", "r2p1d-split", "baseline",
           "r2p1d-aggressive-global", "r2p1d-aggressive",
           "r2p1d-aggressive-four-groups", "r2p1d-nopipeline", "rnb")
#: served in the shipped config's own geometry
OWN_GEOMETRY = ("r2p1d-tiny",)
LS = (1, 1, 1, 1)
CLASSES = 8
FRAMES = 2
MAX_CLIPS = 3
ROW_BUCKETS = [1, 3]
SAMPLER = dict(max_clips=MAX_CLIPS, consecutive_frames=FRAMES,
               num_clips_population=[1, MAX_CLIPS], weights=[2, 1])
LOADERS = ("R2P1DLoader", "R2P1DFusingLoader", "R2P1DSingleStep")
NETWORKS = ("R2P1DRunner", "R2P1DSingleStep")
REQUESTS = 10


def kind(step) -> str:
    return step["model"].rpartition(".")[2]


def shipped(name) -> dict:
    with open(os.path.join(REPO, "configs", name + ".json")) as f:
        return json.load(f)


def narrowed(name, out_dir) -> str:
    """The narrowed one-card copy of ``configs/<name>.json``, written
    into ``out_dir`` (never into ``configs/``)."""
    raw = shipped(name)
    for step in raw["pipeline"]:
        for group in step["queue_groups"]:
            group["devices"] = [0 if d >= 0 else d
                                for d in group["devices"]]
        if name in OWN_GEOMETRY:
            continue
        model = kind(step)
        if model in LOADERS:
            step.update(SAMPLER)
            if "fuse" in step:
                step["fuse"] = min(step["fuse"], MAX_CLIPS)
        if model in NETWORKS:
            step.update(layer_sizes=list(LS), num_classes=CLASSES)
        if model in ("R2P1DRunner", "Batcher"):
            step.update(max_rows=MAX_CLIPS, consecutive_frames=FRAMES)
        if "shapes" in step:
            step["shapes"] = [[MAX_CLIPS, FRAMES] + list(s[2:])
                              for s in step["shapes"]]
        if "row_buckets" in step:
            step["row_buckets"] = list(ROW_BUCKETS)
        for group in step["queue_groups"]:
            if "batch" in group:
                group["batch"] = min(group["batch"], MAX_CLIPS)
            if "row_buckets" in group:
                group["row_buckets"] = list(ROW_BUCKETS)
    path = os.path.join(out_dir, name + ".json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def bridged_weights():
    """The JAX package's seeded variables, and the port's
    ``shared_network`` building its networks from them."""
    weights = jax_ckpt.load_or_init(1, 5, CLASSES, LS, None)
    state = from_jax_variables(weights)

    def shared_network(start, end, num_classes, layer_sizes, device,
                       dtype=torch.bfloat16, factored_shortcut=False,
                       **_kwargs):
        assert (num_classes, tuple(layer_sizes)) == (CLASSES, LS)
        net = R2Plus1DClassifier(start, end, num_classes, layer_sizes,
                                 factored_shortcut, dtype=dtype)
        net.load_state_dict(filter_layer_range(state, start, end),
                            strict=True)
        return cast_compute_weights(net).to(device).eval()
    return weights, shared_network


class JaxStages:
    """The JAX package's stages (``R2P1DLoader`` -> ``R2P1DRunner`` over
    each network range), built once per geometry and asked for one
    video's logits at a time."""

    def __init__(self):
        self._stages = {}
        self._logits = {}

    def logits(self, video, sampler, pixel_path, ranges):
        key = (video, tuple((k, tuple(v) if isinstance(v, list) else v)
                            for k, v in sorted(sampler.items())),
               pixel_path, ranges)
        if key not in self._logits:
            chain = key[1:]
            if chain not in self._stages:
                device = jax.devices()[0]
                rows = sampler["max_clips"]
                loader = jax_model.R2P1DLoader(
                    device, num_warmups=0, pixel_path=pixel_path,
                    **dict(chain[0]))
                runners = [jax_model.R2P1DRunner(
                    device, start_index=s, end_index=e, num_classes=CLASSES,
                    layer_sizes=LS, max_rows=rows,
                    consecutive_frames=sampler["consecutive_frames"],
                    num_warmups=0, row_buckets=[1, rows],
                    pixel_path=pixel_path) for s, e in ranges]
                self._stages[chain] = (loader, runners)
            loader, runners = self._stages[chain]
            card = jax_telemetry.TimeCard(0)
            tensors, nt, card = loader(None, video, card)
            for runner in runners:
                tensors, nt, card = runner(tensors, nt, card)
            self._logits[key] = np.asarray(
                tensors[0].data)[:tensors[0].valid].astype(np.float32)
        return self._logits[key]


def assert_logits_close(got, want):
    """Served bf16 logits against the JAX stages' bf16 logits. Both
    packages compute in bf16 with the same rounding points, so what
    differs is the accumulation order inside the convs (XLA against
    oneDNN), re-rounded at some 20 points: the bound is 2% of the logit
    scale, the one ``tests/test_torch_pipeline.py`` and
    ``tests/test_torch_slice.py`` hold served bf16 logits to (the
    float32 network's own bound, rtol = atol = 5e-4 in
    ``tests/test_torch_network.py``, holds for float32 only), and the
    argmax must agree wherever the top-2 margin exceeds twice it."""
    bound = 0.02 * float(np.abs(want).max())
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= bound
    for g, w in zip(got, want):
        top2 = np.sort(w)[-2:]
        if top2[1] - top2[0] > 2 * bound:
            assert g.argmax() == w.argmax()


class Served:
    """One narrowed copy served through both packages: the port's
    ``result``, ``sink`` (request -> (video, logits or class id,
    stamps)) and ``stages`` ((step, stage) built), the JAX package's
    ``reference`` result, the copy's ``path`` and parsed ``raw``."""

    def __init__(self, name, tmp):
        self.name = name
        self.path = narrowed(name, tmp)
        with open(self.path) as f:
            self.raw = json.load(f)
        self.sink, self.stages = {}, []
        self.result = run_benchmark(
            self.path, mean_interval_ms=0, num_videos=REQUESTS,
            log_base=os.path.join(tmp, "logs", name), print_progress=False,
            seed=0, platform="cpu", outputs_sink=self.sink,
            stages_sink=self.stages)
        self.reference = jax_run_benchmark(
            self.path, mean_interval_ms=0, num_videos=REQUESTS,
            queue_size=500, log_base=os.path.join(tmp, "jax", name),
            print_progress=False, seed=0)
        self.reference_config = jax_load_config(self.path)

    @property
    def loader(self) -> dict:
        return self.raw["pipeline"][0]

    def sampler(self) -> dict:
        return {k: self.loader[k] for k in (
            "max_clips", "consecutive_frames", "num_clips_population",
            "weights")}

    def ranges(self) -> tuple:
        return tuple((s.get("start_index", 1), s.get("end_index", 5))
                     for s in self.raw["pipeline"] if kind(s) in NETWORKS)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """``get(name)``: the config's :class:`Served`, once a module, with
    the port's networks on the JAX package's weights while it serves."""
    weights, shared_network = bridged_weights()
    tmp = str(tmp_path_factory.mktemp("configs"))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_model, "shared_network", shared_network)
        mp.delenv("RNB_TPU_DATA_ROOT", raising=False)
        mp.delenv("RNB_FAULT_PLAN", raising=False)

        def get(name):
            if name not in runs:
                runs[name] = Served(name, tmp)
            return runs[name]
        yield get


@pytest.fixture(scope="module")
def jax_stages():
    return JaxStages()


# -- the checks every narrowed copy is held to --------------------------------

#: the keys :func:`narrowed` may change: a step's, a group's
GEOMETRY_KEYS = {"max_clips", "consecutive_frames", "num_clips_population",
                 "weights", "fuse", "layer_sizes", "num_classes",
                 "max_rows", "shapes", "row_buckets"}
GROUP_GEOMETRY_KEYS = {"devices", "batch", "row_buckets"}


def check_topology(name, tmp):
    """The narrowed copy keeps the shipped topology (its steps and
    models, its groups with their queues, selectors and instance counts)
    and every key but the geometry's; its devices are all 0 (or the
    host)."""
    raw = shipped(name)
    with open(narrowed(name, str(tmp))) as f:
        copy = json.load(f)

    def kept(d, geometry):
        return {k: v for k, v in d.items() if k not in geometry}
    assert kept(copy, {"pipeline"}) == kept(raw, {"pipeline"})
    assert len(copy["pipeline"]) == len(raw["pipeline"])
    for ours, theirs in zip(copy["pipeline"], raw["pipeline"]):
        geometry = GEOMETRY_KEYS | {"queue_groups"}
        assert kept(ours, geometry) == kept(theirs, geometry)
        assert len(ours["queue_groups"]) == len(theirs["queue_groups"])
        for g, h in zip(ours["queue_groups"], theirs["queue_groups"]):
            assert set(g) == set(h)
            assert kept(g, GROUP_GEOMETRY_KEYS) == \
                kept(h, GROUP_GEOMETRY_KEYS)
            assert g["devices"] == [0 if d >= 0 else d for d in h["devices"]]


def check_logits(run, jax_stages):
    """Every request served, each one's logits (or class id) held to
    the JAX stages' on the same video and weights."""
    result, sink = run.result, run.sink
    assert result.termination_flag == 0 and result.device == "cpu"
    assert result.num_completed == REQUESTS
    assert sorted(sink) == list(range(REQUESTS))
    pixel_path = run.loader.get("pixel_path", "rgb")
    clips, held = 0, 0
    for rid, (video, out, _stamps) in sorted(sink.items()):
        assert video == "synth://kinetics/video-%04d" % rid
        want = jax_stages.logits(video, run.sampler(), pixel_path,
                                 run.ranges())
        clips += want.shape[0]
        if isinstance(out, int):
            # a class id: the argmax of the summed clip logits, held
            # wherever the JAX margin exceeds the bf16 bound on that sum
            # (tests/test_torch_pipeline.py's rule)
            assert 0 <= out < CLASSES
            total = want.sum(axis=0)
            top2 = np.sort(total)[-2:]
            if top2[1] - top2[0] > 0.04 * float(np.abs(total).max()):
                assert out == int(total.argmax()), rid
                held += 1
            continue
        assert out.shape == want.shape == (want.shape[0], CLASSES)
        assert_logits_close(out, want)
        held += 1
    assert held >= REQUESTS // 2
    assert result.clips_completed == clips


def check_jobs(run):
    """Both packages' whole check_job on the port's job directory; no
    signature new in the window."""
    from rnb_tpu_torch.parse_utils import summarize
    from torch_job_checks import assert_both_checks_pass
    assert_both_checks_pass(run.result.log_dir)
    # (the single step keeps no signature table)
    signatures = summarize(run.result.log_dir)["compile_signatures"] or {}
    for step, sigs in signatures.items():
        assert sigs["steady_new"] == 0, step


def _tables(log_dir):
    return sorted(n for n in os.listdir(log_dir)
                  if n.endswith(".txt") and n != "log-meta.txt")


def check_instances(run):
    """The port builds, step by step, the instances the reference's
    config reader gives (one a device of each group), of the step's
    model, every network instance on the one device; the last step's
    per-instance timing tables are the reference run's, and their rows
    the requests."""
    from rnb_tpu_torch.parse_utils import read_table
    want = [(step.model.rpartition(".")[2],
             sum(len(g.devices) for g in step.groups))
            for step in run.reference_config.steps]
    got = [({type(stage).__name__ for i, stage in run.stages if i == s},
            sum(i == s for i, _ in run.stages)) for s in range(len(want))]
    assert got == [({model}, n) for model, n in want]
    assert len(run.stages) == sum(n for _, n in want)
    for _, stage in run.stages:
        if type(stage).__name__ in NETWORKS:
            assert getattr(stage, "net", stage).torch_device == \
                torch.device("cpu")
    tables = _tables(run.result.log_dir)
    assert tables == _tables(run.reference.log_dir)
    last = run.reference_config.steps[-1]
    assert len(tables) == sum(len(g.devices) for g in last.groups)
    for log_dir in (run.result.log_dir, run.reference.log_dir):
        assert sum(len(read_table(os.path.join(log_dir, t))[1])
                   for t in tables) == REQUESTS
