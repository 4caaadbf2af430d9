"""The port's compile accounting and captured forwards, on the CPU.

* ``signature_of`` / ``SignatureTracker`` / ``aggregate_compile_records``
  of ``rnb_tpu_torch.compilestats`` give the tuples and snapshots of
  ``rnb_tpu.compilestats`` on the same numpy-made inputs (as torch
  tensors on the port's side: the dtype names must read alike).
* The runner's graph keys name the signatures the JAX runner observes
  (its warm-up vocabulary), per bucket and, ragged, with one graph per
  tile count; a signature first seen in the measured window counts as
  ``steady_new``.
* ``CapturedForward`` adds its capture's kernel launches once per
  replay (a fake graph stands in for the CUDA graph) and hands out a
  copy of its static output.
* The ``Compiles:`` / ``Warmup:`` log-meta lines of a CPU run parse, in
  ``scripts/parse_utils.py``'s reader, to the port reader's dicts, and
  both fail a run with ``steady_new > 0``.
* ``factored_shortcut`` threads through the runner: its logits match
  the JAX applier's on a shared variable tree (bf16, the slice tests'
  bound) and the flax float32 network's (5e-4, tests/test_torch_network.py's
  bound); the two shortcut forms never share a network.
* ``parse_config`` accepts ``rnb-fused-yuv-big-torchckpt`` and
  ``rnb-fused-yuv-mid``.
"""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnb_tpu import compilestats as jax_compilestats
from rnb_tpu.models.r2p1d import model as jax_model
from rnb_tpu.models.r2p1d import network as jax_net
from rnb_tpu.models.r2p1d.model import _shared_apply
from rnb_tpu_torch import compilestats
from rnb_tpu_torch.config import load_config
from rnb_tpu_torch.devices import DeviceSpec
from rnb_tpu_torch.models.r2p1d import model as port_model
from rnb_tpu_torch.models.r2p1d.checkpoint import from_jax_variables
from rnb_tpu_torch.models.r2p1d.model import CapturedForward, R2P1DRunner
from rnb_tpu_torch.models.r2p1d.network import (R2Plus1DClassifier,
                                                cast_compute_weights)
from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.parse_utils import footing_problems, read_meta
from rnb_tpu_torch.stage import PaddedBatch, RaggedBatch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import parse_utils as ref_parse_utils  # noqa: E402

from test_torch_slice import (_assert_logits_close, _dataset,  # noqa: E402
                              _randomize_bn, _reduced)
from torch_job_checks import assert_both_checks_pass  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = DeviceSpec(0, "cpu")
LS = (1, 1, 1, 1)
CLASSES = 10
PACKED = 18816  # one 112x112 4:2:0 frame
BIG_BUCKETS = [6, 15, 24, 36, 48]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (3, 8, 16), dtype=np.uint8),
            rng.integers(-5, 5, (2, 4, 9), dtype=np.int16),
            rng.normal(size=(4, 2)).astype(np.float32)]


def test_signatures_read_as_the_references():
    for a in _inputs(0):
        assert compilestats.signature_of(torch.from_numpy(a)) == \
            jax_compilestats.signature_of(a)
    bf16 = np.random.default_rng(1).normal(size=(2, 3)).astype(np.float32)
    assert compilestats.signature_of(
        torch.from_numpy(bf16).to(torch.bfloat16), 3) == \
        jax_compilestats.signature_of(jnp.asarray(bf16, jnp.bfloat16), 3)
    assert compilestats.signature_of(torch.zeros(2, dtype=torch.bfloat16)) \
        == (((2,), "bfloat16"),)


def test_tracker_snapshots_equal_the_references():
    ours, ref = compilestats.SignatureTracker(), \
        jax_compilestats.SignatureTracker()
    a, b, c = _inputs(2)
    for tracker, conv in ((ours, torch.from_numpy), (ref, lambda x: x)):
        tracker.observe(conv(a))
        tracker.observe(conv(b))
        tracker.observe(conv(a))
        tracker.freeze()
        for x in (a, a, c, c, b):
            tracker.observe(conv(x))
    assert ours.snapshot() == ref.snapshot() == {
        "warmup": 2, "steady_new": 1, "steady_calls": 5}
    records = [(0, 1.25, None), (1, 2.5, ours.snapshot()),
               (1, 0.5, ref.snapshot())]
    assert compilestats.aggregate_compile_records(records) == \
        jax_compilestats.aggregate_compile_records(records)


def _jax_runner(**kwargs):
    return jax_model.R2P1DRunner(
        jax.devices()[0], num_classes=CLASSES, layer_sizes=LS,
        num_warmups=0, **kwargs)


def _port_runner(**kwargs):
    return R2P1DRunner(CPU, num_classes=CLASSES, layer_sizes=LS,
                       num_warmups=0, **kwargs)


@pytest.mark.parametrize("kwargs,tiles", [
    # big's buckets on the yuv420 wire: one graph a bucket
    (dict(max_rows=48, row_buckets=BIG_BUCKETS, pixel_path="yuv420"),
     None),
    # the ragged cell: the 15-row pool, a graph per tile count (chunk 5)
    (dict(max_rows=15, pixel_path="yuv420", ragged=True,
          ragged_pool_rows=15), (1, 2, 3)),
    (dict(max_rows=15, pixel_path="dct", ragged=True, ragged_pool_rows=15,
          ragged_chunk_rows=3), (1, 2, 3, 4, 5)),
    # the rgb wire, and a stage past layer 1 (float32 feature maps)
    (dict(max_rows=15, row_buckets=[1, 15]), None),
    (dict(start_index=5, max_rows=15, row_buckets=[1, 15]), None),
])
def test_graph_keys_name_the_jax_runners_signatures(kwargs, tiles):
    ref = _jax_runner(**kwargs)
    ours = _port_runner(**kwargs)
    want = ref.compiles._warmup
    assert ours.compiles._warmup == want
    keys = ours.graph_keys()
    assert {sig for sig, _ in keys} == want
    if tiles is None:
        assert [t for _, t in keys] == [None] * len(want)
    else:
        assert tuple(t for _, t in keys) == tiles
    assert ours.graph_stats is None  # no graph on the CPU


def test_a_signature_first_seen_in_the_window_is_steady_new():
    ref = _jax_runner(max_rows=3, row_buckets=[1, 3], pixel_path="yuv420")
    ours = _port_runner(max_rows=3, row_buckets=[1, 3],
                        pixel_path="yuv420")
    packed = np.random.default_rng(3).integers(0, 256, (3, 8, PACKED),
                                               dtype=np.uint8)
    ref.compiles.freeze()
    ours.compiles.freeze()
    for rows in (3, 1, 2, 2):  # 2 rows: no bucket declared it
        ours((PaddedBatch(torch.from_numpy(packed[:rows]), rows),), None,
             None)
        ref.compiles.observe(packed[:rows])
    assert ours.compiles.snapshot() == ref.compiles.snapshot() == {
        "warmup": 2, "steady_new": 1, "steady_calls": 4}


def test_ragged_graph_key_follows_the_tile_count():
    ours = _port_runner(max_rows=15, pixel_path="yuv420", ragged=True,
                        ragged_pool_rows=15)
    pool = torch.zeros((15, 8, PACKED), dtype=torch.uint8)
    sig = compilestats.signature_of(pool)
    for valid, tiles in ((1, 1), (5, 1), (6, 2), (11, 3), (15, 3), (0, 1)):
        assert ours.graph_key(pool, valid) == (sig, tiles)
    assert set(ours.graph_keys()) == {(sig, t) for t in (1, 2, 3)}


class _FakeGraph:
    """Stands in for a CUDA graph: a replay doubles the static input
    into the static output."""

    def __init__(self, static_in, static_out):
        self.static_in, self.static_out = static_in, static_out
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.static_out.copy_(self.static_in.float() * 2)


def test_replay_counts_the_captures_launches_once_per_replay():
    static_in = torch.zeros((2, 3), dtype=torch.uint8)
    static_out = torch.zeros((2, 3))
    rows_valid = torch.zeros((1,), dtype=torch.int32)
    graph = _FakeGraph(static_in, static_out)
    captured = CapturedForward(graph, static_in, rows_valid, static_out,
                               {"yuv420_normalize": 1, "gather_rows": 0},
                               0.5)
    _kernels.reset_launches()
    x = torch.arange(6, dtype=torch.uint8).reshape(2, 3)
    outs = [captured.replay(x + i, 2 - i) for i in range(3)]
    assert graph.replays == 3
    assert _kernels.launch_counts()["yuv420_normalize"] == 3
    assert sum(_kernels.launch_counts().values()) == 3
    # each replay's output is its own copy; rows_valid was written
    for i, out in enumerate(outs):
        assert torch.equal(out, (x + i).float() * 2)
        assert out.data_ptr() != static_out.data_ptr()
    assert int(rows_valid) == 0
    _kernels.reset_launches()


def test_recording_tallies_instead_of_counting():
    _kernels.reset_launches()
    with _kernels.recording() as tally:
        assert _kernels._capturing.tally is tally
    assert _kernels._capturing.tally is None and tally == {}
    _kernels.add_launches({"dct_ingest": 2, "gather_rows": 1})
    counts = _kernels.launch_counts()
    assert (counts["dct_ingest"], counts["gather_rows"]) == (2, 1)
    _kernels.reset_launches()


def test_compiles_and_warmup_lines_parse_alike(tmp_path, monkeypatch):
    from rnb_tpu_torch.benchmark import run_benchmark
    config = "configs/rnb-fused-yuv-big.json"
    monkeypatch.setenv("RNB_TPU_DATA_ROOT", _dataset(str(tmp_path / "d")))
    result = run_benchmark(_reduced(config, tmp_path), mean_interval_ms=0,
                           num_videos=6, log_base=str(tmp_path / "logs"),
                           print_progress=False, seed=0, platform="cpu")
    assert result.termination_flag == 0
    meta = os.path.join(result.log_dir, "log-meta.txt")
    ours = read_meta(meta)
    assert ours["compile_signatures"] == result.compiles
    assert ours["warmup_s"] == result.warmup_s
    assert set(result.warmup_s) == {"step0", "step1"}
    # the runner's vocabulary is its two buckets; every forward in the
    # window was one of them
    step1 = result.compiles["step1"]
    assert step1["warmup"] == 2 and step1["steady_new"] == 0
    assert step1["steady_calls"] >= 2
    assert "step0" not in result.compiles  # a yuv420 loader runs no step
    assert result.graphs == {}  # no graph on the CPU
    with open(meta) as f:
        lines = f.read().splitlines()
    assert not any(line.startswith("Graphs:") for line in lines)
    assert footing_problems(ours) == []
    assert_both_checks_pass(result.log_dir)

    def reference_reads(compiles_line):
        """The reference's reader and check on the port's lines."""
        job = tmp_path / "ref-job"
        job.mkdir(exist_ok=True)
        (job / "log-meta.txt").write_text("\n".join(
            [line for line in lines if line.startswith((
                "Termination flag:", "Warmup:"))]
            + [lines[1], compiles_line]) + "\n")
        return (ref_parse_utils.parse_meta(str(job)),
                ref_parse_utils.check_job(str(job)))

    compiles_line = next(ln for ln in lines if ln.startswith("Compiles:"))
    ref, problems = reference_reads(compiles_line)
    assert ref["compile_signatures"] == ours["compile_signatures"]
    assert ref["warmup_s"] == ours["warmup_s"]
    assert not any("steady_new" in p for p in problems)
    # a signature first seen in the window fails both readers' checks
    bad = "Compiles: %s" % json.dumps(
        dict(result.compiles, step1=dict(step1, steady_new=1)),
        sort_keys=True)
    with open(meta, "w") as f:
        f.write("\n".join(bad if ln == compiles_line else ln
                          for ln in lines) + "\n")
    problems = footing_problems(read_meta(meta))
    assert len(problems) == 1 and "step1" in problems[0]
    _, ref_problems = reference_reads(bad)
    assert any("step1" in p and "steady_new" in p for p in ref_problems)


# -- factored_shortcut -----------------------------------------------------

def _variables(factored, seed=0):
    from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
    variables = jax_ckpt.init_variables(seed=seed, num_classes=CLASSES,
                                        layer_sizes=LS,
                                        factored_shortcut=factored)
    return {k: _randomize_bn(dict(v), np.random.default_rng(1))
            for k, v in variables.items()}


def test_factored_runner_matches_the_jax_runner():
    variables = _variables(True)
    net = R2Plus1DClassifier(1, 5, CLASSES, LS, True, dtype=torch.bfloat16)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    packed = np.random.default_rng(4).integers(0, 256, (2, 8, PACKED),
                                               dtype=np.uint8)
    want = np.asarray(_shared_apply(1, 5, CLASSES, LS, True,
                                    pixel_path="yuv420")(variables, packed))
    runner = _port_runner(max_rows=2, pixel_path="yuv420",
                          factored_shortcut=True,
                          network=cast_compute_weights(net).eval())
    (out,), _, _ = runner((PaddedBatch(torch.from_numpy(packed), 2),),
                          None, None)
    _assert_logits_close(out.data.numpy(), want)


def test_factored_runner_matches_flax_float32():
    # the runner's path (rgb frames into layer 1, ragged tiles) on a
    # float32 network against the flax float32 module, same tree
    module = jax_net.R2Plus1DClassifier(
        start=1, end=5, num_classes=CLASSES, layer_sizes=LS,
        factored_shortcut=True, dtype=jnp.float32)
    variables = _variables(True, seed=5)
    net = R2Plus1DClassifier(1, 5, CLASSES, LS, True, dtype=torch.float32)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    frames = np.random.default_rng(6).uniform(
        -1, 1, (6, 8, 112, 112, 3)).astype(np.float32)
    frames[4:] = 7.0  # a tail no tile reads
    runner = _port_runner(max_rows=6, factored_shortcut=True, ragged=True,
                          ragged_pool_rows=6, ragged_chunk_rows=2,
                          network=net.eval())
    (out,), _, _ = runner((RaggedBatch(torch.from_numpy(frames), 3,
                                       (0, 3)),), None, None)
    want = np.asarray(jax.jit(functools.partial(module.apply, train=False))(
        variables, frames[:3]))
    got = out.data.numpy()
    np.testing.assert_allclose(got[:3], want, rtol=5e-4, atol=5e-4)
    assert not got[4:].any()  # past the two tiles that ran


def test_factored_flag_reaches_the_shared_network(monkeypatch):
    monkeypatch.setattr(port_model, "_network_cache", {})
    plain = _port_runner(max_rows=2, row_buckets=[2])
    factored = _port_runner(max_rows=2, row_buckets=[2],
                            factored_shortcut=True)
    assert factored.factored_shortcut and not plain.factored_shortcut
    assert factored.network is not plain.network
    names = set(factored.network.state_dict())
    assert names != set(plain.network.state_dict())
    assert any(".shortcut.spatial." in n for n in names)
    assert _port_runner(max_rows=2, row_buckets=[2],
                        factored_shortcut=True).network is factored.network


@pytest.mark.parametrize("config,key,value", [
    ("configs/rnb-fused-yuv-big-torchckpt.json", "factored_shortcut", True),
    ("configs/rnb-fused-yuv-mid.json", "depth", 24),
])
def test_parse_config_accepts_both_configs(config, key, value):
    cfg = load_config(os.path.join(REPO, config), platform="cpu")
    step = cfg.steps[1] if key == "factored_shortcut" else cfg.steps[0]
    assert step.kwargs[key] == value
