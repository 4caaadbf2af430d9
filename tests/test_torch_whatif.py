"""The port's what-if engine (``rnb_tpu_torch.whatif``) held to the JAX
package's (``rnb_tpu.whatif``).

The same inputs go through both packages: seeded synthetic metrics
snapshots (service histograms of two steps, a shard merge's
``exec1.collective``, arrival rates by each of the reference's rules)
calibrated against the step facts of shipped configs, and the job
directories of a served reduced ``rnb-shard-d1``/``-d2`` pair (the
port's ``run_benchmark`` on the CPU, with the root ``whatif`` key) read
by both packages' ``calibrate_job``. Predicted throughput, per-stage
waits and the ``query`` dicts of a set of counterfactuals (lanes, service
scale, arrival scale, pool rows, shard degree, ``shard_degree_step1=1``
included) are equal within 1e-9 relative; ``steps_info_from_config``
and ``summary_counters`` are equal on every shipped config.
"""

import glob
import json
import math
import os

import numpy as np
import pytest

from rnb_tpu import metrics as jax_metrics
from rnb_tpu import whatif as jax_whatif
from rnb_tpu_torch import metrics, placement, whatif
from rnb_tpu_torch.decode import write_y4m
from rnb_tpu_torch.parse_utils import summarize
from torch_job_checks import assert_both_checks_pass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))
D1 = os.path.join(REPO, "configs/rnb-shard-d1.json")
D2 = os.path.join(REPO, "configs/rnb-shard-d2.json")
RTOL = 1e-9
#: counterfactuals asked of every calibrated model
SPECS = [None,
         {"replicas": {"step1": 2}},
         {"replicas": {"step1": "+1", "step0": 3}},
         {"replicas": {"step1": "-1"}},
         {"service_scale": {"step1": 0.5}},
         {"service_scale": {"step0": 1.7, "step1": 0.9}},
         {"arrival_scale": 1.5},
         {"arrival_scale": 0.25},
         {"pool_rows": 30},
         {"shard_degree": {"step1": 1}},
         {"shard_degree": {"step1": 2}},
         {"shard_degree": {"step1": 4}},
         {"shard_degree": {"step1": 8}, "replicas": {"step1": 2},
          "arrival_scale": 2.0}]


def _close(got, want):
    """Equal within RTOL relative, recursively (strings and ints exact)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for key in want:
            _close(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    elif isinstance(want, float):
        if math.isinf(want):
            assert got == want
        else:
            assert got == pytest.approx(want, rel=RTOL, abs=0.0)
    else:
        assert got == want and type(got) is type(want)


def test_the_ring_hop_factor_is_the_reference_s():
    from rnb_tpu.placement import ring_hop_factor
    for degree in range(-1, 17):
        assert placement.ring_hop_factor(degree) == ring_hop_factor(degree)


def test_the_histogram_bounds_are_the_reference_s():
    assert metrics.hist_upper_bounds() == jax_metrics.hist_upper_bounds()


@pytest.mark.parametrize("raw", [None, {}, {"enabled": True},
                                 {"enabled": False}])
def test_settings_from_config_equal_the_reference(raw):
    ours = whatif.WhatifSettings.from_config(raw)
    theirs = jax_whatif.WhatifSettings.from_config(raw)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert ours.enabled == theirs.enabled


@pytest.mark.parametrize("config", SHIPPED,
                         ids=[os.path.basename(p) for p in SHIPPED])
def test_steps_info_of_every_shipped_config_is_the_reference_s(config):
    with open(config) as f:
        raw = json.load(f)
    assert whatif.steps_info_from_config(raw) \
        == jax_whatif.steps_info_from_config(raw)


def _hist(rng, mean_ms, count, bounds):
    """A histogram dict of ``count`` seeded log-normal samples."""
    samples = rng.lognormal(np.log(mean_ms), 0.4, count)
    buckets = [0] * len(bounds)
    for value in samples:
        buckets[next(i for i, b in enumerate(bounds) if value <= b)] += 1
    return {"count": int(count), "sum_ms": float(samples.sum()),
            "buckets": buckets}


def _snapshot(seed, arrivals, collective):
    """A metrics snapshot of a two-step run: the service histograms the
    model calibrates from, the completion counter and one arrival rule
    (none: bulk; ``client``: the windowed arrival rate; ``autotune``: the
    controller's arrival gauge)."""
    rng = np.random.default_rng(seed)
    bounds = metrics.hist_upper_bounds()
    requests = int(rng.integers(40, 400))
    d0, d1 = int(rng.integers(8, requests)), int(rng.integers(4, requests))
    hists = {
        "exec0.model_call": _hist(rng, rng.uniform(0.5, 6.0), d0, bounds),
        "exec0.device_sync": _hist(rng, 0.05, d0, bounds),
        "exec1.model_call": _hist(rng, rng.uniform(2.0, 30.0), d1, bounds),
        "exec1.device_sync": _hist(rng, rng.uniform(0.1, 3.0), d1, bounds),
        # spans the model ignores
        "exec1.queue_get": _hist(rng, 1.0, d1, bounds),
    }
    if collective:
        hists["exec1.collective"] = _hist(rng, rng.uniform(0.2, 1.5), d1,
                                          bounds)
    snap = {"seq": 7, "counters": {"slo.tracked": requests},
            "gauges": {}, "rates": {}, "histograms": hists}
    if arrivals == "client":
        snap["rates"]["client.arrivals"] = float(rng.uniform(20.0, 400.0))
    elif arrivals == "autotune":
        snap["gauges"]["autotune.arrival_hz"] = float(rng.uniform(20, 400))
        snap["rates"]["client.arrivals"] = 1.0  # the gauge wins
    return snap


def _answers(module, model):
    """Everything the model answers, as plain data."""
    out = {"calibrated": model.calibrated,
           "summary": module.summary_counters(model),
           "stages": [(s.step, s.lanes, s.dispatches, s.service_ms,
                       s.service_m2_ms2, s.injected_ms, s.rows_cap,
                       s.collective_ms, s.shard_degree, s.host_ms)
                      for s in model.stages]}
    for idx, spec in enumerate(SPECS):
        out["throughput%d" % idx] = list(model.predict_throughput(spec))
        out["query%d" % idx] = model.query(spec)
        for stage in model.stages:
            out["wait%d_%d" % (idx, stage.step)] = model.predict_wait_ms(
                stage.step, spec)
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("arrivals", ["bulk", "client", "autotune"])
@pytest.mark.parametrize("config", ["rnb-fused-yuv-metrics.json",
                                    "rnb-shard-d2.json", "rnb-shard-d1.json",
                                    "rnb-fused-yuv-ragged.json",
                                    "r2p1d-tiny-shed.json"])
def test_synthetic_snapshots_predict_as_the_reference(seed, arrivals, config):
    with open(os.path.join(REPO, "configs", config)) as f:
        raw = json.load(f)
    snap = _snapshot(seed, arrivals, collective="d2" in config)
    models = []
    for module in (whatif, jax_whatif):
        models.append(module.calibrate_from_snapshot(
            snap, module.steps_info_from_config(raw), wall_s=3.25,
            arrival_hz=module.arrival_hz_from_snapshot(snap)))
    ours, theirs = models
    assert ours.arrival_hz == theirs.arrival_hz
    assert (ours.arrival_hz is None) == (arrivals == "bulk")
    _close(_answers(whatif, ours), _answers(jax_whatif, theirs))


def test_an_uncalibrated_model_counts_as_the_reference_s():
    empty = {"counters": {}, "gauges": {}, "rates": {}, "histograms": {}}
    for snap in (empty, _snapshot(0, "bulk", False)):
        for info in ({}, {1: {"lanes": 3}}):
            ours = whatif.calibrate_from_snapshot(snap, info, wall_s=1.0,
                                                  requests=0)
            theirs = jax_whatif.calibrate_from_snapshot(snap, info,
                                                        wall_s=1.0,
                                                        requests=0)
            assert not ours.calibrated
            assert whatif.summary_counters(ours) \
                == jax_whatif.summary_counters(theirs)
            assert ours.predict_throughput() == theirs.predict_throughput()
    assert whatif.summary_counters(None) == jax_whatif.summary_counters(None)


def test_degree_one_predicts_no_collective_tax():
    """The reference's rule: calibrated at degree 1 there is no measured
    collective slice, so a degree-k query changes nothing."""
    with open(D1) as f:
        raw = json.load(f)
    snap = _snapshot(3, "client", collective=False)
    model = whatif.calibrate_from_snapshot(
        snap, whatif.steps_info_from_config(raw), wall_s=1.0,
        arrival_hz=whatif.arrival_hz_from_snapshot(snap))
    base = model.predict_throughput()
    for degree in (1, 2, 4, 8):
        assert model.predict_throughput(
            {"shard_degree": {"step1": degree}}) == base


# -- served job directories --------------------------------------------------

LS = (1, 1, 1, 1)
CLASSES = 10


def _dataset(root, videos=4, frames=40):
    rng = np.random.default_rng(0)
    for i in range(videos):
        label = os.path.join(root, "label%d" % (i % 2))
        os.makedirs(label, exist_ok=True)
        write_y4m(os.path.join(label, "v%02d.y4m" % i),
                  rng.integers(0, 256, (frames, 112, 112, 3),
                               dtype=np.uint8), colorspace="420")
    return root


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Reduced copies of the shipped shard pair with the root ``whatif``
    key, served by the port on the CPU: d2 in bulk and under Poisson
    arrivals, d1 in bulk."""
    from rnb_tpu_torch.benchmark import run_benchmark
    tmp = str(tmp_path_factory.mktemp("whatif"))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RNB_TPU_DATA_ROOT", _dataset(os.path.join(tmp, "data")))
        for name, path, interval in (("d1", D1, 0), ("d2", D2, 0),
                                     ("d2-poisson", D2, 15)):
            with open(path) as f:
                raw = json.load(f)
            raw["whatif"] = {"enabled": True}
            raw["ragged"]["pool_rows"] = 3
            loader, runner = raw["pipeline"]
            loader.update(max_clips=3, row_buckets=[1, 3], fuse=3)
            runner.update(max_rows=3, row_buckets=[1, 3],
                          layer_sizes=list(LS), num_classes=CLASSES)
            config = os.path.join(tmp, name + ".json")
            with open(config, "w") as f:
                json.dump(raw, f)
            result = run_benchmark(
                config, mean_interval_ms=interval, num_videos=8,
                log_base=os.path.join(tmp, "logs-" + name),
                print_progress=False, seed=0, platform="cpu")
            assert result.termination_flag == 0
            runs[name] = result
    return runs


@pytest.mark.parametrize("name", ["d1", "d2", "d2-poisson"])
def test_a_served_job_calibrates_as_the_reference(served, name):
    result = served[name]
    ours = whatif.calibrate_job(result.log_dir)
    theirs = jax_whatif.calibrate_job(result.log_dir)
    assert ours.calibrated and theirs.calibrated
    _close(_answers(whatif, ours), _answers(jax_whatif, theirs))
    # the in-run line is the offline recompute, and the logs check
    assert (result.whatif_stages, result.whatif_calibrated,
            result.whatif_bottleneck_step) == (
        len(ours.stages), 1, whatif.summary_counters(ours)["bottleneck_step"])
    assert abs(result.whatif_pred_vps_milli
               - whatif.summary_counters(ours)["pred_vps_milli"]) <= 1
    assert summarize(result.log_dir)["footing_problems"] == []


def test_the_d2_job_rescales_its_measured_collective(served):
    """The degree-2 job measured its merge (``exec1.collective``): a
    degree-1 query removes it, a degree-4 query scales it by g(4)/g(2),
    in both packages alike; the degree-1 job has nothing to rescale."""
    d2 = whatif.calibrate_job(served["d2"].log_dir)
    stage = d2.stages[-1]
    assert stage.shard_degree == 2 and stage.collective_ms > 0
    base = d2.predict_throughput()[0]
    assert d2.predict_throughput({"shard_degree": {"step1": 1}})[0] > base
    assert d2.predict_throughput({"shard_degree": {"step1": 4}})[0] < base
    d1 = whatif.calibrate_job(served["d1"].log_dir)
    assert d1.stages[-1].collective_ms == 0.0
    assert d1.predict_throughput({"shard_degree": {"step1": 2}}) \
        == d1.predict_throughput()


def test_the_job_config_is_the_copy_in_the_job_directory(served):
    for result in served.values():
        raw = whatif.job_config(result.log_dir)
        assert raw == jax_whatif.job_config(result.log_dir)
        assert raw["whatif"] == {"enabled": True}


@pytest.mark.parametrize("name", ["d1", "d2", "d2-poisson"])
def test_both_check_jobs_pass_the_whatif_job_dirs(served, name):
    assert_both_checks_pass(served[name].log_dir)
