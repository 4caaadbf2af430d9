"""Replica lanes (config expansion, ``ReplicaSelector``, placement, lane
health and hedging in the executor) against the JAX package's, on the
CPU.

Units: ``carve_replicas``; the three ``rnb-scaleout-*`` configs parse to
the reference's lane structure (lane queues, devices, the selector
swapped in, ``hedge_ms``); bad ``replicas``, ``hedge_ms``, ``handoff``
and ``placement`` values are refused with the reference's messages;
``ReplicaSelector`` routes the reference's way over a seeded sequence of
depths and lane evictions, and a hedge's or a dead lane's sibling is
picked the reference's way over seeded depths and lane states; ``recommend``, ``recommend_joint`` and
``build_report`` equal the reference's to the digit on seeded costs.

End to end, reduced copies of the three configs, every device index
made 0 (so the lanes share the CPU): the shipped geometry (2-frame
clips, up to 3 a request, layers (1, 1, 1, 1), 8 classes, ragged pools
of 3, fuse 1) with the r1 and r4 copies' emulated step-1 service cut
from 2000 ms to 200 ms; the chaos copy as shipped (300 ms, lane 3
wedged 2.5 s then killed) at 12 requests and at 48, which outlast the
wedge. Every served request's logits are within 2% of the logit scale
of the JAX stages' on the same parameters (``from_jax_variables``).
The r1 and r4 copies end at their target with every edge take
device-resident (0 host bytes), r4 on four lanes; the chaos copies meet
``scripts/chaos_demo.py``'s contract as far as their request count lets
them: every request ends once, every dead letter is the plan's, lane 3
evicted by a legal path, no route to an open lane, every hedge resolved
once, and at 48 requests lane 3's queued work redispatched. Both
packages' ``check_job`` pass the job directories (the reference's reads
them without the port's ``Device:`` line, whose one-word CPU value its
reader takes for the window's timestamps) and both catch a cooked
``Handoff:``, ``Placement:``, ``Health lanes:`` and ``Hedge:`` line.
"""

import copy
import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnb_tpu import config as jax_config
from rnb_tpu import placement as jax_placement
from rnb_tpu import selector as jax_selector
from rnb_tpu.decode import get_decoder as jax_get_decoder
from rnb_tpu.health import HealthSettings as JaxHealthSettings
from rnb_tpu.health import LaneHealthBoard as JaxLaneHealthBoard
from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.models.r2p1d.model import _shared_apply
from rnb_tpu.models.r2p1d.sampler import R2P1DSampler as JaxSampler
from rnb_tpu.ops.preprocess import normalize_u8_reference
from rnb_tpu.parallel.mesh import carve_replicas as jax_carve_replicas
from rnb_tpu_torch import placement, selector
from rnb_tpu_torch.benchmark import run_benchmark
from rnb_tpu_torch.config import ConfigError, parse_config
from rnb_tpu_torch.health import HealthSettings, LaneHealthBoard, legal_path
from rnb_tpu_torch.models.r2p1d import model as port_model
from rnb_tpu_torch.models.r2p1d.checkpoint import (filter_layer_range,
                                                   from_jax_variables)
from rnb_tpu_torch.models.r2p1d.network import (R2Plus1DClassifier,
                                                cast_compute_weights)
from rnb_tpu_torch.parallel.mesh import carve_replicas
from rnb_tpu_torch.parse_utils import check_job

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import parse_utils as jax_parse_utils  # noqa: E402

R1, R4, CHAOS = ("configs/rnb-scaleout-r1.json", "configs/rnb-scaleout-r4.json",
                 "configs/rnb-scaleout-r4-chaos.json")
SCALEOUT = (R1, R4, CHAOS)
LS = (1, 1, 1, 1)
CLASSES = 8
FRAMES = 2
POOL_ROWS = 3
#: the reduced r1 and r4 copies' emulated step-1 service
REDUCED_MS = 200
REQUESTS = 12
DRAIN_REQUESTS = 48
DEAD_LANE = "3"
#: the lane states a board reports
STATES = ("healthy", "suspect", "open", "half_open", "evicted")


def _raw(path):
    with open(os.path.join(REPO, path)) as f:
        return json.load(f)


# -- units --------------------------------------------------------------------

@pytest.mark.parametrize("devices,replicas", [
    ([1, 2, 3, 4], 4), ([1, 2, 3, 4], 2), ([1, 2, 3, 4], 1), ([0, 0, 0, 0], 4),
    ([5, 6, 7, 8, 9, 10], 3), ([1, 2, 3], 2), ([1, 2], 0), ([], 1)])
def test_carve_replicas_is_the_reference_s(devices, replicas):
    try:
        want = jax_carve_replicas(devices, replicas)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            carve_replicas(devices, replicas)
        assert str(got.value) == str(e)
        return
    assert carve_replicas(devices, replicas) == want


def _structure(config):
    steps = []
    for step in config.steps:
        groups = [(tuple(d.spec for d in g.devices), g.in_queue,
                   tuple(g.out_queues), g.queue_selector.rpartition(".")[2])
                  for g in step.groups]
        steps.append((step.model.rpartition(".")[2], groups,
                      step.replica_queues, step.hedge_ms))
    return steps


@pytest.mark.parametrize("path", SCALEOUT)
def test_the_scaleout_configs_parse_to_the_reference_s_lanes(path):
    raw = _raw(path)
    ours = parse_config(copy.deepcopy(raw), platform="cpu")
    theirs = jax_config.parse_config(copy.deepcopy(raw))
    assert _structure(ours) == _structure(theirs)
    assert ours.handoff == theirs.handoff == {"mode": "device"}
    assert ours.placement == theirs.placement
    lanes = 1 if path == R1 else 4
    assert len(ours.steps[1].groups) == lanes
    if lanes > 1:
        assert ours.steps[1].replica_queues == (1, 2, 3, 4)
        assert ours.steps[0].groups[0].queue_selector == \
            "rnb_tpu_torch.selector.ReplicaSelector"
    # the as-written dict is never changed by the expansion
    assert ours.raw == raw


@pytest.mark.parametrize("replicas,degree", [(2, 2), (4, 1), (1, 4)])
def test_lanes_compose_with_shard_replica_major(replicas, degree):
    """Each lane's slice of the step's devices becomes its shard ring,
    as in the reference."""
    raw = _raw(R4)
    raw.pop("placement")
    runner = raw["pipeline"][1]
    runner["replicas"] = replicas
    runner["shard"] = {"degree": degree}
    ours = parse_config(copy.deepcopy(raw), platform="cpu")
    theirs = jax_config.parse_config(copy.deepcopy(raw))
    assert _structure(ours) == _structure(theirs)
    assert [[d.spec for d in g.kwargs["shard_devices"]]
            for g in ours.steps[1].groups] == \
        [list(g.extras["shard_devices"]) for g in theirs.steps[1].groups]
    assert len(ours.steps[1].groups) == replicas


def _mutate(case):
    raw = _raw(CHAOS if case[0] == "hedge" else R4)
    runner = raw["pipeline"][1]
    kind, value = case
    if kind == "replicas":
        runner["replicas"] = value
    elif kind == "replicas-step0":
        raw["pipeline"][0]["replicas"] = value
    elif kind == "replicas-segments":
        runner["replicas"] = value
        runner["num_segments"] = 2
    elif kind == "replicas-two-groups":
        runner["replicas"] = value
        runner["queue_groups"].append({"devices": [5], "in_queue": 0})
    elif kind == "hedge":
        runner["hedge_ms"] = value
    elif kind == "hedge-no-lanes":
        runner["hedge_ms"] = value
        raw.pop("placement")
    elif kind in ("handoff", "placement"):
        raw[kind] = value
    return raw


BAD = [("replicas", 0), ("replicas", -2), ("replicas", 1.5),
       ("replicas", True), ("replicas", "4"), ("replicas", 3),
       ("replicas-step0", 2), ("replicas-segments", 2),
       ("replicas-two-groups", 2),
       ("hedge", 0), ("hedge", -5), ("hedge", "p99"), ("hedge", True),
       ("hedge-no-lanes", 5),
       ("handoff", []), ("handoff", {"mode": "dma"}),
       ("handoff", {"mode": "device", "hops": 2}),
       ("handoff", {"enabled": "yes"}),
       ("placement", {"mode": "auto"}), ("placement", {"mode": "apply"}),
       ("placement", {"mode": "apply", "plan": {"s1": 4}}),
       ("placement", {"mode": "apply", "plan": {"step9": 4}}),
       ("placement", {"mode": "apply", "plan": {"step1": 0}}),
       ("placement", {"mode": "plan", "budget": 8})]


@pytest.mark.parametrize("case", BAD, ids=["%s-%r" % c for c in BAD])
def test_bad_lane_values_are_refused_with_the_reference_s_message(case):
    with pytest.raises(jax_config.ConfigError) as theirs:
        jax_config.parse_config(_mutate(case))
    with pytest.raises(ConfigError) as ours:
        parse_config(_mutate(case), platform="cpu")
    assert str(ours.value) == str(theirs.value)


class _Depths:
    """A depth table both selectors read."""

    def __init__(self):
        self.table = {}

    def depth(self, q):
        return self.table.get(q, 0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_replica_selector_routes_the_reference_s_way(seed):
    lanes = [4, 5, 6, 7]
    rng = np.random.default_rng(seed)
    ours, theirs = (selector.ReplicaSelector(4),
                    jax_selector.ReplicaSelector(4))
    settings = dict(suspect_after_ms=1e6, open_after_ms=2e6,
                    probe_interval_ms=1e6)
    our_board = LaneHealthBoard(lanes, HealthSettings(**settings))
    their_board = JaxLaneHealthBoard(lanes, JaxHealthSettings(**settings))
    depths = _Depths()
    ours.bind_depths(depths, lanes)
    theirs.bind_depths(depths, lanes)
    ours.bind_health(our_board)
    theirs.bind_health(their_board)
    picks = []
    for step in range(60):
        depths.table = {q: int(rng.integers(0, 4)) for q in lanes}
        if step in (20, 35, 50):
            # one more lane dies; the last step leaves every lane evicted
            # but one, then all routes are forced
            lane = lanes[[20, 35, 50].index(step)]
            our_board.evict(lane, "replica-crash")
            their_board.evict(lane, "replica-crash")
        got, want = ours.select(None, None, None), theirs.select(
            None, None, None)
        assert got == want, step
        assert ours.last_route_forced == theirs.last_route_forced
        picks.append(got)
    assert our_board.snapshot() == their_board.snapshot()
    # the evicted lanes stopped receiving work the step they died
    assert 0 not in picks[20:] and 1 not in picks[35:]


class _States:
    """A lane board that only answers ``state``, from a table."""

    def __init__(self, table):
        self.table = table

    def state(self, q):
        return self.table[q]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_a_sibling_lane_is_picked_the_reference_s_way(seed):
    from rnb_tpu.runner import _pick_lane as jax_pick_lane
    lanes = [4, 5, 6, 7]
    rng = np.random.default_rng(seed)
    depths = _Depths()
    for step in range(80):
        depths.table = {q: int(rng.integers(0, 3)) for q in lanes}
        board = _States({q: STATES[int(rng.integers(0, len(STATES)))]
                         for q in lanes})
        order = [lanes[i] for i in rng.permutation(len(lanes))]
        exclude = (None, order[0])[step % 2]
        for b, d in ((board, depths), (None, depths), (board, None)):
            assert selector.pick_sibling_lane(d, b, order, exclude) == \
                jax_pick_lane(d, b, order, exclude), step


def test_an_unbound_replica_selector_is_round_robin():
    ours, theirs = selector.ReplicaSelector(3), jax_selector.ReplicaSelector(3)
    assert [ours.select(None, None, None) for _ in range(7)] == \
        [theirs.select(None, None, None) for _ in range(7)]


def _records(seed, module, sharded):
    rng = np.random.default_rng(seed)
    records = []
    for step in range(3):
        for _instance in range(int(rng.integers(1, 4))):
            kwargs = {}
            busy = float(rng.uniform(0.1, 20.0))
            if sharded and step == 1:
                kwargs = dict(shard_degree=int(rng.integers(1, 4)),
                              collective_s=busy * float(rng.uniform(0, 0.3)),
                              min_degree=int(rng.integers(1, 3)))
            records.append(module.CostRecord(step, busy,
                                             int(rng.integers(1, 200)),
                                             **kwargs))
    return records


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("sharded", [False, True])
def test_the_planner_is_the_reference_s_to_the_digit(seed, sharded):
    rng = np.random.default_rng(100 + seed)
    budget = int(rng.integers(1, 12))
    wall = float(rng.uniform(0.5, 30.0))
    ours = placement.build_report(_records(seed, placement, sharded), wall,
                                  budget, "plan")
    theirs = jax_placement.build_report(_records(seed, jax_placement,
                                                 sharded), wall, budget,
                                        "plan")
    assert ours == theirs
    loads = {s: float(rng.uniform(0, 2)) for s in range(4)}
    assert placement.recommend(loads, budget) == \
        jax_placement.recommend(loads, budget)
    degrees = {s: int(rng.integers(1, 4)) for s in loads}
    coll = {s: loads[s] * float(rng.uniform(0, 0.5)) for s in loads}
    floors = {s: int(rng.integers(1, 3)) for s in loads}
    assert placement.recommend_joint(loads, budget, degrees, coll, floors) \
        == jax_placement.recommend_joint(loads, budget, degrees, coll,
                                         floors)
    for d0, d in ((1, 1), (1, 2), (2, 4), (4, 2), (3, 3)):
        assert placement.service_at_degree(0.02, 0.004, d0, d) == \
            jax_placement.service_at_degree(0.02, 0.004, d0, d)


# -- end to end ---------------------------------------------------------------

def _one_card(path, tmp, name, latency_ms=None):
    """A reduced copy: every device index made 0 and, for r1/r4, the
    emulated step-1 service cut to ``latency_ms``."""
    raw = _raw(path)
    for step in raw["pipeline"]:
        for group in step["queue_groups"]:
            group["devices"] = [0 for _ in group["devices"]]
    if latency_ms is not None:
        for fault in raw["fault_plan"]["faults"]:
            if fault["kind"] == "latency":
                fault["ms"] = latency_ms
    out = os.path.join(tmp, name + ".json")
    with open(out, "w") as f:
        json.dump(raw, f)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reduced r1, r4 and chaos copies, served once on the seeded
    JAX weights."""
    weights = jax_ckpt.load_or_init(1, 5, CLASSES, LS, None)
    state = from_jax_variables(weights)

    def shared_network(start, end, num_classes, layer_sizes, device,
                       dtype=torch.bfloat16, factored_shortcut=False,
                       shards=1):
        net = R2Plus1DClassifier(start, end, num_classes, layer_sizes,
                                 factored_shortcut, dtype=dtype)
        net.load_state_dict(filter_layer_range(state, start, end),
                            strict=True)
        return cast_compute_weights(net).to(device).eval()

    tmp = str(tmp_path_factory.mktemp("replicas"))
    out = {"weights": weights}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_model, "shared_network", shared_network)
        # synth:// ids, as the reference's demos serve them
        mp.delenv("RNB_TPU_DATA_ROOT", raising=False)
        mp.delenv("RNB_FAULT_PLAN", raising=False)
        for label, path, latency, videos in (
                ("r1", R1, REDUCED_MS, REQUESTS),
                ("r4", R4, REDUCED_MS, REQUESTS),
                ("chaos", CHAOS, None, REQUESTS),
                ("drain", CHAOS, None, DRAIN_REQUESTS)):
            config = _one_card(path, tmp, label, latency)
            sink = {}
            result = run_benchmark(config, mean_interval_ms=0,
                                   num_videos=videos, queue_size=64,
                                   log_base=os.path.join(tmp, "logs", label),
                                   print_progress=False, seed=17,
                                   platform="cpu", outputs_sink=sink)
            out[label] = (result, sink, videos)
    return out


def _jax_logits(weights, video, n):
    """The JAX stages' logits for one served request of the rgb path."""
    decoder = jax_get_decoder(video)
    starts = JaxSampler(consecutive_frames=FRAMES,
                        num_clips_population=[1, 2, 3],
                        weights=[2, 1, 1]).sample(
        decoder.num_frames(video), video_id=video)[:POOL_ROWS]
    rows = np.asarray(decoder.decode_clips(video, starts, FRAMES, 112, 112))
    assert len(rows) == n
    pool = np.zeros((POOL_ROWS,) + rows.shape[1:], np.uint8)
    pool[:n] = rows
    apply = _shared_apply(1, 5, CLASSES, LS)
    return np.asarray(apply(weights, normalize_u8_reference(
        jnp.asarray(pool))))[:n]


@pytest.mark.parametrize("label", ["r1", "r4", "chaos", "drain"])
def test_the_lanes_serve_the_jax_logits(runs, label):
    result, sink, _videos = runs[label]
    assert sink and len(sink) == result.num_completed
    for rid, (video, logits, _stamps) in sorted(sink.items())[:16]:
        want = _jax_logits(runs["weights"], video, len(logits))
        bound = 0.02 * float(np.abs(want).max())
        assert logits.shape == want.shape
        assert np.abs(logits - want).max() <= bound, (label, rid)


@pytest.mark.parametrize("label", ["r1", "r4"])
def test_the_scaleout_copies_end_on_device_resident_edges(runs, label):
    result, sink, videos = runs[label]
    assert result.termination_flag == 0
    assert result.num_completed == videos == len(sink)
    assert result.num_failed == result.num_shed == 0
    assert result.handoff_edges == result.handoff_d2d_edges == videos
    assert result.handoff_host_edges == result.handoff_host_bytes == 0
    steps = result.placement["steps"]
    assert steps["step1"]["instances"] == (1 if label == "r1" else 4)
    assert steps["step1"]["dispatches"] == videos
    # one card (the CPU) is the budget of the run's own plan
    assert result.placement["device_budget"] == 1
    assert result.placement["mode"] == ("plan" if label == "r1" else "apply")


def test_r1_s_costs_recommend_the_lanes_r4_runs(runs):
    """The run's plan names one device a step (its budget); r1's own
    costs at the shipped r4 config's five devices name four lanes."""
    result = runs["r1"][0]
    loads = {int(k[4:]): row["rate_hz"] * row["service_ms"] / 1e3
             for k, row in result.placement["steps"].items()}
    assert placement.recommend(loads, 5)[1] >= 4
    assert jax_placement.recommend(loads, 5) == placement.recommend(loads, 5)


@pytest.mark.parametrize("label", ["chaos", "drain"])
def test_the_chaos_copy_contains_a_dead_lane(runs, label):
    result, sink, videos = runs[label]
    assert result.termination_flag == 0
    # every request ends exactly once (one request a dispatch)
    assert result.num_completed + result.num_failed + result.num_shed \
        == videos
    assert set(result.failure_reasons) <= {"chaos-lane-kill"}
    assert result.health_evictions == 1
    dead = result.health_lane_detail[DEAD_LANE]
    assert dead["state"] == "evicted" and legal_path(dead["path"])
    assert all(entry["state"] != "evicted" for lane, entry
               in result.health_lane_detail.items() if lane != DEAD_LANE)
    assert result.health_routes_after_open == 0
    assert result.hedges_won + result.hedges_lost == result.hedges_fired
    if label == "drain":
        # the run outlasts the wedge: the circuit opened while lane 3
        # was wedged, and its queued items moved to its siblings
        assert result.health_opens >= 1
        assert result.health_redispatches >= 1
        assert dead["redispatched_from"] == result.health_redispatches


def _reference_copy(log_dir, dest):
    """The job directory as the reference's reader takes it: without the
    port's ``Device:`` line (on the CPU its one-word value reads as the
    window's second timestamp there)."""
    shutil.copytree(log_dir, dest)
    path = os.path.join(dest, "log-meta.txt")
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines()
                 if not ln.startswith("Device: ")]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return dest


@pytest.mark.parametrize("label", ["r1", "r4", "chaos", "drain"])
def test_both_check_jobs_pass_the_lanes_job_dirs(runs, label, tmp_path):
    log_dir = runs[label][0].log_dir
    assert check_job(log_dir) == []
    ref = _reference_copy(log_dir, str(tmp_path / "ref"))
    assert jax_parse_utils.check_job_detail(ref) == ([], False)


def _cook(log_dir, dest, head, edit):
    """A copy of the job directory whose ``head`` line went through
    ``edit``."""
    _reference_copy(log_dir, dest)
    path = os.path.join(dest, "log-meta.txt")
    with open(path) as f:
        lines = f.read().splitlines()
    hit = [i for i, ln in enumerate(lines) if ln.startswith(head + ": ")]
    assert hit, head
    lines[hit[0]] = head + ": " + edit(lines[hit[0]].split(": ", 1)[1])
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return dest


def _cook_placement(rest):
    report = json.loads(rest)
    report["steps"]["step1"]["occupancy"] = 0.01
    return json.dumps(report, sort_keys=True)


def _cook_lanes(rest):
    detail = json.loads(rest)
    detail[DEAD_LANE]["path"] = ["healthy", "evicted", "healthy"]
    return json.dumps(detail, sort_keys=True)


COOKED = [
    ("r4", "Handoff", lambda rest: rest.replace("host_edges=0",
                                                "host_edges=3")),
    ("r4", "Handoff", lambda rest: rest.replace("host_bytes=0",
                                                "host_bytes=512")),
    ("r1", "Placement", _cook_placement),
    ("drain", "Health lanes", _cook_lanes),
    ("drain", "Hedge", lambda rest: rest.replace("won=", "won=9")),
]


@pytest.mark.parametrize("label,head,edit", COOKED,
                         ids=["%s-%s-%d" % (c[0], c[1], i)
                              for i, c in enumerate(COOKED)])
def test_a_cooked_lane_line_fails_both_checkers(runs, label, head, edit,
                                                tmp_path):
    cooked = _cook(runs[label][0].log_dir, str(tmp_path / "cooked"), head,
                   edit)
    assert check_job(cooked)
    assert jax_parse_utils.check_job(cooked)
