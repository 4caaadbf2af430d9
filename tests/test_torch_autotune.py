"""The port's load-adaptive batching controller (``rnb_tpu_torch.autotune``)
held to the JAX package's.

A seeded stamp stream (numpy) — client enqueue instants, rows per
request, service spans per bucket, and decision queries at seeded
accumulator states — goes through both packages' ``BatchController``
and gives the same ``Decision`` sequence and the same ``snapshot()``;
``aggregate_snapshots`` agrees; ``AutotuneSettings.from_config`` and
``for_stage`` accept and refuse the same inputs with the same messages;
no decision names a bucket outside the warmed set. The port's Batcher
under autotune, fed the same requests on the same (patched) monotonic
clock as the JAX Batcher, emits at the same calls with the same row
counts and buckets and ends with the same controller snapshot.
"""

import time

import numpy as np
import pytest
import torch

from rnb_tpu import autotune as jax_autotune
from rnb_tpu import stage as jax_stage
from rnb_tpu import telemetry as jax_telemetry
from rnb_tpu.batcher import Batcher as JaxBatcher
from rnb_tpu_torch import autotune
from rnb_tpu_torch import telemetry as port_telemetry
from rnb_tpu_torch.batcher import Batcher
from rnb_tpu_torch.devices import DeviceSpec
from rnb_tpu_torch.stage import PaddedBatch

SETTINGS = (
    {"enabled": True, "slo_ms": 50.0},
    {"slo_ms": 20.0, "ewma_alpha": 0.5, "min_hold_ms": 2.0,
     "max_hold_ms": 10.0},
    {"slo_ms": 80.0, "buckets": [6]},
    {"slo_ms": 5.0, "ewma_alpha": 1.0, "min_hold_ms": 0.0},
)
WARMED = (1, 3, 6, 15)


def _drive(module, raw, seed):
    """Feed a seeded stamp stream to one package's controller; the
    decisions and peeks it gave, and its final snapshot."""
    settings = module.AutotuneSettings.from_config(raw)
    ctl = module.BatchController.for_stage(settings, WARMED, 15)
    rng = np.random.default_rng(seed)
    t, out = 1.7e9, []
    for _ in range(300):
        op = int(rng.integers(0, 6))
        if op == 0:
            t += float(rng.exponential(0.004))
            # an out-of-order stamp now and then (a fused upstream)
            ctl.observe_enqueue(t - (0.01 if rng.random() < 0.1 else 0.0))
        elif op == 1:
            ctl.observe_rows(float(rng.integers(1, 16)) / rng.integers(1, 3))
        elif op == 2:
            ctl.observe_service(int(rng.choice(WARMED)),
                                float(rng.exponential(0.01)))
        elif op in (3, 4):
            rows = int(rng.integers(0, 16))
            ask = ctl.decide if op == 3 else ctl.peek
            dec = ask(int(rng.integers(1, 6)), rows,
                      float(rng.exponential(0.02)))
            out.append((op, dec.target_rows, dec.hold_s, dec.bucket,
                        dec.immediate))
        else:
            ctl.note_emission(int(rng.choice(ctl.candidates)))
    return out, ctl.snapshot(), ctl.candidates


@pytest.mark.parametrize("case", range(len(SETTINGS)))
@pytest.mark.parametrize("seed", [0, 1])
def test_decisions_and_snapshot_equal_the_reference(case, seed):
    got = _drive(autotune, SETTINGS[case], seed)
    assert got == _drive(jax_autotune, SETTINGS[case], seed)
    decisions, snap, candidates = got
    # every decision stays inside the warmed candidate set
    for _op, target, _hold, bucket, _imm in decisions:
        assert target in candidates and bucket in candidates
    assert snap["immediate"] + snap["held"] == snap["decisions"]
    assert set(int(b) for b in snap["bucket_counts"]) <= set(candidates)


def test_aggregate_snapshots_equals_the_reference():
    snaps = [_drive(autotune, SETTINGS[i], 3)[1] for i in range(4)]
    snaps.append(autotune.BatchController.for_stage(
        autotune.AutotuneSettings.from_config({"enabled": True}), WARMED,
        15).snapshot())
    assert autotune.aggregate_snapshots(snaps) == \
        jax_autotune.aggregate_snapshots(snaps)


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("raw", [
    None, {}, {"enabled": False}, {"slo_ms": 10},
    {"min_hold_ms": 70.0}, {"min_hold_ms": 5.0, "max_hold_ms": 1.0},
    {"buckets": [15, 6, 1]}, {"buckets": []}])
def test_settings_from_config_equal_the_reference(raw):
    got = _outcome(lambda: autotune.AutotuneSettings.from_config(raw))
    want = _outcome(lambda: jax_autotune.AutotuneSettings.from_config(raw))
    if got[0] == "ok" and got[1] is not None:
        got = ("ok", tuple(vars(got[1]).items()))
        want = ("ok", tuple(vars(want[1]).items()))
    assert got == want


@pytest.mark.parametrize("buckets,warmed", [
    ([6, 15], (6, 15)), ([7], (6, 15)), ([1, 6], (6, 15)), (None, ()),
    (None, (3,))])
def test_for_stage_refuses_what_the_reference_refuses(buckets, warmed):
    raw = {"buckets": buckets} if buckets else {"enabled": True}

    def build(module):
        settings = module.AutotuneSettings.from_config(raw)
        return module.BatchController.for_stage(settings, warmed,
                                                15).candidates
    assert _outcome(lambda: build(autotune)) == \
        _outcome(lambda: build(jax_autotune))


def _batcher_run(port: bool, seed: int, monkeypatch):
    """Requests of seeded sizes into a Batcher with a controller, on a
    monotonic clock the test advances; what each call emitted."""
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    settings_mod = autotune if port else jax_autotune
    cls = Batcher if port else JaxBatcher
    device = DeviceSpec(0, "cpu") if port else None
    batcher = cls(device, batch=4, max_rows=6, consecutive_frames=1,
                  frame_hw=2, row_buckets=[2, 4, 6])
    ctl = batcher.enable_autotune(settings_mod.AutotuneSettings.from_config(
        {"slo_ms": 30.0, "min_hold_ms": 1.0}))
    rng = np.random.default_rng(seed)
    t_enq, emitted = 1.7e9, []
    for rid in range(40):
        step = float(rng.exponential(0.006))
        clock[0] += step
        t_enq += step
        rows = int(rng.integers(1, 3))
        data = np.zeros((6, 1, 2, 2, 3), np.uint8)
        card = (port_telemetry if port else jax_telemetry).TimeCard(rid)
        card.record("enqueue_filename", at=t_enq)
        ctl.observe_enqueue(t_enq)
        payload = (PaddedBatch(torch.from_numpy(data), rows) if port
                   else jax_stage.PaddedBatch(data, rows),)
        out = batcher(payload, None, card)
        if out[2] is None and rng.random() < 0.5:
            clock[0] += float(rng.exponential(0.01))
            out = batcher.poll() or (None, None, None)
        if out[2] is not None:
            (pb,) = out[0]
            emitted.append((rid, int(pb.valid), int(pb.data.shape[0]),
                            len(out[2])))
            ctl.observe_service(int(pb.data.shape[0]),
                                float(rng.exponential(0.004)))
    return emitted, ctl.snapshot()


@pytest.mark.parametrize("seed", [0, 1])
def test_batcher_under_autotune_emits_as_the_reference(seed, monkeypatch):
    got = _batcher_run(True, seed, monkeypatch)
    assert got == _batcher_run(False, seed, monkeypatch)
    emitted, snap = got
    assert emitted and snap["emissions"] == len(emitted)
    assert all(shipped in (2, 4, 6) for _r, _v, shipped, _n in emitted)
    assert 0 < snap["held"] and 0 < snap["immediate"]


def test_batcher_without_autotune_keeps_the_static_rule():
    batcher = Batcher(DeviceSpec(0, "cpu"), batch=3, max_rows=6,
                      consecutive_frames=1, frame_hw=2)
    assert batcher.next_deadline_s() is None and batcher.poll() is None
    for rid in range(2):
        out = batcher((PaddedBatch(torch.zeros(6, 1, 2, 2, 3,
                                               dtype=torch.uint8), 1),),
                      None, port_telemetry.TimeCard(rid))
        assert out == (None, None, None)
    assert batcher.next_deadline_s() is None and batcher.poll() is None


def test_an_untraced_batcher_emission_builds_no_trace_args(monkeypatch):
    from rnb_tpu_torch import trace
    calls = []
    monkeypatch.setattr(trace, "instant",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(trace, "ACTIVE", None)
    batcher = Batcher(DeviceSpec(0, "cpu"), batch=2, max_rows=6,
                      consecutive_frames=1, frame_hw=2)
    for rid in range(2):
        out = batcher((PaddedBatch(torch.zeros(6, 1, 2, 2, 3,
                                               dtype=torch.uint8), 1),),
                      None, port_telemetry.TimeCard(rid))
    assert out[2] is not None and calls == []
    # with a collector installed the emission is marked, as in the
    # reference
    monkeypatch.setattr(trace, "ACTIVE", object())
    for rid in range(2, 4):
        out = batcher((PaddedBatch(torch.zeros(6, 1, 2, 2, 3,
                                               dtype=torch.uint8), 1),),
                      None, port_telemetry.TimeCard(rid))
    assert calls == [(("batcher.emit",),
                      {"args": {"requests": 2, "rows": 2}})]


def _autotune_meta(tmp_path, ragged=False, **line):
    """A log-meta reading of an autotune run over a bucketed (or ragged)
    copy of the shipped config, with ``line`` overriding its counters."""
    import json
    import os
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))),
            "configs/rnb-fused-yuv-autotune.json")) as f:
        raw = json.load(f)
    config = tmp_path / "autotune.json"
    config.write_text(json.dumps(raw))
    counters = dict(decisions=10, immediate=4, held=6, emissions=8,
                    deadline_us_min=1000, deadline_us_max=3000,
                    deadline_us_sum=12000)
    counters.update(line)
    meta = {"args": {"config": str(config)},
            "lines": {"Autotune": counters},
            "autotune_buckets": {"6": 5, "15": 3},
            "staging": [{"staged_batches": 7, "copied_batches": 1}]}
    if ragged:
        meta["lines"]["Ragged"] = {"pool_rows": 15}
        meta["autotune_buckets"] = {"4": 5, "11": 3}
    return meta


@pytest.mark.parametrize("case,problem", [
    ("clean", None),
    ("ragged", None),
    ("verdicts", "immediate + held != decisions"),
    ("uncovered", "emissions exceed decisions"),
    ("buckets", "buckets sum to 8, emissions=7"),
    ("deadlines", "held deadlines min/max/sum disagree"),
    ("unwarmed", "bucket(s) ['12'] the config never warms"),
    ("pool", "bucket(s) ['16'] the config never warms"),
    ("loader", "emissions=8 but the loaders shipped 9"),
])
def test_parse_utils_holds_the_autotune_line(tmp_path, case, problem):
    from rnb_tpu_torch.parse_utils import autotune_problems
    meta = _autotune_meta(tmp_path, ragged=case in ("ragged", "pool"))
    if case == "verdicts":
        meta["lines"]["Autotune"]["held"] = 5
    elif case == "uncovered":
        meta["lines"]["Autotune"].update(emissions=11)
        meta["autotune_buckets"]["6"] = 8
    elif case == "buckets":
        meta["lines"]["Autotune"]["emissions"] = 7
        meta["staging"][0]["copied_batches"] = 0
    elif case == "deadlines":
        meta["lines"]["Autotune"]["deadline_us_sum"] = 20000
    elif case == "unwarmed":
        meta["autotune_buckets"] = {"6": 5, "12": 3}
    elif case == "pool":
        meta["autotune_buckets"] = {"4": 5, "16": 3}
    elif case == "loader":
        meta["staging"][0]["copied_batches"] = 2
    problems = autotune_problems(meta)
    if problem is None:
        assert problems == []
    else:
        assert any(problem in p for p in problems), problems
