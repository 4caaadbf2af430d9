"""The port's deadline layer, lane health board, hedge governor
(``rnb_tpu_torch.health``) and lock-order witness
(``rnb_tpu_torch.lockwitness``) held to the JAX package's.

The same inputs go through both packages: ``DeadlineSettings`` from a
table of raw keys, ``DeadlineStats`` over a stream of records,
``expired`` over cards (fused lists, cards without a deadline) at fixed
instants; a seeded script of board events (beats, enqueues, settles,
dead letters, routing consults, evictions) and of hedge events (track,
poll, fire, claim, discard, settle) with explicit clocks, whose
snapshots, transition paths and verdicts are equal at every step; and
the witness's twelve scenarios (the reference's ten of
``tests/test_lockwitness.py`` that need no JAX subsystem, and two of
the port's own: a three-lock chain and the deadline ledger's lock
nested under another), whose summaries are equal.
"""

import json
import threading

import numpy as np
import pytest

from rnb_tpu import health as jax_health
from rnb_tpu import lockwitness as jax_lockwitness
from rnb_tpu import telemetry as jax_telemetry
from rnb_tpu_torch import health, lockwitness
from rnb_tpu_torch import telemetry

T0 = 1000.0


# -- deadlines --------------------------------------------------------------

@pytest.mark.parametrize("raw,autotune", [
    (None, None), ({"enabled": False}, None), ({}, None),
    ({"budget_ms": 250}, None), ({}, {"slo_ms": 40}),
    ({"budget_ms": 7.5}, {"slo_ms": 40}), ({"enabled": True}, {}),
])
def test_deadline_settings_equal_the_reference(raw, autotune):
    got = health.DeadlineSettings.from_config(raw, autotune)
    want = jax_health.DeadlineSettings.from_config(raw, autotune)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.budget_ms == want.budget_ms
    assert health.DeadlineSettings.DEFAULT_BUDGET_MS == 1000.0


def test_deadline_budget_must_be_positive():
    for module in (health, jax_health):
        with pytest.raises(ValueError, match="budget_ms must be > 0"):
            module.DeadlineSettings(0)


def test_deadline_stats_equal_the_reference():
    port, ref = health.DeadlineStats(), jax_health.DeadlineStats()
    rng = np.random.default_rng(3)
    sites = ["step0_take", "step1_take", "step0_publish", "step1_hold"]
    for _ in range(200):
        where = sites[int(rng.integers(len(sites)))]
        n = int(rng.integers(1, 4))
        site = health.deadline_site(where)
        assert site == jax_health.deadline_site(where)
        port.record(site, n)
        ref.record(site, n)
        assert port.snapshot() == ref.snapshot()
    assert health.DEADLINE_SITE_SUFFIX == jax_health.DEADLINE_SITE_SUFFIX


def _cards(module, deadlines):
    cards = []
    for i, d in enumerate(deadlines):
        tc = module.TimeCard(i)
        if d is not None:
            tc.deadline_s = d
        cards.append(tc)
    return cards


@pytest.mark.parametrize("deadlines", [
    [None], [T0 - 1], [T0 + 1], [T0], [T0 - 1, T0 - 2],
    [T0 - 1, T0 + 1], [T0 - 1, None], [None, None],
])
def test_expired_equals_the_reference(deadlines):
    for fused in (False, True):
        port_cards = _cards(telemetry, deadlines)
        ref_cards = _cards(jax_telemetry, deadlines)
        if fused:
            port_item = telemetry.TimeCardList(port_cards)
            ref_item = jax_telemetry.TimeCardList(ref_cards)
        elif len(deadlines) > 1:
            continue
        else:
            port_item, ref_item = port_cards[0], ref_cards[0]
        for now in (T0 - 5, T0, T0 + 0.5, T0 + 5):
            assert health.expired(port_item, now) == \
                jax_health.expired(ref_item, now), (deadlines, now)
        assert [c.id for c in health.cards_of(port_item)] == \
            [c.id for c in jax_health.cards_of(ref_item)]


# -- the lane health board ---------------------------------------------------

def _board_script(module, seed, n_events=400):
    settings = module.HealthSettings(suspect_after_ms=50,
                                     open_after_ms=150,
                                     probe_interval_ms=80)
    board = module.LaneHealthBoard([0, 1, 2, 3], settings)
    rng = np.random.default_rng(seed)
    now = T0
    trail = []
    for _ in range(n_events):
        now += float(rng.uniform(0.0, 0.03))
        lane = int(rng.integers(4))
        event = int(rng.integers(9))
        if event == 0:
            board.beat(lane, now)
        elif event == 1:
            board.note_enqueue(lane, now)
        elif event == 2:
            board.note_settle(lane, int(rng.integers(1, 3)))
        elif event == 3:
            board.note_failure(lane)
        elif event == 4:
            allowed, probe = board.route_filter([0, 1, 2, 3], now)
            trail.append(("route", allowed, probe))
            target = probe if probe is not None else (
                allowed[0] if allowed else lane)
            board.note_route(target, forced=not allowed and probe is None)
        elif event == 5:
            trail.append(("consult", board.consult_and_route(lane, now)))
        elif event == 6 and rng.random() < 0.05:
            board.evict(lane, "injected")
            board.note_redispatch(lane, int(rng.integers(0, 3)))
        elif event == 7:
            board.note_route(lane)
        else:
            trail.append(("state", board.state(lane)))
        trail.append(board.snapshot())
    for q in range(4):
        board.register_instance(q)
    trail.append([board.instance_died(q) for q in (0, 0, 1)])
    for q in (0, 1, 2):
        board.note_drained(q)
    trail.append(board.all_drained())
    board.note_drained(3)
    trail.append(board.all_drained())
    return trail, board.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_board_walks_as_the_reference(seed):
    got_trail, got = _board_script(health, seed)
    want_trail, want = _board_script(jax_health, seed)
    assert got_trail == want_trail
    assert got == want
    assert got["transitions"] > 0
    for lane in got["lane_detail"].values():
        assert health.legal_path(lane["path"]) == \
            jax_health.legal_path(lane["path"]) is True
    both = [got, got]
    assert health.aggregate_board_snapshots(both) == \
        jax_health.aggregate_board_snapshots(both)


@pytest.mark.parametrize("path", [
    [], ["suspect"], ["healthy", "open"], ["healthy", "suspect", "open",
                                           "half_open", "healthy"],
    ["healthy", "evicted", "healthy"], ["healthy", "suspect", "evicted"],
])
def test_legal_path_equals_the_reference(path):
    assert health.legal_path(path) == jax_health.legal_path(path)


@pytest.mark.parametrize("kwargs", [
    {"suspect_after_ms": 0}, {"suspect_after_ms": 100, "open_after_ms": 50},
    {"probe_interval_ms": 0}, {},
])
def test_health_settings_equal_the_reference(kwargs):
    try:
        want = jax_health.HealthSettings(**kwargs)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            health.HealthSettings(**kwargs)
        assert str(got.value) == str(e)
        return
    raw = dict(kwargs, enabled=True)
    for got, want in ((health.HealthSettings(**kwargs), want),
                      (health.HealthSettings.from_config(raw),
                       jax_health.HealthSettings.from_config(raw))):
        assert {k: getattr(got, k) for k in got.__slots__} == \
            {k: getattr(want, k) for k in want.__slots__}


# -- hedged re-dispatch -------------------------------------------------------

def _hedge_script(module, tele, seed, hedge_ms):
    gov = module.HedgeGovernor(hedge_ms)
    rng = np.random.default_rng(seed)
    now = T0
    trail = []
    cards = {}
    for rid in range(60):
        now += float(rng.uniform(0.0, 0.02))
        tc = tele.TimeCard(rid)
        tc.record("inference1_start", at=now)
        cards[rid] = tc
        gov.track(tc, lane=rid % 3, payload=("p", rid), non_tensors=None,
                  now=now)
        for entry in gov.poll(now):
            if gov.begin_fire(entry):
                trail.append(("fired", entry.key, entry.lane))
                if rng.random() < 0.2:
                    gov.cancel_fire(entry)
                    trail.append(("cancelled", entry.key))
                    continue
                copy = entry.card
                copy.record("inference1_finish",
                            at=now + float(rng.uniform(0, 0.01)))
                verdict = gov.claim(copy, now)
                trail.append(("hedge", entry.key, verdict))
                if verdict == module.LOSER:
                    gov.discard(copy)
        for old in list(cards):
            if rng.random() < 0.3:
                tc = cards.pop(old)
                tc.record("inference1_finish", at=now)
                if rng.random() < 0.5:
                    verdict = gov.claim(tc, now)
                    trail.append(("claim", old, verdict))
                    if verdict == module.LOSER:
                        gov.discard(tc)
                else:
                    gov.settle(tc, now)
        trail.append((gov.threshold_ms(), gov.num_outstanding(),
                      gov.live_counters()))
    return trail, gov.snapshot()


@pytest.mark.parametrize("hedge_ms,seed", [(5, 0), (15, 1), ("p95x", 2),
                                           ("p95x", 3)])
def test_the_hedge_governor_resolves_as_the_reference(hedge_ms, seed):
    got_trail, got = _hedge_script(health, telemetry, seed, hedge_ms)
    want_trail, want = _hedge_script(jax_health, jax_telemetry, seed,
                                     hedge_ms)
    assert got_trail == want_trail
    assert got == want
    assert got["won"] + got["lost"] == got["fired"]
    assert any(step[0] == "fired" for step in got_trail
               if isinstance(step[0], str))
    assert health.aggregate_hedge_snapshots([got, got]) == \
        jax_health.aggregate_hedge_snapshots([want, want])


def test_clone_cards_is_the_reference_copy():
    for module, tele in ((health, telemetry), (jax_health, jax_telemetry)):
        tc = tele.TimeCard(4)
        tc.record("enqueue_filename", at=T0)
        tc.num_clips, tc.deadline_s = 3, T0 + 1
        tc.add_device("cpu:0")
        clone = module.clone_cards(tele.TimeCardList([tc]))
        (copy,) = clone.time_cards
        assert copy is not tc and copy.id == 4 and copy.hedge_copy
        assert dict(copy.timings) == dict(tc.timings)
        assert (copy.num_clips, copy.deadline_s) == (3, T0 + 1)
        assert copy.devices == tc.devices
        payload = ("x",)
        assert module.DirectPayload(payload).payload is payload


# -- the lock-order witness ---------------------------------------------------

def _disabled(w):
    w.disable()
    plain = w.lock("X._lock")
    rlock = w.lock("X.rlock", threading.RLock)
    w.require("X._lock")
    return [isinstance(plain, w.WitnessLock), type(plain).__name__,
            isinstance(rlock, w.WitnessLock), w.summary(),
            w.holds("X._lock")]


def _nested(w):
    a, b = w.lock("A._lock"), w.lock("B._lock")
    with a:
        held = w.holds("A._lock")
        with b:
            pass
    return [held]


def _inversion(w):
    a, b = w.lock("A._lock"), w.lock("B._lock")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    return []


def _release_without_hold(w):
    a = w.lock("A._lock")
    a._inner.acquire()
    a.release()
    return []


def _require(w):
    a = w.lock("A._lock")
    w.require("A._lock")
    with a:
        w.require("A._lock")
    return []


def _reentrant(w):
    r = w.lock("P.lock", threading.RLock)
    with r:
        with r:
            pass
    return []


def _condition(w):
    cond = threading.Condition(w.lock("S._lock"))
    ready = []

    def waiter():
        with cond:
            while not ready:
                cond.wait(timeout=5.0)

    t = threading.Thread(target=waiter)
    t.start()
    with cond:
        ready.append(1)
        cond.notify_all()
    t.join(timeout=5.0)
    return [t.is_alive()]


def _cross_thread(w):
    a, b = w.lock("A._lock"), w.lock("B._lock")

    def nest():
        with a:
            with b:
                pass

    threads = [threading.Thread(target=nest) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return []


def _capped(w):
    for _ in range(w.MAX_VIOLATIONS + 20):
        w.require("never.held")
    return [w.MAX_VIOLATIONS]


def _format_edges(w):
    a, b = w.lock("A._lock"), w.lock("B._lock")
    with a:
        with b:
            pass
    return [json.loads(w.format_edges(w.summary()))]


def _chain(w):
    a, b, c = (w.lock(n) for n in ("A._lock", "B._lock", "C._lock"))
    with a:
        with b:
            with c:
                pass
    with a:
        with c:
            pass
    return []


def _deadline_ledger_nested(w):
    outer = w.lock("Outer._lock")
    module = health if w is lockwitness else jax_health
    stats = module.DeadlineStats()
    with outer:
        stats.record("step1_take:deadline_expired")
    return [stats.snapshot()]


WITNESS_CASES = [_disabled, _nested, _inversion, _release_without_hold,
                 _require, _reentrant, _condition, _cross_thread, _capped,
                 _format_edges, _chain, _deadline_ledger_nested]


def _run_case(w, case):
    was_enabled = w.enabled()
    w.enable()
    w.reset()
    try:
        out = case(w)
        summary = w.summary()
        if summary is not None:
            summary = dict(summary, edges=sorted(summary["edges"]))
        return out, summary
    finally:
        w.reset()
        if was_enabled:
            w.enable()
        else:
            w.disable()


@pytest.mark.parametrize("case", WITNESS_CASES,
                         ids=[c.__name__.strip("_") for c in WITNESS_CASES])
def test_the_witness_records_what_the_reference_records(case):
    got = _run_case(lockwitness, case)
    want = _run_case(jax_lockwitness, case)
    assert got == want
    out, summary = got
    if case is _inversion:
        assert len(summary["violations"]) == 1
        assert "order inversion" in summary["violations"][0]
    if case is _chain:
        assert summary["edges"] == [("A._lock", "B._lock"),
                                    ("A._lock", "C._lock"),
                                    ("B._lock", "C._lock")]
    if case is _deadline_ledger_nested:
        assert ("Outer._lock", "DeadlineStats._lock") in summary["edges"]
