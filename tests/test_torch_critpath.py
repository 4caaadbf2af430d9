"""The port's critical-path extraction (``rnb_tpu_torch.critpath``) held
to the JAX package's.

The same seeded stamp dicts (numpy) — a loader and runner card with and
without the trace-mode refinement stamps, three-segment cards merged by
each package's own ``TimeCard.merge`` (``-{sub_id}`` suffixed stamps),
stamps the classifier does not know, and NaN holes — go through both
packages' ``classify_gap``, ``blocking_chain``, ``chain_totals``,
``aggregate``, ``ranking``, ``trailer_totals`` and ``rank_ring_events``
(on seeded flight-ring events) and come out equal. The chains partition
each request's end-to-end span, and the port's ``CritpathSettings``
read the configs the reference's read.
"""

import numpy as np
import pytest

from rnb_tpu import critpath as jax_critpath
from rnb_tpu import telemetry as jax_telemetry
from rnb_tpu_torch import critpath
from rnb_tpu_torch import telemetry as port_telemetry

#: one request's stamps through the loader (refined) and a runner
PLAIN_KEYS = ("enqueue_filename", "runner0_start", "inference0_start",
              "decode0_done", "transfer0_start", "transfer0_done",
              "inference0_finish", "runner1_start", "inference1_start",
              "inference1_finish")


def _plain(seed, refined=True, odd=False):
    rng = np.random.default_rng(seed)
    keys = [k for k in PLAIN_KEYS
            if refined or not k.startswith(("decode", "transfer"))]
    if odd:
        keys.insert(3, "mystery_stamp")
    at = 1.7e9 + np.cumsum(rng.exponential(0.004, len(keys)))
    if odd:
        rng.shuffle(at[1:-1])  # out-of-order stamps sort into place
    return dict(zip(keys, at.tolist()))


def _merged(seed, module):
    """A card forked into three segments after the loader and merged back
    by ``module``'s TimeCard (sibling stamps interleave in time)."""
    rng = np.random.default_rng(seed)
    card = module.TimeCard(seed)
    t = 1.7e9
    for key in PLAIN_KEYS[:7]:
        t += float(rng.exponential(0.003))
        card.record(key, at=t)
    kids = [card.fork(i) for i in range(3)]
    for kid in kids:
        s = t
        for key in ("runner1_start", "inference1_start",
                    "inference1_finish", "runner2_start",
                    "inference2_start"):
            s += float(rng.exponential(0.005))
            kid.record(key, at=s)
    merged = module.TimeCard.merge(kids)
    merged.record("inference2_finish",
                  at=max(merged.timings.values()) + 0.001)
    return dict(merged.timings)


def _cases():
    cases = [_plain(s) for s in range(4)]
    cases += [_plain(10 + s, refined=False) for s in range(3)]
    cases += [_plain(20 + s, odd=True) for s in range(3)]
    holes = _plain(30)
    holes["transfer0_start"] = float("nan")
    cases.append(holes)
    return cases


MERGED_SEEDS = (40, 41, 42)


@pytest.mark.parametrize("idx", range(11))
def test_chains_equal_the_reference_and_partition(idx):
    timings = _cases()[idx]
    chain = critpath.blocking_chain(timings)
    assert chain == jax_critpath.blocking_chain(timings)
    assert critpath.chain_totals(timings) == \
        jax_critpath.chain_totals(timings)
    finite = [t for t in timings.values() if t == t]
    assert abs(sum(ms for _c, _s, ms in chain)
               - (max(finite) - min(finite)) * 1e3) < 1e-6


@pytest.mark.parametrize("seed", MERGED_SEEDS)
def test_merged_segment_chains_equal_the_reference(seed):
    timings = _merged(seed, port_telemetry)
    assert timings == _merged(seed, jax_telemetry)
    assert any(k.endswith("-2") for k in timings)
    chain = critpath.blocking_chain(timings)
    assert chain == jax_critpath.blocking_chain(timings)
    assert {step for _c, step, _ms in chain} >= {0, 1, 2}


def test_classify_gap_equals_the_reference_on_every_key_pair():
    keys = set()
    for timings in _cases() + [_merged(s, port_telemetry)
                               for s in MERGED_SEEDS]:
        keys.update(timings)
    keys.update(("runner12_start", "inference3_finish-11", "decode2_done",
                 "transfer-1", "inference_finish", ""))
    for prev in sorted(keys):
        for nxt in sorted(keys):
            assert critpath.classify_gap(prev, nxt) == \
                jax_critpath.classify_gap(prev, nxt), (prev, nxt)


def test_aggregate_ranking_and_trailer_equal_the_reference():
    rng = np.random.default_rng(7)
    timings = _cases() + [_merged(s, port_telemetry) for s in MERGED_SEEDS]
    rows = [(t, bool(rng.integers(0, 2)), int(rng.integers(0, 3)))
            for t in timings]
    lanes = {0: 1, 1: 3, 2: 1}
    report = critpath.aggregate(rows, lanes)
    assert report == jax_critpath.aggregate(rows, lanes)
    assert report["requests"] == len(rows)
    assert report["bound_step"] in lanes
    ranked = critpath.ranking(report["stage_detail"])
    assert ranked == jax_critpath.ranking(report["stage_detail"])
    assert [r[1] for r in ranked] == sorted((r[1] for r in ranked),
                                            reverse=True)
    assert critpath.trailer_totals(timings) == \
        jax_critpath.trailer_totals(timings)
    assert critpath.aggregate([({"enqueue_filename": 1.0}, False, 0)],
                              lanes) is None


def test_rank_ring_events_equals_the_reference():
    rng = np.random.default_rng(8)
    names = ("exec1.model_call", "loader.emit", "exec0.queue_get",
             "batcher.emit")
    events = [(names[int(rng.integers(0, 4))],
               "X" if rng.random() < 0.8 else "i",
               1.7e9 + i * 0.001, float(rng.exponential(0.002)),
               "runner-s1-g0-i0", None, None) for i in range(300)]
    for top in (2, 12):
        ranked = critpath.rank_ring_events(events, top=top)
        assert ranked == jax_critpath.rank_ring_events(events, top=top)
        assert len(ranked) == min(top, 4)


@pytest.mark.parametrize("raw", [None, {}, {"enabled": True},
                                 {"enabled": False}])
def test_settings_from_config_equal_the_reference(raw):
    got = critpath.CritpathSettings.from_config(raw)
    want = jax_critpath.CritpathSettings.from_config(raw)
    assert (got is None) == (want is None)
    assert got is None or got.enabled == want.enabled
