"""The edge contract (``rnb_tpu_torch/handoff.py``) against the JAX
package's (``rnb_tpu/handoff.py``), on the CPU, and what a hedge copy
reads.

Units: ``HandoffSettings``; ``EdgeHandoff`` snapshots in both modes over
seeded payloads (padded and ragged, several dtypes) equal to the
reference's, the payload adopted by reference in device mode and
bounced through host memory, byte for byte the same rows, in host mode;
``aggregate_snapshots`` and ``InflightDepths`` equal to the reference's;
the loaders' device step (``normalize_emission``) emits each payload in
memory of its own, so a rewrite of the wire rows it read leaves it as
it was.

Joint reads, end to end through the executor: a producer that writes
each request's pixels into one slot buffer, rewritten for every
emission, and emits the loaders' device step of it; two replica lanes
behind it, the first lane's every dispatch 300 ms late and a 40 ms
hedge. Ring credits come back at the take, as in the reference. Each
request's row must come out of the pipeline as it was emitted: were an
emission a view of the slot, the stalled original and its hedge copy
would read a later request's pixels.
"""

import os
import queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnb_tpu import handoff as jax_handoff
from rnb_tpu.stage import PaddedBatch as JaxPaddedBatch
from rnb_tpu.stage import RaggedBatch as JaxRaggedBatch
from rnb_tpu_torch import handoff, stage
from rnb_tpu_torch.control import (NUM_EXIT_MARKERS, EdgeTracker,
                                   InferenceCounter, RingCredits,
                                   TerminationState)
from rnb_tpu_torch.devices import DeviceSpec
from rnb_tpu_torch.faults import FaultPlan
from rnb_tpu_torch.health import HedgeGovernor
from rnb_tpu_torch import runner as runner_mod
from rnb_tpu_torch.models.r2p1d import model as port_model
from rnb_tpu_torch.ops.ragged import ragged_normalize_u8_reference
from rnb_tpu_torch.runner import RunnerContext
from rnb_tpu_torch.stage import PaddedBatch, RaggedBatch, StageModel
from rnb_tpu_torch.telemetry import TimeCard

torch.set_num_threads(2)

DTYPES = [(np.uint8, torch.uint8, jnp.uint8),
          (np.float32, torch.float32, jnp.float32),
          (np.int16, torch.int16, jnp.int16)]


def _payloads(seed, count=4):
    """Seeded payloads, each a (port, reference) pair of batch tuples."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        np_dt, torch_dt, jax_dt = DTYPES[i % len(DTYPES)]
        rows = int(rng.integers(1, 6))
        shape = (rows,) + tuple(int(d) for d in rng.integers(1, 9, 2))
        host = (rng.integers(0, 120, shape).astype(np_dt))
        valid = int(rng.integers(0, rows + 1))
        if i % 2:
            offsets = (0, valid)
            ours = (RaggedBatch(torch.from_numpy(host.copy()), valid,
                                offsets),)
            theirs = (JaxRaggedBatch(jnp.asarray(host, jax_dt), valid,
                                     offsets),)
        else:
            ours = (PaddedBatch(torch.from_numpy(host.copy()), valid),)
            theirs = (JaxPaddedBatch(jnp.asarray(host, jax_dt), valid),)
        out.append((ours, theirs, host))
    return out


@pytest.mark.parametrize("raw", [None, {}, {"enabled": False},
                                 {"mode": "device"}, {"mode": "host"},
                                 {"enabled": True}, {"mode": "dma"}])
def test_handoff_settings_are_the_reference_s(raw):
    try:
        want = jax_handoff.HandoffSettings.from_config(raw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            handoff.HandoffSettings.from_config(raw)
        assert str(got.value) == str(e)
        return
    got = handoff.HandoffSettings.from_config(raw)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.mode == want.mode


@pytest.mark.parametrize("mode", ["device", "host"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edge_snapshots_are_the_reference_s(mode, seed):
    ours = handoff.EdgeHandoff(handoff.HandoffSettings(mode),
                               DeviceSpec(0, "cpu"), "step0->step1")
    theirs = jax_handoff.EdgeHandoff(jax_handoff.HandoffSettings(mode),
                                     jax.devices("cpu")[0], "step0->step1")
    for our_payload, their_payload, host in _payloads(seed):
        taken = ours.take(our_payload)
        theirs.take(their_payload)
        (pb,), (src,) = taken, our_payload
        assert type(pb) is type(src) and pb.valid == src.valid
        assert getattr(pb, "segment_offsets", None) == getattr(
            src, "segment_offsets", None)
        if mode == "device":
            # adopted by reference: no copy
            assert pb.data is src.data
        else:
            assert pb.data.data_ptr() != src.data.data_ptr()
        np.testing.assert_array_equal(pb.data.numpy(), host)
        assert ours.resident_bytes == theirs.resident_bytes == host.nbytes
    assert ours.snapshot() == theirs.snapshot()
    snap = ours.snapshot()
    assert snap["d2d_edges" if mode == "device" else "host_edges"] == 4
    assert snap["d2d_bytes"] == 0
    if mode == "host":
        assert snap["host_bytes"] == sum(h.nbytes for _, _, h in
                                         _payloads(seed))


def test_aggregate_snapshots_are_the_reference_s():
    rng = np.random.default_rng(5)
    snaps = [{"edge": "step%d->step%d" % (e, e + 1),
              "mode": "device" if e % 2 else "host",
              **{k: int(rng.integers(0, 1000)) for k in (
                  "d2d_edges", "host_edges", "d2d_bytes", "host_bytes")}}
             for e in (0, 1, 0, 2, 1)]
    assert handoff.aggregate_snapshots(snaps) == \
        jax_handoff.aggregate_snapshots(snaps)
    assert handoff.aggregate_snapshots([]) == \
        jax_handoff.aggregate_snapshots([])


def test_inflight_depths_are_the_reference_s():
    rng = np.random.default_rng(3)
    ours, theirs = (handoff.InflightDepths([1, 2, 3]),
                    jax_handoff.InflightDepths([1, 2, 3]))
    for _ in range(200):
        q = int(rng.integers(0, 5))
        n = int(rng.integers(1, 3))
        op = ("inc", "dec")[int(rng.integers(0, 2))]
        getattr(ours, op)(q, n)
        getattr(theirs, op)(q, n)
        assert ours.depth(q) == theirs.depth(q)
    assert ours.snapshot() == theirs.snapshot()


@pytest.mark.parametrize("ragged", [False, True])
def test_an_emission_owns_its_memory(ragged):
    rng = np.random.default_rng(11)
    wire = torch.from_numpy(rng.integers(0, 256, (3, 2, 4, 4, 3))
                            .astype(np.uint8))
    first = port_model.normalize_emission("rgb", ragged, wire, 2)
    kept = first.clone()
    # the producer rewrites its slot for the next emission
    wire.copy_(torch.from_numpy(rng.integers(0, 256, (3, 2, 4, 4, 3))
                                .astype(np.uint8)))
    second = port_model.normalize_emission("rgb", ragged, wire, 3)
    assert torch.equal(first, kept)
    assert first.data_ptr() not in (wire.data_ptr(), second.data_ptr())


# -- joint reads of a hedged payload, end to end -------------------------------

ROW = 4
REQUESTS = 9
#: how long after the others the last request arrives
LATE_S = 0.7
#: the producer's one slot buffer, rewritten for every emission
SLOT = torch.zeros((1, ROW), dtype=torch.uint8)


def _emitted(rid):
    """What the loaders' device step emits for request ``rid``'s row."""
    return ragged_normalize_u8_reference(
        torch.full((1, ROW), rid, dtype=torch.uint8), 1)


class SlotProducer(StageModel):
    """Writes request k's pixels into the one slot buffer and emits the
    loaders' device step of it (rgb, ragged), as a loader emits a pool
    from its staging slot."""

    @classmethod
    def output_shape_for(cls, **kwargs):
        return ((1, ROW),)

    def __call__(self, tensors, non_tensors, time_card):
        SLOT.fill_(time_card.id)
        time_card.num_clips = 1
        return (PaddedBatch(port_model.normalize_emission(
            "rgb", True, SLOT, 1), 1),), non_tensors, time_card


class CopyStage(StageModel):
    """Reads its payload (after the fault plan's latency) into a fresh
    tensor."""

    @classmethod
    def output_shape_for(cls, **kwargs):
        return ((1, ROW),)

    def __call__(self, tensors, non_tensors, time_card):
        return (PaddedBatch(tensors[0].data.clone(), 1),), non_tensors, \
            time_card


def _serve_hedged(tmp, monkeypatch):
    """One producer with four credits, two lanes (queues 1 and 2) behind
    a 40 ms hedge, lane 1 serving every dispatch 300 ms late. Returns
    the outputs, the hedge ledger and the termination state."""
    monkeypatch.setattr(stage, "SlotProducer", SlotProducer, raising=False)
    monkeypatch.setattr(stage, "CopyStage", CopyStage, raising=False)
    lanes = [1, 2]
    filename_q = queue.Queue()
    lane_qs = {q: queue.Queue() for q in lanes}
    counter, termination = InferenceCounter(), TerminationState()
    bar = threading.Barrier(4, timeout=60)
    fin = threading.Barrier(4, timeout=60)
    depths = handoff.InflightDepths(lanes)
    governor = HedgeGovernor(40)
    plan = FaultPlan({"faults": [{"kind": "latency", "step": 1, "lane": 1,
                                  "ms": 300, "probability": 1.0}]})
    outputs, summaries = {}, []
    common = dict(job_id="hedge-reads", counter=counter,
                  num_videos=REQUESTS, termination=termination,
                  sta_bar=bar, fin_bar=fin, log_base=tmp,
                  fault_plan=plan, print_progress=False)
    contexts = [RunnerContext(
        in_queue=filename_q, out_queues=[lane_qs[q] for q in lanes],
        device=DeviceSpec(0, "cpu"), group_idx=0, instance_idx=0,
        step_idx=0,
        model_class_path="rnb_tpu_torch.stage.SlotProducer",
        queue_selector_path="rnb_tpu_torch.selector.ReplicaSelector",
        credits=RingCredits(4),
        out_trackers=[EdgeTracker(1, NUM_EXIT_MARKERS) for _ in lanes],
        out_depths=depths, out_queue_indices=lanes, out_hedges=governor,
        **common)]
    for group_idx, q in enumerate(lanes):
        contexts.append(RunnerContext(
            in_queue=lane_qs[q], out_queues=None,
            device=DeviceSpec(0, "cpu"), group_idx=group_idx,
            instance_idx=0, step_idx=1,
            model_class_path="rnb_tpu_torch.stage.CopyStage",
            summary_sink=summaries, outputs_sink=outputs, in_depths=depths,
            in_queue_idx=q, in_hedges=governor, **common))
    os.makedirs(os.path.join(tmp, "hedge-reads"), exist_ok=True)
    threads = [threading.Thread(target=runner_mod.runner, args=(ctx,),
                                daemon=True) for ctx in contexts]
    for t in threads:
        t.start()
    bar.wait()
    for rid in range(REQUESTS):
        if rid == REQUESTS - 1:
            # the last request comes late: the run outlasts the slow
            # lane's originals, whose completions must be discarded
            time.sleep(LATE_S)
        card = TimeCard(rid)
        card.record("enqueue_filename")
        filename_q.put((None, "video-%d" % rid, card, None))
    for _ in range(NUM_EXIT_MARKERS):
        filename_q.put(None)
    fin.wait()
    for t in threads:
        t.join(timeout=30)
    return outputs, governor.snapshot(), termination


def test_a_hedge_copy_reads_its_own_request_s_rows(tmp_path, monkeypatch):
    outputs, hedges, termination = _serve_hedged(str(tmp_path), monkeypatch)
    assert termination.value == 0
    # the late request was served: no loser's completion counted toward
    # the target
    assert sorted(outputs) == list(range(REQUESTS))
    # the slow lane's dispatches were hedged, and each resolved once
    assert hedges["fired"] >= 1
    assert hedges["won"] + hedges["lost"] == hedges["fired"]
    # the slot holds the last request's pixels: every earlier request's
    # copies read it after it was rewritten
    assert (SLOT == REQUESTS - 1).all()
    for rid, (_video, rows, _stamps) in sorted(outputs.items()):
        assert rows.shape == (1, ROW)
        np.testing.assert_array_equal(
            np.asarray(rows, np.float32), _emitted(rid).float().numpy(),
            err_msg=str(rid))
