"""The network edge's frame codec (``rnb_tpu_torch/ops/wire.py``) against
the JAX package's (``rnb_tpu/ops/wire.py``), on the CPU.

Both codecs are exercised over real socket pairs: the same frame fields
give the same bytes; a frame written by either package is read by the
other, for every frame type; a flipped byte is the same corrupt-frame
error carrying the frame's sequence number in both (and the connection
survives it); a frame cut short and a connection closed at a frame
boundary classify alike; the socket errors map onto the same taxonomy;
and a socket with no timeout is refused by both. DATA payloads ship only
the valid rows, in the same bytes, and re-pad with zeros on either side;
the port's DATA frames carry host rows only (a tensor off the host is
refused, not copied behind the caller's back).
"""

import json
import socket
import types

import numpy as np
import pytest
import torch

from rnb_tpu import faults as jax_faults
from rnb_tpu.ops import wire as jax_wire
from rnb_tpu.stage import PaddedBatch as JaxPaddedBatch
from rnb_tpu.stage import RaggedBatch as JaxRaggedBatch
from rnb_tpu.telemetry import TimeCard as JaxTimeCard
from rnb_tpu_torch import faults
from rnb_tpu_torch.ops import wire
from rnb_tpu_torch.stage import PaddedBatch, RaggedBatch
from rnb_tpu_torch.telemetry import TimeCard, TimeCardList

CODECS = {"port": wire, "jax": jax_wire}
#: (writer, reader) package pairs: each decoder reads the other's frames
CROSS = [("port", "jax"), ("jax", "port"), ("port", "port")]


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


def _stub_card(rid=7):
    """A card both packages serialize alike: only stamps both carry."""
    return types.SimpleNamespace(
        id=rid, sub_id=None, timings={"enqueue_filename": 12.5,
                                      "runner0_start": 13.25},
        devices=[("cuda:0",)], status="ok", failure_reason=None,
        num_clips=2, pad_rows=1, deadline_s=99.5)


FRAMES = [
    (wire.REQ, "req", dict(seq=42, deadline=123.5, depth=3)),
    (wire.ACK, None, dict(seq=42, depth=4)),
    (wire.DATA, "data", dict(seq=42, depth=2)),
    (wire.BEAT, None, dict(depth=1)),
    (wire.DISPOSE, "dispose", dict(seq=9, depth=0)),
    (wire.EOS, None, {}),
]


def _payload(codec, kind):
    card = _stub_card()
    if kind == "req":
        return codec.encode_req("synth://kinetics/video-0007", card)
    if kind == "dispose":
        return codec.encode_dispose("shed", "netedge:deadline_expired",
                                    card)
    if kind == "data":
        rows = np.arange(2 * 3 * 4, dtype=np.int16).reshape(2, 3, 4)
        data = np.zeros((5, 3, 4), np.int16)
        data[:2] = rows
        return codec.encode_data(JaxPaddedBatch(data, 2)
                                 if codec is jax_wire
                                 else PaddedBatch(torch.from_numpy(data), 2),
                                 "synth://kinetics/video-0007", card)
    return b""


@pytest.mark.parametrize("ftype,kind,fields", FRAMES,
                         ids=[wire.FRAME_NAMES[f[0]] for f in FRAMES])
def test_the_same_fields_give_the_same_bytes(ftype, kind, fields):
    assert wire.HEADER_SIZE == jax_wire.HEADER_SIZE == 28
    assert wire.FRAME_NAMES == jax_wire.FRAME_NAMES
    ours = wire.encode_frame(ftype, _payload(wire, kind), **fields)
    theirs = jax_wire.encode_frame(ftype, _payload(jax_wire, kind), **fields)
    assert ours == theirs


@pytest.mark.parametrize("writer,reader", CROSS)
@pytest.mark.parametrize("ftype,kind,fields", FRAMES,
                         ids=[wire.FRAME_NAMES[f[0]] for f in FRAMES])
def test_each_package_reads_the_other_s_frames(writer, reader, ftype, kind,
                                               fields):
    w, r = CODECS[writer], CODECS[reader]
    payload = _payload(w, kind)
    a, b = _pair()
    try:
        a.sendall(w.encode_frame(ftype, payload, **fields))
        got = r.read_frame(b)
    finally:
        a.close()
        b.close()
    assert got == (ftype, 0, fields.get("depth", 0), fields.get("seq", 0),
                   fields.get("deadline", 0.0), payload)
    if kind == "req":
        path, card = r.decode_req(got[5])
        assert path == "synth://kinetics/video-0007"
        assert (card.id, dict(card.timings), card.devices, card.num_clips,
                card.pad_rows, card.deadline_s) == (
            7, {"enqueue_filename": 12.5, "runner0_start": 13.25},
            [("cuda:0",)], 2, 1, 99.5)
    elif kind == "dispose":
        outcome, reason, card = r.decode_dispose(got[5])
        assert (outcome, reason, card.id) == (
            "shed", "netedge:deadline_expired", 7)
    elif kind == "data":
        batch, non_tensors, card, row_bytes = r.decode_data(got[5])
        data = np.asarray(batch.data)
        assert row_bytes == 2 * 3 * 4 * 2   # only the valid rows crossed
        assert non_tensors == "synth://kinetics/video-0007" and card.id == 7
        assert batch.valid == 2 and data.shape == (5, 3, 4)
        assert data.dtype == np.int16
        np.testing.assert_array_equal(
            data[:2], np.arange(24, dtype=np.int16).reshape(2, 3, 4))
        assert not data[2:].any()   # re-padded with zeros


@pytest.mark.parametrize("writer,reader", CROSS)
def test_a_flipped_byte_is_a_corrupt_frame_and_framing_survives(writer,
                                                                reader):
    w, r = CODECS[writer], CODECS[reader]
    errors = faults if r is wire else jax_faults
    a, b = _pair()
    try:
        for where in (-1, 30, 3):   # payload, its first byte, the length
            frame = bytearray(w.encode_frame(w.DATA, b"payload-bytes",
                                             seq=9))
            frame[where] ^= 0xff
            a.sendall(bytes(frame))
            if where == 3:
                # a flipped length byte makes the reader wait for bytes
                # that never come: the frame ends short instead
                a.close()
                with pytest.raises(errors.NetPartialFrameError):
                    r.read_frame(b)
                return
            with pytest.raises(errors.NetCorruptFrameError) as info:
                r.read_frame(b)
            assert info.value.seq == 9
            assert errors.fault_reason(info.value) == "net_corrupt"
            # the next frame on the same connection reads
            a.sendall(w.encode_frame(w.BEAT, depth=1))
            assert r.read_frame(b)[0] == w.BEAT
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("writer,reader", CROSS)
@pytest.mark.parametrize("cut", [1, 10, 27, 28, 40])
def test_a_frame_cut_short_is_partial_and_a_boundary_eof_a_reset(
        writer, reader, cut):
    w, r = CODECS[writer], CODECS[reader]
    errors = faults if r is wire else jax_faults
    frame = w.encode_frame(w.DATA, b"x" * 64, seq=1)
    a, b = _pair()
    a.sendall(frame[:cut])
    a.close()
    with pytest.raises(errors.NetPartialFrameError):
        r.read_frame(b)
    b.close()
    a, b = _pair()
    a.sendall(frame)
    a.close()
    assert r.read_frame(b)[5] == b"x" * 64
    with pytest.raises(errors.NetResetError):
        r.read_frame(b)
    b.close()


@pytest.mark.parametrize("exc", [socket.timeout(), ConnectionRefusedError(),
                                 ConnectionResetError(), BrokenPipeError(),
                                 ConnectionAbortedError(), ValueError(),
                                 OSError(113, "no route to host")],
                         ids=lambda e: type(e).__name__)
def test_io_errors_classify_as_the_reference_s(exc):
    ours, theirs = wire.classify_io_error(exc), \
        jax_wire.classify_io_error(exc)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert type(ours).__name__ == type(theirs).__name__
        assert faults.fault_reason(ours) == jax_faults.fault_reason(theirs)
        assert faults.classify_error(ours) == \
            jax_faults.classify_error(theirs)
    # only corruption is permanent
    for name in ("NetRefusedError", "NetResetError", "NetTimeoutError",
                 "NetPartialFrameError"):
        assert issubclass(getattr(faults, name), faults.TransientError)
    assert issubclass(faults.NetCorruptFrameError, faults.PermanentError)


@pytest.mark.parametrize("codec", ["port", "jax"])
def test_an_unbounded_socket_is_refused(codec):
    a, b = socket.socketpair()   # deliberately no settimeout
    try:
        with pytest.raises(ValueError, match="configured timeout"):
            CODECS[codec].read_frame(b)
    finally:
        a.close()
        b.close()


def test_the_send_side_classifies_a_dead_peer():
    a, b = _pair()
    b.close()
    with pytest.raises((faults.NetResetError,)):
        for _ in range(64):   # the first sends may still be buffered
            wire.send_frame(a, wire.encode_frame(wire.BEAT) * 4096)
    a.close()


def test_data_bytes_equal_the_reference_s_and_ragged_offsets_cross():
    rows = np.random.default_rng(0).integers(
        -3000, 3000, (3, 2, 6), dtype=np.int16)
    data = np.zeros((4, 2, 6), np.int16)
    data[:3] = rows
    card = _stub_card(5)
    ours = wire.encode_data(RaggedBatch(torch.from_numpy(data), 3,
                                        (0, 1, 3)), [5, "x"], card)
    theirs = jax_wire.encode_data(JaxRaggedBatch(data, 3, (0, 1, 3)),
                                  [5, "x"], card)
    assert ours == theirs
    batch, non_tensors, _card, _n = wire.decode_data(theirs)
    assert isinstance(batch, RaggedBatch)
    assert batch.segment_offsets == (0, 1, 3) and non_tensors == [5, "x"]
    np.testing.assert_array_equal(batch.data.numpy(), data)
    batch, _, _, _ = jax_wire.decode_data(ours)
    assert isinstance(batch, JaxRaggedBatch)
    assert tuple(batch.segment_offsets) == (0, 1, 3)


def test_bfloat16_rows_cross_bit_for_bit():
    """The rgb path's emission is bfloat16, which numpy has no dtype for:
    the port ships and reads it as raw bits under the reference's dtype
    name."""
    rows = torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(0))
    data = torch.zeros(3, 3, 4, dtype=torch.bfloat16)
    data[:2] = rows.to(torch.bfloat16)
    payload = wire.encode_data(PaddedBatch(data, 2), None, _stub_card())
    meta_len = int(np.frombuffer(payload[:4], np.uint32)[0])
    assert json.loads(payload[4:4 + meta_len])["dtype"] == "bfloat16"
    batch, _, _, row_bytes = wire.decode_data(payload)
    assert row_bytes == 2 * 3 * 4 * 2
    assert torch.equal(batch.data.view(torch.int16), data.view(torch.int16))
    theirs, _, _, _ = jax_wire.decode_data(payload)
    np.testing.assert_array_equal(
        np.asarray(theirs.data).view(np.int16), data.view(torch.int16).numpy())


def test_data_refuses_fused_cards_and_rows_off_the_host():
    batch = PaddedBatch(torch.zeros(2, 3), 1)
    with pytest.raises(ValueError, match="single-request"):
        wire.encode_data(batch, None, TimeCardList([TimeCard(0),
                                                    TimeCard(1)]))
    off_host = PaddedBatch(torch.zeros(2, 3, device="meta"), 1)
    with pytest.raises(ValueError, match="host rows"):
        wire.encode_data(off_host, None, TimeCard(0))


def test_host_batch_copies_the_valid_rows_only():
    data = torch.arange(4 * 3, dtype=torch.int16).view(4, 3)
    host = wire.host_batch(PaddedBatch(data, 2))
    assert isinstance(host, PaddedBatch) and host.valid == 2
    assert torch.equal(host.data[:2], data[:2])
    assert not host.data[2:].any()
    ragged = wire.host_batch(RaggedBatch(data, 3, (0, 3)))
    assert isinstance(ragged, RaggedBatch)
    assert ragged.segment_offsets == (0, 3)


def test_cards_cross_with_every_stamp_they_carry():
    ours = TimeCard(11)
    ours.record("enqueue_filename", at=1.0)
    ours.record("runner0_start", at=2.0)
    ours.add_device("cuda:0")
    ours.video, ours.num_clips, ours.row0 = "synth://x", 3, 0
    ours.deadline_s = 5.0
    ours.mark_shed("netedge:deadline_expired")
    theirs = jax_wire.card_from_wire(json.loads(json.dumps(
        wire.card_to_wire(ours))))
    assert isinstance(theirs, JaxTimeCard)
    assert (theirs.id, dict(theirs.timings), theirs.devices, theirs.status,
            theirs.failure_reason, theirs.num_clips, theirs.deadline_s,
            theirs.video) == (11, {"enqueue_filename": 1.0,
                                   "runner0_start": 2.0},
                              [("cuda:0",)], "shed",
                              "netedge:deadline_expired", 3, 5.0,
                              "synth://x")
    back = wire.card_from_wire(json.loads(json.dumps(
        jax_wire.card_to_wire(theirs))))
    assert (back.id, dict(back.timings), back.devices, back.status,
            back.num_clips, back.deadline_s) == (
        11, dict(ours.timings), [("cuda:0",)], "shed", 3, 5.0)
    # an absent stamp stays absent
    assert "deadline_s" not in wire.card_to_wire(TimeCard(1))["stamps"]
