"""Length-prefixed, checksummed frame protocol of the ingest edge
(:mod:`rnb_tpu_torch.netedge`).

Counterpart of ``rnb_tpu/ops/wire.py``, byte for byte: the same frame
fields give the same bytes, and each package's decoder reads the
other's frames. One frame is a fixed 28-byte little-endian header
followed by ``length`` payload bytes:

    u32  length    payload byte count (not counting the header)
    u8   type      REQ | ACK | DATA | BEAT | DISPOSE | EOS
    u8   flags     reserved (0)
    u16  depth     sender's in-flight request count at send time, on
                   every frame (the health board's depth signal)
    u64  seq       sequence number of the REQ the frame belongs to (0 on
                   BEAT/EOS); both sides' dedup ledgers key on it
    f64  deadline  the request's absolute ``deadline_s`` (0.0 when none),
                   in the header so either side can shed on expiry
                   without decoding the payload
    u32  crc       CRC32 over the 24 preceding header bytes + payload

Payloads are JSON (REQ/DISPOSE), empty (ACK/BEAT/EOS), or JSON meta plus
the raw bytes of the batch's ``valid`` leading rows (DATA): for the
packed DCT wire exactly ``dct_frame_elems`` int16 elements a frame
(9,408 B at the default budget). The receiver re-pads to the shipped
shape with zeros, which is what the pad rows hold by construction.

A DATA frame carries host rows. The port's loaders emit on the card, so
the peer copies an emission's valid rows to the host once, explicitly
(:func:`host_batch`); :func:`encode_data` refuses a tensor on the card
rather than copy it behind the caller's back. :func:`decode_data` gives
a CPU tensor, since numpy has no bfloat16 (the rgb path's dtype).

Error classification (:mod:`rnb_tpu_torch.faults`):

    CRC mismatch              -> NetCorruptFrameError   (permanent)
    EOF inside a frame        -> NetPartialFrameError   (transient)
    EOF at a frame boundary   -> NetResetError          (transient)
    ECONNRESET / EPIPE        -> NetResetError          (transient)
    socket timeout            -> NetTimeoutError        (transient)
    dial refused              -> NetRefusedError        (transient)
"""

from __future__ import annotations

import json
import socket
import struct
import zlib
from collections import OrderedDict
from typing import Any, Optional, Tuple

import torch

from rnb_tpu_torch.faults import (NetCorruptFrameError, NetPartialFrameError,
                                  NetRefusedError, NetResetError,
                                  NetTimeoutError)

#: frame types
REQ = 1       # main -> peer: one request (path + serialized TimeCard)
ACK = 2       # peer -> main: REQ accepted (resend suppression + depth)
DATA = 3      # peer -> main: the stage's output rows for one REQ
BEAT = 4      # peer -> main: liveness heartbeat (depth piggybacked)
DISPOSE = 5   # peer -> main: terminal non-output outcome (failed/shed)
EOS = 6       # main -> peer: no more REQs; drain and exit

FRAME_NAMES = {REQ: "REQ", ACK: "ACK", DATA: "DATA", BEAT: "BEAT",
               DISPOSE: "DISPOSE", EOS: "EOS"}

#: header minus the trailing crc, and the crc tail
_HEAD = struct.Struct("<IBBHQd")
_CRC = struct.Struct("<I")
HEADER_SIZE = _HEAD.size + _CRC.size

#: the card stamps a frame carries: the reference's content stamps (its
#: ``rnb_tpu/telemetry.py`` CONTENT_STAMPS), then the port's own
#: ``video`` and ``row0``, which the final step's outputs and a fused
#: emission's row ranges read
WIRE_STAMPS = ("num_clips", "cache_hit", "cache_coalesced", "feature_hit",
               "pad_rows", "deadline_s", "redispatched", "hedge_copy",
               "hedge_resolved", "video", "row0")

#: the dtype names a DATA frame may carry (numpy's names, as the
#: reference writes them): the three wires' and float32
_TORCH_DTYPES = {"uint8": torch.uint8, "int16": torch.int16,
                 "bfloat16": torch.bfloat16, "float32": torch.float32}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def encode_frame(ftype: int, payload: bytes = b"", seq: int = 0,
                 deadline: float = 0.0, depth: int = 0,
                 flags: int = 0) -> bytes:
    """One wire-ready frame. ``depth`` saturates at u16 max rather than
    wrapping: a depth gauge that lies small under backlog would hide the
    overload it exists to show."""
    head = _HEAD.pack(len(payload), ftype, flags, min(depth, 0xffff),
                      seq, deadline)
    crc = zlib.crc32(payload, zlib.crc32(head)) & 0xffffffff
    return head + _CRC.pack(crc) + payload


def classify_io_error(exc: BaseException) -> Optional[Exception]:
    """Map a raw socket exception onto the net taxonomy, or None if it
    is not a recognized network failure (the caller re-raises those)."""
    if isinstance(exc, socket.timeout):
        return NetTimeoutError(str(exc) or "socket timeout")
    if isinstance(exc, ConnectionRefusedError):
        return NetRefusedError(str(exc))
    if isinstance(exc, (ConnectionResetError, BrokenPipeError,
                        ConnectionAbortedError)):
        return NetResetError(str(exc))
    return None


def recv_exact(sock: socket.socket, n: int, *, mid_frame: bool) -> bytes:
    """Exactly ``n`` bytes off ``sock`` or a classified net error.

    EOF before the first byte of a frame header is a dead connection
    (:class:`NetResetError`); EOF anywhere else is a short frame
    (:class:`NetPartialFrameError`). A socket without a timeout is
    refused: an unbounded recv would hang the receiver forever on a
    silently dead peer instead of surfacing as ``net_timeout``."""
    if sock.gettimeout() is None:
        raise ValueError("recv_exact needs a socket with a configured "
                         "timeout (sock.settimeout)")
    chunks = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(n - got)
        except Exception as exc:  # noqa: BLE001 - classified below
            net = classify_io_error(exc)
            if net is not None:
                raise net from exc
            raise
        if not chunk:
            if mid_frame or got:
                raise NetPartialFrameError(
                    "stream ended %d bytes into a %d-byte read" % (got, n))
            raise NetResetError("connection closed by peer")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(sock: socket.socket
               ) -> Tuple[int, int, int, int, float, bytes]:
    """-> (type, flags, depth, seq, deadline, payload) or a classified
    net error. The CRC covers header and payload, so a flipped byte
    anywhere surfaces as :class:`NetCorruptFrameError` (carrying the
    frame's ``seq``), but only after the whole frame was read: framing
    stays in sync and the connection survives it."""
    head = recv_exact(sock, _HEAD.size, mid_frame=False)
    (crc_stored,) = _CRC.unpack(recv_exact(sock, _CRC.size, mid_frame=True))
    length, ftype, flags, depth, seq, deadline = _HEAD.unpack(head)
    payload = recv_exact(sock, length, mid_frame=True) if length else b""
    crc = zlib.crc32(payload, zlib.crc32(head)) & 0xffffffff
    if crc != crc_stored:
        exc = NetCorruptFrameError(
            "crc mismatch on %s frame seq=%d (%08x != %08x)"
            % (FRAME_NAMES.get(ftype, ftype), seq, crc, crc_stored))
        exc.seq = seq  # the receiver dead-letters exactly this request
        raise exc
    return ftype, flags, depth, seq, deadline, payload


def send_frame(sock: socket.socket, frame: bytes) -> None:
    """sendall with the receive side's classification."""
    try:
        sock.sendall(frame)
    except Exception as exc:  # noqa: BLE001 - classified below
        net = classify_io_error(exc)
        if net is not None:
            raise net from exc
        raise


# -- TimeCard serialization -------------------------------------------

def card_to_wire(card) -> dict:
    """JSON-safe dict of everything a TimeCard owns: identity, the
    ordered stamps, the device trail, the outcome and every wire stamp
    the card has (an absent stamp stays absent: presence is part of the
    schema, e.g. ``deadline_s`` on a deadline-off run)."""
    stamps = {attr: getattr(card, attr) for attr in WIRE_STAMPS
              if hasattr(card, attr)}
    return {"id": card.id, "sub_id": card.sub_id,
            "timings": [[k, t] for k, t in card.timings.items()],
            "devices": [list(d) for d in card.devices],
            "status": card.status,
            "failure_reason": card.failure_reason,
            "stamps": stamps}


def card_from_wire(d: dict):
    """Inverse of :func:`card_to_wire`."""
    from rnb_tpu_torch.telemetry import TimeCard
    card = TimeCard(int(d["id"]))
    card.sub_id = d.get("sub_id")
    card.timings = OrderedDict((k, float(t)) for k, t in d["timings"])
    card.devices = [tuple(dev) for dev in d.get("devices", [])]
    card.status = d.get("status", "ok")
    card.failure_reason = d.get("failure_reason")
    for attr, value in d.get("stamps", {}).items():
        setattr(card, attr, value)
    return card


# -- REQ / DISPOSE payloads -------------------------------------------

def encode_req(path: str, card) -> bytes:
    return json.dumps({"path": path, "card": card_to_wire(card)},
                      sort_keys=True).encode("utf-8")


def decode_req(payload: bytes) -> Tuple[str, Any]:
    d = json.loads(payload.decode("utf-8"))
    return d["path"], card_from_wire(d["card"])


def encode_dispose(outcome: str, reason: str, card) -> bytes:
    """``outcome`` is "failed" (the peer dead-lettered the request) or
    "shed" (the peer shed it at its receive boundary)."""
    return json.dumps({"outcome": outcome, "reason": reason,
                       "card": card_to_wire(card)},
                      sort_keys=True).encode("utf-8")


def decode_dispose(payload: bytes) -> Tuple[str, str, Any]:
    d = json.loads(payload.decode("utf-8"))
    return d["outcome"], d["reason"], card_from_wire(d["card"])


# -- DATA payload (batch rows + meta) ---------------------------------

def host_batch(batch):
    """The batch with its ``valid`` leading rows copied to the host: the
    one device-to-host copy a peer makes per emission. The pad rows stay
    zeros that are never read (:func:`encode_data` ships valid rows
    only)."""
    from rnb_tpu_torch.stage import RaggedBatch
    data = batch.data
    valid = int(batch.valid)
    host = torch.zeros(tuple(data.shape), dtype=data.dtype)
    if valid:
        host[:valid].copy_(data[:valid])
    if isinstance(batch, RaggedBatch):
        return RaggedBatch(host, valid, batch.segment_offsets)
    return type(batch)(host, valid)


def _host_rows(data, valid: int) -> Tuple[list, str, bytes]:
    """(shape, dtype name, bytes of the valid rows) of a CPU tensor."""
    if data.device.type != "cpu":
        raise ValueError(
            "encode_data needs host rows, got a tensor on %s: copy the "
            "emission to the host first (host_batch)" % data.device)
    rows = data[:valid].contiguous()
    return (list(data.shape), _DTYPE_NAMES[data.dtype],
            rows.view(torch.uint8).numpy().tobytes() if valid else b"")


def encode_data(batch, non_tensors, card) -> bytes:
    """u32 meta length + JSON meta + the raw bytes of the VALID rows.

    Only single-request emissions are wire-able (seq <-> request is
    1:1, which is what makes the exactly-once ledger sound), so fusing
    loaders stay in-process: enforced here, loudly."""
    from rnb_tpu_torch.stage import RaggedBatch
    if not hasattr(card, "timings"):
        raise ValueError(
            "netedge wire carries single-request emissions only "
            "(got %s — fusing loaders are not wire-able)"
            % type(card).__name__)
    valid = int(batch.valid)
    shape, dtype_name, raw = _host_rows(batch.data, valid)
    meta = {"kind": ("ragged" if isinstance(batch, RaggedBatch)
                     else "padded"),
            "shape": shape, "dtype": dtype_name,
            "valid": valid,
            "offsets": (list(batch.segment_offsets)
                        if isinstance(batch, RaggedBatch) else None),
            "non_tensors": non_tensors,
            "card": card_to_wire(card)}
    mj = json.dumps(meta, sort_keys=True).encode("utf-8")
    return struct.pack("<I", len(mj)) + mj + raw


def decode_data(payload: bytes) -> Tuple[Any, Any, Any, int]:
    """-> (batch, non_tensors, card, row_bytes). The batch's data is a
    CPU tensor of the shipped shape, re-padded with zeros: bitwise what
    the in-process loader emits, because its pad rows are zeros."""
    from rnb_tpu_torch.stage import PaddedBatch, RaggedBatch
    (mlen,) = struct.unpack_from("<I", payload, 0)
    meta = json.loads(payload[4:4 + mlen].decode("utf-8"))
    raw = payload[4 + mlen:]
    shape = tuple(int(s) for s in meta["shape"])
    if meta["dtype"] not in _TORCH_DTYPES:
        raise ValueError("DATA frame dtype %r is not one the port reads"
                         % (meta["dtype"],))
    dtype = _TORCH_DTYPES[meta["dtype"]]
    valid = int(meta["valid"])
    data = torch.zeros(shape, dtype=dtype)
    if valid:
        data[:valid] = torch.frombuffer(bytearray(raw), dtype=dtype).view(
            (valid,) + shape[1:])
    if meta["kind"] == "ragged":
        batch = RaggedBatch(data, valid, tuple(meta["offsets"] or (0, 0)))
    else:
        batch = PaddedBatch(data, valid)
    return batch, meta["non_tensors"], card_from_wire(meta["card"]), \
        len(raw)
