"""The inter-stage edge contract: device-resident handoff and its ledger.

Counterpart of ``rnb_tpu/handoff.py``. With the config's root ``handoff``
key every consumer executor applies an :class:`EdgeHandoff` to each
payload it takes off its input queue, and counts the take:

* ``mode: "device"``: a payload already on the consumer's
  ``torch.device`` (a mesh stage's: the device its ``input_sharding``
  names) is adopted by reference (no copy, no transfer, no
  host bounce; on one card, and on the CPU, that is every take). A
  payload on another device is moved with ``Tensor.to(device,
  non_blocking=True)`` on the consumer's stream; the host never holds
  its bytes. No path reaches that branch on one card: it waits for two
  (``ROADMAP.md``, queue 1 item 4).
* ``mode: "host"``: the explicit host round trip, the measurable
  baseline arm: every payload bounces through a pinned host buffer
  before the upload, and every byte is counted.
* no ``handoff`` key: no contract, no accounting, no log line.

Ownership. A queue item's tensors are shared by reference, as the
reference shares its immutable arrays. A torch tensor is mutable, but no
producer of the port writes into a payload it published: every loader
emits each payload in memory of its own (a fresh transfer, gather or
normalize output), and its memory returns to the caching allocator only
once the last reference dies, ordered after every stream that read it
(``record_stream``, the runner's own rule). So the producer's ring
credit (:class:`rnb_tpu_torch.control.RingCredits`) is backpressure
only and comes back at the take, as in the reference, hedged or not: a
hedge copy and its original read the same rows however long either
waits.

Accounting (the ``Handoff:`` line, ``handoff_*`` result fields and the
``parse_utils`` footings): every take is one edge event, ``d2d``
(adopted or moved device to device) or ``host`` (bounced through host
memory), with the bytes the edge moved; an adopted take moves 0 bytes.
``d2d_edges + host_edges == edges``, and a device config reports
``host_bytes == 0``. A payload a producer published as host rows (the
network edge's) is uploaded once, counted under ``d2d_bytes``: the edge
added no host round trip.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

#: modes the root ``handoff`` config key accepts
HANDOFF_MODES = ("device", "host")


class HandoffSettings:
    """Validated, defaulted view of the ``handoff`` root config key."""

    def __init__(self, mode: str):
        if mode not in HANDOFF_MODES:
            raise ValueError("handoff mode must be one of %s, got %r"
                             % (list(HANDOFF_MODES), mode))
        self.mode = mode

    @staticmethod
    def from_config(raw: Optional[dict]) -> Optional["HandoffSettings"]:
        """Settings from the config dict, or None when the key is absent
        or ``enabled`` is false (no contract, no log line)."""
        if not raw or not raw.get("enabled", True):
            return None
        return HandoffSettings(raw.get("mode", "device"))


def _nbytes(tensor) -> int:
    return int(tensor.numel() * tensor.element_size())


class EdgeHandoff:
    """One consumer instance's side of the edge contract, applied to
    every payload it takes. Single-threaded like its executor; the
    snapshot is read after the stage drained (and by the metrics poll,
    which reads plain ints)."""

    def __init__(self, settings: HandoffSettings, device, edge: str,
                 model=None, external_owner=None):
        self.mode = settings.mode
        self.edge = str(edge)
        #: predicate over tensors whose bytes another ledger owner (the
        #: pager's shared pools) already foots
        self._external_owner = external_owner
        self._device = torch.device(device.resolve()
                                    if hasattr(device, "resolve") else device)
        # a stage homed on a mesh names the device its inputs land on
        # (``input_sharding``); every other stage takes them at home
        sharding_fn = getattr(model, "input_sharding", None)
        target = sharding_fn() if sharding_fn is not None else None
        if target is not None:
            self._device = torch.device(target)
        self.d2d_edges = 0
        self.host_edges = 0
        self.d2d_bytes = 0
        self.host_bytes = 0
        #: payload bytes the latest take pins on the consumer side (the
        #: devobs ledger's ``handoff`` owner)
        self.resident_bytes = 0

    def take(self, payload: Tuple) -> Tuple:
        """Apply the contract to one payload (a tuple of PaddedBatch /
        RaggedBatch): the consumer-resident payload, the edge event
        recorded. The batch wrappers keep their valid counts and segment
        tables."""
        if self.mode == "host":
            return self._take_host(payload)
        return self._take_device(payload)

    def _resident(self, data) -> bool:
        device = data.device
        if device.type != self._device.type:
            return False
        if device.type != "cuda":
            return True
        target = (self._device.index if self._device.index is not None
                  else torch.cuda.current_device())
        return device.index == target

    def _take_device(self, payload: Tuple) -> Tuple:
        """Adopt same-device tensors by reference; move a tensor on
        another device on the consumer's stream, never through the
        host."""
        out: List[Any] = []
        moved = 0
        for pb in payload:
            data = pb.data
            if self._resident(data):
                out.append(pb)
                continue
            moved += _nbytes(data)
            out.append(_rewrap(pb, data.to(self._device, non_blocking=True)))
        self.d2d_edges += 1
        self.d2d_bytes += moved
        self.resident_bytes = self._residency(out)
        return tuple(out)

    def _take_host(self, payload: Tuple) -> Tuple:
        """The host round trip: each tensor is copied into a pinned host
        buffer (waiting for it), then uploaded on the consumer's
        stream."""
        pin = self._device.type == "cuda"
        out: List[Any] = []
        moved = 0
        for pb in payload:
            host = torch.empty(pb.data.shape, dtype=pb.data.dtype,
                               pin_memory=pin)
            host.copy_(pb.data)
            moved += _nbytes(host)
            out.append(_rewrap(pb, host.to(self._device, non_blocking=pin)))
        self.host_edges += 1
        self.host_bytes += moved
        self.resident_bytes = self._residency(out)
        return tuple(out)

    def _residency(self, out) -> int:
        return sum(_nbytes(pb.data) for pb in out
                   if self._external_owner is None
                   or not self._external_owner(pb.data))

    def snapshot(self) -> Dict[str, object]:
        """The edge's counters (the ``Handoff:`` and ``Handoff edges:``
        lines, the ``handoff.*`` metric polls)."""
        return {"edge": self.edge, "mode": self.mode,
                "d2d_edges": self.d2d_edges, "host_edges": self.host_edges,
                "d2d_bytes": self.d2d_bytes, "host_bytes": self.host_bytes}


def _rewrap(pb, data):
    """A batch wrapper of ``pb``'s kind around re-homed data."""
    offsets = getattr(pb, "segment_offsets", None)
    if offsets is not None:
        return type(pb)(data, pb.valid, offsets)
    return type(pb)(data, pb.valid)


def aggregate_snapshots(snapshots: List[Dict[str, object]]
                        ) -> Dict[str, object]:
    """Sum per-instance edge snapshots into the job-wide view plus the
    per-edge detail (edge label -> summed counters) of the ``Handoff
    edges:`` line."""
    out: Dict[str, object] = {"edges": 0, "d2d_edges": 0, "host_edges": 0,
                              "d2d_bytes": 0, "host_bytes": 0}
    detail: Dict[str, Dict[str, int]] = {}
    for snap in snapshots:
        per = detail.setdefault(str(snap.get("edge", "?")),
                                {"d2d_edges": 0, "host_edges": 0,
                                 "d2d_bytes": 0, "host_bytes": 0})
        for key in ("d2d_edges", "host_edges", "d2d_bytes", "host_bytes"):
            n = int(snap.get(key, 0))
            out[key] += n
            per[key] += n
    out["edges"] = out["d2d_edges"] + out["host_edges"]
    out["edge_detail"] = detail
    return out


class InflightDepths:
    """Per-lane in-flight depths for least-loaded routing: one per
    replica step, shared by the upstream producers' ReplicaSelector
    (reads, and increments at enqueue) and the lane executors (decrement
    once a popped item's processing completed). A depth counts queued
    plus in-service dispatches, so a lane wedged on a slow batch keeps
    its depth and stops receiving work."""

    GUARDED_BY = {"_depths": "_lock"}

    def __init__(self, queue_indices):
        self._lock = threading.Lock()
        self._depths: Dict[int, int] = {int(q): 0 for q in queue_indices}

    def inc(self, queue_idx: int, n: int = 1) -> None:
        with self._lock:
            if queue_idx in self._depths:
                self._depths[queue_idx] += n

    def dec(self, queue_idx: int, n: int = 1) -> None:
        with self._lock:
            if queue_idx in self._depths:
                self._depths[queue_idx] -= n

    def depth(self, queue_idx: int) -> int:
        with self._lock:
            return self._depths.get(queue_idx, 0)

    def snapshot(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._depths)
