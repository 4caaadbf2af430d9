"""Device footprint ledger: per-device byte accounting with declared owners.

Counterpart of ``rnb_tpu/memledger.py``, with the same owners, dedupe,
peak, watermark and snapshot semantics:

* **Declared owners** (:data:`MEM_OWNER_REGISTRY`): every byte source
  registers under one of the declared owner names; an undeclared owner
  raises at registration.
* **Sources, not re-measurement**: each subsystem already tracks its
  own bytes; the ledger holds ``(owner, key) -> probe`` entries (a
  callable or a fixed byte count) and sums them on each
  :meth:`MemLedger.sample`. The ``key`` dedupes shared objects: stage
  instances sharing one network count its parameters once.
* **Peak high-water tracking** per owner and for the total, sampled by
  the devobs worker and by every metrics flusher tick, so the
  ``Memory:`` line's ``peak_bytes >= total_bytes`` holds by
  construction.
* **Watermark**: crossing a byte threshold (below -> at-or-above) warns
  once per episode, counts a ``watermark_hit`` and fires the flight
  recorder's ``memory_watermark`` trigger, whose hooks arm a devobs
  capture window.
* **Reconciliation** (:meth:`reconcile`): the ledger's live-backed
  claims (sources registered ``live=True``: the device parameters) must
  not exceed ``torch.cuda.memory_allocated`` summed over the CUDA
  devices the ledger names. The allocator's count also holds what no
  owner claims (activations, CUDA-graph pools), so the claim is a lower
  bound of it. On the CPU the allocator count is 0: the ledger reports
  ``live_bytes=0, reconciled=0`` ("not reconciled", which the check
  accepts; ``live_bytes > 0`` with ``reconciled=0`` is the failure).

The ``staging`` owner counts pinned host slots, as the reference's
staging slots are host memory too; only ``live=True`` sources enter the
reconcile.

Cost discipline: with no ``devobs`` root key no ledger exists and the
module-level :func:`register` hook is one ``None`` test.
"""

from __future__ import annotations

import sys
import threading
from collections import namedtuple
from typing import Callable, Dict, Optional, Tuple, Union

#: the active per-job ledger, installed and cleared by
#: rnb_tpu_torch.benchmark around the measured run
ACTIVE: Optional["MemLedger"] = None

#: one declared footprint owner (the telemetry registries' shape)
OwnerSpec = namedtuple("OwnerSpec", ("name", "producer", "description"))

#: every owner name a byte source may register under; the ``Memory
#: owners:`` log-meta line's keys are always a subset of these
MEM_OWNER_REGISTRY = (
    OwnerSpec("params", "rnb_tpu_torch/models/r2p1d/model.py",
              "device-resident network parameters and buffers (deduped: "
              "stages sharing one network count it once)"),
    OwnerSpec("cache", "rnb_tpu_torch/cache.py",
              "clip-cache resident bytes (padded device batches, or "
              "host row extents under ragged dispatch)"),
    OwnerSpec("staging", "rnb_tpu_torch/staging.py",
              "pre-allocated pinned host staging-slot slabs (the "
              "zero-copy decode targets)"),
    OwnerSpec("ragged_pool", "rnb_tpu_torch/models/r2p1d/model.py",
              "one pool-shaped dispatch input per ragged stage"),
    OwnerSpec("handoff", "rnb_tpu_torch/devobs.py",
              "payload bytes resident from the consumer's most recent "
              "edge adoption (registered when a stage hands an edge to "
              "devobs.register_stage; no one-card path has one)"),
    OwnerSpec("page_pool", "rnb_tpu_torch/pager.py",
              "page-allocator arena slabs (paged clip-cache rows and "
              "feature pages) plus the shared zero pools feature hits "
              "dispatch with"),
)

MEM_OWNERS = tuple(spec.name for spec in MEM_OWNER_REGISTRY)


def register(owner: str, device_label: str, key,
             source: Union[int, Callable[[], int]],
             live: bool = False) -> None:
    """Module-level registration hook: one ``None`` test when the ledger
    is off, otherwise :meth:`MemLedger.register`."""
    ledger = ACTIVE
    if ledger is None:
        return
    ledger.register(owner, device_label, key, source, live=live)


class _Source:
    __slots__ = ("owner", "device", "fn", "live")

    def __init__(self, owner: str, device: str,
                 fn: Callable[[], int], live: bool):
        self.owner = owner
        self.device = device
        self.fn = fn
        self.live = live


class MemLedger:
    """Bounded, thread-safe per-device byte registry with peaks and a
    watermark. One instance per job, owned by the devobs plane; sampled
    by the devobs worker and by metrics flusher polls."""

    GUARDED_BY = {
        "_sources": "_lock",
        "_above_watermark": "_lock",
        "_peak_by_owner": "_lock",
        "peak_total": "_lock",
        "watermark_hits": "_lock",
        "_last": "_lock",
    }

    def __init__(self, watermark_bytes: Optional[int] = None):
        self._lock = threading.Lock()
        #: (owner, key) -> _Source; the key dedupes shared objects
        self._sources: Dict[Tuple[str, object], _Source] = {}
        self.watermark_bytes = (int(watermark_bytes)
                                if watermark_bytes else 0)
        self.watermark_hits = 0
        self._above_watermark = False
        self.peak_total = 0
        self._peak_by_owner: Dict[str, int] = {}
        #: the last :meth:`sample` record, for :meth:`peek`
        self._last: Optional[dict] = None
        #: direct watermark observer (the devobs plane's capture arming)
        #: for runs without a metrics registry; with metrics on, the
        #: trigger-hook path delivers the same event and the observer
        #: dedupes (rnb_tpu_torch.devobs checks metrics.ACTIVE)
        self.on_watermark: Optional[Callable[[int], None]] = None

    # -- registration --------------------------------------------------

    def register(self, owner: str, device_label: str, key,
                 source: Union[int, Callable[[], int]],
                 live: bool = False) -> None:
        """Register one byte source under a declared owner.

        A second registration with the same ``(owner, key)`` replaces
        rather than double-counts. ``source`` is a fixed byte count or a
        zero-arg probe returning the current bytes; ``live=True`` marks
        sources backed by persistent device tensors (they enter
        :meth:`reconcile`).
        """
        if owner not in MEM_OWNERS:
            raise ValueError(
                "memory owner %r is not declared in "
                "memledger.MEM_OWNER_REGISTRY — declare it or fix the "
                "registration site" % (owner,))
        if callable(source):
            fn = source
        else:
            nbytes = int(source)
            fn = lambda: nbytes  # noqa: E731 — fixed-count probe
        with self._lock:
            self._sources[(owner, key)] = _Source(
                owner, str(device_label), fn, bool(live))

    # -- sampling ------------------------------------------------------

    def sample(self) -> dict:
        """Probe every source, update peaks, evaluate the watermark.

        Returns ``{"total": int, "owners": {owner: bytes}, "devices":
        {device: bytes}}``. Crossing the watermark warns on stderr once
        per episode, counts one ``watermark_hit`` and fires the flight
        recorder's ``memory_watermark`` trigger."""
        with self._lock:
            sources = list(self._sources.values())
        owners: Dict[str, int] = {}
        devices: Dict[str, int] = {}
        total = 0
        for src in sources:
            try:
                nbytes = int(src.fn())
            except Exception:
                continue  # a dying probe must not kill the sampler
            owners[src.owner] = owners.get(src.owner, 0) + nbytes
            devices[src.device] = devices.get(src.device, 0) + nbytes
            total += nbytes
        crossed = False
        with self._lock:
            self.peak_total = max(self.peak_total, total)
            for owner, nbytes in owners.items():
                self._peak_by_owner[owner] = max(
                    self._peak_by_owner.get(owner, 0), nbytes)
            if self.watermark_bytes > 0:
                above = total >= self.watermark_bytes
                if above and not self._above_watermark:
                    crossed = True
                    self.watermark_hits += 1
                self._above_watermark = above
            record = {"total": total, "owners": owners,
                      "devices": devices}
            self._last = record
        if crossed:
            print("[rnb-tpu] WARNING: memory ledger total %d B crossed "
                  "the %d B watermark" % (total, self.watermark_bytes),
                  file=sys.stderr)
            from rnb_tpu_torch import metrics
            metrics.trigger(metrics.TRIGGER_MEMORY_WATERMARK,
                            {"total_bytes": total,
                             "watermark_bytes": self.watermark_bytes})
            hook = self.on_watermark
            if hook is not None:
                try:
                    hook(total)
                except Exception:
                    pass  # an observer must not break the sampler
        return record

    def peek(self) -> Optional[dict]:
        """The most recent :meth:`sample` record without probing: no
        peak update, no watermark, no trigger (the operator plane's
        ``/statusz`` read must not change the ledger). None until the
        ledger has sampled once."""
        with self._lock:
            return self._last

    # -- reconciliation ------------------------------------------------

    def _live_backend_bytes(self) -> int:
        """``torch.cuda.memory_allocated`` summed over the CUDA devices
        the ledger's sources name; 0 with no card or no CUDA source."""
        # imported here: the log reader (parse_utils) imports the owner
        # registry without torch
        import torch
        if not torch.cuda.is_available():
            return 0
        with self._lock:
            labels = {src.device for src in self._sources.values()}
        indices = set()
        for label in labels:
            platform, _, index = label.partition(":")
            if platform == "cuda" and index.isdigit():
                indices.add(int(index))
        return sum(int(torch.cuda.memory_allocated(index))
                   for index in sorted(indices))

    def reconcile(self) -> Tuple[int, bool]:
        """-> ``(live_bytes, ok)``: the allocator's byte total and
        whether the ledger's live-backed claims fit inside it.
        ``live_bytes == 0`` means there is nothing to reconcile against
        (``ok`` is then False: "not reconciled", distinct from
        "reconciled and violated")."""
        live_bytes = self._live_backend_bytes()
        if live_bytes <= 0:
            return 0, False
        with self._lock:
            sources = list(self._sources.values())
        claimed = 0
        for src in sources:
            if not src.live:
                continue
            try:
                claimed += int(src.fn())
            except Exception:
                continue
        return live_bytes, claimed <= live_bytes

    # -- reporting -----------------------------------------------------

    def snapshot(self) -> dict:
        """Final footing record for the ``Memory:`` / ``Memory owners:``
        log-meta lines: re-samples so the totals reflect the settled
        end-of-run state, then attaches peaks."""
        record = self.sample()
        with self._lock:
            owners_detail = {
                owner: {"bytes": record["owners"].get(owner, 0),
                        "peak_bytes": self._peak_by_owner.get(owner, 0)}
                for owner in sorted(set(record["owners"])
                                    | set(self._peak_by_owner))}
            return {
                "total_bytes": record["total"],
                "peak_bytes": self.peak_total,
                "owners": owners_detail,
                "devices": dict(record["devices"]),
                "watermark_bytes": self.watermark_bytes,
                "watermark_hits": self.watermark_hits,
            }
