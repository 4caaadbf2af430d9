"""Decoded-clip cache + in-flight request coalescing.

Counterpart of ``rnb_tpu/cache.py``. Popularity-skewed traffic (the
Zipf workload of :class:`rnb_tpu_torch.video_path_provider.ZipfPathIterator`)
repeats a few videos; a hit skips the decode, and a coalesced request
shares a decode that is already running.

* **Content-addressed keys** (:func:`content_key`): video path, file
  ``(mtime_ns, size)`` and the loader's decode-config fingerprint. A
  file replaced on disk gets a new key; two configs never alias.
* **Three storage modes** of one byte-accounted LRU:
  - bucketed blob (:meth:`ClipCache.insert_host` /
    :meth:`~ClipCache.insert_device`): the bucket-padded batch on the
    card, served as a standalone emission;
  - ragged blob (:meth:`~ClipCache.insert_rows`): exactly ``valid`` host
    rows, copied into the next pool like an instant decode;
  - paged (:meth:`~ClipCache.attach_arena`, :meth:`~ClipCache.acquire`,
    :meth:`~ClipCache.insert_pages`): page reference lists in a
    :class:`rnb_tpu_torch.pager.Arena`; a hit is a pinned gather plan.
* **Insert-after-success**: loaders insert only rows whose decode (and,
  paged, transfer) completed.
* **Coalescing** (:class:`InflightTable`): a request for a key whose
  decode is in flight parks on the leader's record and rides its
  emission.

Counters are exact and surface as the ``Cache:`` log-meta line and the
``# cache`` trailer of the timing tables.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

#: stat signature for ids that are not files (synth:// ids): their
#: content is deterministic per id
_NO_STAT = (-1, -1)


def content_key(video: str, cfg_key: Any) -> tuple:
    """Content-addressed cache key for one request: the video, its
    file's ``(mtime_ns, size)`` (a constant for ids without a file) and
    the loader's decode-config fingerprint ``cfg_key``."""
    try:
        st = os.stat(video)
        sig = (st.st_mtime_ns, st.st_size)
    except (OSError, ValueError):
        sig = _NO_STAT
    return (video, sig, cfg_key)


class CacheEntry:
    """One blob entry: a device batch padded to its bucket, or host row
    extents, plus the valid-row count."""

    __slots__ = ("batch", "valid", "nbytes")

    def __init__(self, batch, valid: int, nbytes: int):
        self.batch = batch
        self.valid = int(valid)
        self.nbytes = int(nbytes)


class PagedEntry:
    """One paged entry: a page reference list into the clip arena."""

    __slots__ = ("pages", "valid", "nbytes")

    def __init__(self, pages: Tuple[int, ...], valid: int, nbytes: int):
        self.pages = pages
        self.valid = int(valid)
        self.nbytes = int(nbytes)


class ClipCache:
    """Bounded, byte-accounted LRU of decoded clip batches."""

    def __init__(self, cache_mb: float, device=None):
        if cache_mb <= 0:
            raise ValueError("cache_mb must be > 0 to build a ClipCache "
                             "(got %r); omit the key to disable caching"
                             % (cache_mb,))
        self.capacity_bytes = int(float(cache_mb) * (1 << 20))
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, Any]" = OrderedDict()
        self.resident_bytes = 0
        self.num_hits = 0
        self.num_misses = 0
        self.num_inserts = 0
        self.num_evictions = 0
        self.num_coalesced = 0
        self.num_oversize = 0
        #: paged mode: entries are page reference lists in this arena
        self._arena = None
        #: the stream bucketed inserts copy to the card on, so the copy
        #: never waits for a forward running on the caller's stream
        self._copy_stream = None

    def attach_arena(self, arena) -> None:
        """Switch to paged mode: entries become page reference lists in
        ``arena``, whose size replaces ``capacity_bytes``."""
        with self._lock:
            if self._entries:
                raise RuntimeError("attach_arena on a non-empty cache: "
                                   "blob and paged entries must never "
                                   "coexist")
            self._arena = arena
            self.capacity_bytes = int(arena.nbytes)

    @property
    def paged(self) -> bool:
        with self._lock:
            return self._arena is not None

    def acquire(self, key: tuple):
        """Paged hit path: counted lookup -> pinned
        :class:`rnb_tpu_torch.pager.GatherPlan`, or None. The caller
        releases the plan once its gather was issued."""
        from rnb_tpu_torch.pager import GatherPlan
        with self._lock:
            arena = self._arena
            if arena is None:
                raise RuntimeError("acquire() is the paged hit path")
            entry = self._entries.get(key)
            if entry is None:
                self.num_misses += 1
                return None
            self._entries.move_to_end(key)
            self.num_hits += 1
            with arena.pager.lock:
                arena.pin_locked(entry.pages)
            return GatherPlan(arena, entry.pages,
                              arena.flat_rows(entry.pages, entry.valid),
                              entry.valid)

    def insert_pages(self, key: tuple, src_pool, row0: int,
                     valid: int) -> bool:
        """Paged insert: allocate pages and publish ``valid`` rows of the
        already transferred pool (rows ``[row0, row0 + valid)``). First
        writer wins; evicts LRU entries until the pages fit; an entry
        needing more pages than the arena holds is counted ``oversize``;
        when every page is pinned the insert is skipped, never blocked."""
        valid = int(valid)
        if valid < 1:
            return False
        with self._lock:
            arena = self._arena
            if arena is None:
                raise RuntimeError("insert_pages() is the paged insert")
            if key in self._entries:
                return False
            needed = arena.pages_needed(valid)
            if needed > arena.num_pages:
                self.num_oversize += 1
                return False
            with arena.pager.lock:
                while True:
                    pages = arena.alloc_locked(needed)
                    if pages is not None or not self._entries:
                        break
                    _, evicted = self._entries.popitem(last=False)
                    self.resident_bytes -= evicted.nbytes
                    self.num_evictions += 1
                    arena.free_locked(evicted.pages)
                if pages is None:
                    return False
                arena.write_entry_locked(pages, src_pool, row0, valid)
            entry = PagedEntry(pages, valid, needed * arena.page_bytes)
            self._entries[key] = entry
            self.resident_bytes += entry.nbytes
            self.num_inserts += 1
            return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def lookup(self, key: tuple) -> Optional[CacheEntry]:
        """Counted blob lookup; a hit refreshes LRU recency."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.num_misses += 1
                return None
            self._entries.move_to_end(key)
            self.num_hits += 1
            return entry

    def contains(self, key: tuple) -> bool:
        """Uncounted membership probe."""
        with self._lock:
            return key in self._entries

    def note_coalesced(self, n: int = 1) -> None:
        with self._lock:
            self.num_coalesced += n

    def _insert(self, key: tuple, batch, valid: int, nbytes: int) -> bool:
        """The one locked blob insert: first writer wins, oversize
        skipped (counted), LRU eviction until the entry fits."""
        with self._lock:
            if key in self._entries:
                return False
            if nbytes > self.capacity_bytes:
                self.num_oversize += 1
                return False
            while (self.resident_bytes + nbytes > self.capacity_bytes
                   and self._entries):
                _, evicted = self._entries.popitem(last=False)
                self.resident_bytes -= evicted.nbytes
                self.num_evictions += 1
            self._entries[key] = CacheEntry(batch, valid, nbytes)
            self.resident_bytes += nbytes
            self.num_inserts += 1
            return True

    def insert_device(self, key: tuple, device_batch: torch.Tensor,
                      valid: int) -> bool:
        """Insert a padded batch already on the card."""
        return self._insert(key, device_batch, valid,
                            device_batch.numel()
                            * device_batch.element_size())

    def insert_host(self, key: tuple, clips, valid: int,
                    target_shape: Tuple[int, ...],
                    dtype: torch.dtype = torch.uint8) -> bool:
        """Pad host rows to ``target_shape``, copy them to the card, and
        insert. Copies out of ``clips`` (which may be a staging-slot view
        about to be reused) before returning. On the card the copy runs
        on the cache's own stream and is confirmed before the insert."""
        itemsize = torch.empty((), dtype=dtype).element_size()
        with self._lock:
            if int(np.prod(target_shape)) * itemsize > self.capacity_bytes:
                self.num_oversize += 1
                return False
        if self.contains(key):
            return False
        padded = torch.zeros(tuple(target_shape), dtype=dtype)
        padded[:valid] = torch.as_tensor(np.asarray(clips)[:valid])
        if self.device.type == "cuda":
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(device=self.device)
            with torch.cuda.stream(self._copy_stream):
                device_batch = padded.to(self.device)
            self._copy_stream.synchronize()
        else:
            device_batch = padded
        return self.insert_device(key, device_batch, valid)

    def insert_rows(self, key: tuple, clips, valid: int) -> bool:
        """Insert a host row extent: exactly ``valid`` rows, no padding,
        no transfer (ragged blob mode); copied out of ``clips``."""
        valid = int(valid)
        rows = np.array(np.asarray(clips)[:valid])
        return self._insert(key, rows, valid, int(rows.nbytes))

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.num_hits,
                "misses": self.num_misses,
                "inserts": self.num_inserts,
                "evictions": self.num_evictions,
                "coalesced": self.num_coalesced,
                "oversize": self.num_oversize,
                "bytes_resident": self.resident_bytes,
                "entries": len(self._entries),
                "capacity_bytes": self.capacity_bytes,
            }


def aggregate_snapshots(snapshots: List[Dict[str, int]]) -> Dict[str, int]:
    """Sum per-instance cache snapshots into one job-wide record."""
    total = {"hits": 0, "misses": 0, "inserts": 0, "evictions": 0,
             "coalesced": 0, "oversize": 0, "bytes_resident": 0,
             "entries": 0, "capacity_bytes": 0}
    for snap in snapshots:
        for k in total:
            total[k] += int(snap.get(k, 0))
    return total


class InflightTable:
    """Key -> in-flight record, for request coalescing. Records leave
    when their decode is finalized (taken for emission or discarded)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: Dict[tuple, Any] = {}

    def get(self, key: tuple) -> Optional[Any]:
        with self._lock:
            return self._records.get(key)

    def put(self, key: tuple, record: Any) -> None:
        with self._lock:
            self._records[key] = record

    def pop(self, key: Optional[tuple]) -> None:
        if key is None:
            return
        with self._lock:
            self._records.pop(key, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)
