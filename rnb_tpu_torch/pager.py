"""One page allocator on the card: paged clip-cache entries + feature pages.

Counterpart of ``rnb_tpu/pager.py``:

* :class:`Arena` — one device slab ``(num_pages * page_rows,) +
  row_shape`` (a single ``torch.zeros`` allocation) carved into
  fixed-size row pages on a LIFO free list. Entries hold page
  reference lists: any free pages serve any entry, and eviction frees
  pages, not blobs.
* **Zero-copy hits**: a hit pins its entry's pages and returns a
  :class:`GatherPlan`, the flat slab rows the consumer hands to
  ``gather_rows`` (:mod:`rnb_tpu_torch.ops.pages`) after the pool's
  transfer. Hit rows never exist as host bytes.
* **Pin/limbo rule**: pages freed while a plan pins them park in limbo
  and re-enter the free list only at unpin, so an insert can never
  recycle a page whose gather is planned but not yet issued.
* **Stream order**: the reference's slab is a functional value, so its
  gather captures the slab and a later donated write makes a new one.
  Here writes go into the slab in place. Every gather and write of an
  arena runs on the arena's own CUDA stream, after the caller's stream
  (where its inputs were made), and the caller's stream waits on the
  arena stream after a gather. A later write therefore runs after every
  gather issued before it, and a plan may be released as soon as its
  gather is issued — the same rule as the reference's.
* **Feature pages** (:class:`FeatureCache`, ``pager.feature_cache``):
  final output rows keyed by (content key, stage fingerprint). The
  consuming stage attaches its arena and inserts strictly after its
  forward returned; the loader probes at admission, and a hit skips
  decode, transfer and the whole forward.
* **Footprint**: every arena slab and every adopted shared pool
  registers under the ``page_pool`` owner of
  :mod:`rnb_tpu_torch.memledger` (live-backed: persistent device
  tensors); with devobs off that is one ``None`` test.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rnb_tpu_torch import lockwitness, memledger

#: fallback arena budget when neither ``pool_mb`` nor a cache-derived
#: size hint exists (a bare pager on a cache-less config)
DEFAULT_ARENA_MB = 64


@dataclasses.dataclass(frozen=True)
class PagerSettings:
    """Validated, defaulted view of the ``pager`` root config key."""

    page_rows: int = 4
    pool_mb: Optional[float] = None
    feature_cache: bool = False

    @staticmethod
    def from_config(raw: Optional[dict]) -> Optional["PagerSettings"]:
        """Settings from the config dict, or None when the key is absent
        or ``enabled`` is false."""
        if not raw or not raw.get("enabled", True):
            return None
        page_rows = int(raw.get("page_rows", 4))
        if page_rows < 1:
            raise ValueError("pager.page_rows must be >= 1, got %r"
                             % (raw.get("page_rows"),))
        pool_mb = raw.get("pool_mb")
        if pool_mb is not None:
            pool_mb = float(pool_mb)
            if pool_mb <= 0:
                raise ValueError("pager.pool_mb must be > 0, got %r"
                                 % (raw.get("pool_mb"),))
        return PagerSettings(page_rows=page_rows, pool_mb=pool_mb,
                             feature_cache=bool(
                                 raw.get("feature_cache", False)))


class GatherPlan:
    """One pinned hit: the flat slab row of each valid entry row,
    released once the consumer issued its gather."""

    __slots__ = ("arena", "pages", "src_rows", "valid", "_released")

    def __init__(self, arena: "Arena", pages: Tuple[int, ...],
                 src_rows: np.ndarray, valid: int):
        self.arena = arena
        self.pages = pages
        self.src_rows = src_rows  # int32 (valid,) flat slab rows
        self.valid = int(valid)
        self._released = False

    def release(self) -> None:
        """Unpin the plan's pages (idempotent)."""
        if not self._released:
            self._released = True
            self.arena.unpin(self.pages)


class Arena:
    """One device slab carved into fixed-size row pages. All page-list
    mutation runs under the owning :class:`Pager`'s lock (hit plans are
    made on the executor thread, inserts on the transfer worker)."""

    def __init__(self, pager: "Pager", name: str,
                 row_shape: Tuple[int, ...], dtype: torch.dtype,
                 budget_bytes: int, device=None,
                 gather_keys: Tuple[str, str] = ("gathers",
                                                 "gather_rows")):
        self.pager = pager
        self.name = str(name)
        # the counter pair this arena's gathers feed: the clip arena's
        # gather_rows foot against the clip cache's hit rows, the
        # feature arena keeps its own pair
        self.gather_keys = tuple(gather_keys)
        self.row_shape = tuple(int(d) for d in row_shape)
        self.dtype = dtype
        self.page_rows = int(pager.settings.page_rows)
        itemsize = torch.empty((), dtype=dtype).element_size()
        self.row_bytes = math.prod(self.row_shape) * itemsize
        self.page_bytes = self.row_bytes * self.page_rows
        self.num_pages = max(1, int(budget_bytes) // self.page_bytes)
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self._slab = torch.zeros((self.num_pages * self.page_rows,)
                                 + self.row_shape, dtype=dtype,
                                 device=self.device)
        #: the one stream every gather and write of this slab runs on
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        #: LIFO free list: recently freed pages are re-allocated first
        self._free: List[int] = list(range(self.num_pages))
        self._pins: Dict[int, int] = {}
        self._limbo: set = set()
        # one ledger probe per arena under the declared page_pool owner;
        # live: the slab is a persistent device tensor
        memledger.register("page_pool", str(self.device),
                           ("pager", self.name, id(self)), self.nbytes,
                           live=True)

    @property
    def nbytes(self) -> int:
        return self.num_pages * self.page_bytes

    # -- page lifecycle (call under the pager lock) -------------------

    def pages_needed(self, valid: int) -> int:
        return (int(valid) + self.page_rows - 1) // self.page_rows

    def alloc_locked(self, n_pages: int) -> Optional[Tuple[int, ...]]:
        """Pop ``n_pages`` from the free list, or None (counted)."""
        if n_pages > len(self._free):
            self.pager.counters["alloc_fails"] += 1
            return None
        pages = tuple(self._free.pop() for _ in range(n_pages))
        self.pager.counters["allocs"] += n_pages
        return pages

    def free_locked(self, pages: Tuple[int, ...]) -> None:
        """Return pages to the free list; pages a live plan still pins
        park in limbo until their unpin."""
        for page in pages:
            if self._pins.get(page, 0) > 0:
                self._limbo.add(page)
            else:
                self._free.append(page)
                self.pager.counters["frees"] += 1

    def pin_locked(self, pages: Tuple[int, ...]) -> None:
        for page in pages:
            self._pins[page] = self._pins.get(page, 0) + 1

    def unpin(self, pages: Tuple[int, ...]) -> None:
        with self.pager.lock:
            for page in pages:
                left = self._pins.get(page, 0) - 1
                if left > 0:
                    self._pins[page] = left
                    continue
                self._pins.pop(page, None)
                if page in self._limbo:
                    # evicted under the pin: reusable only now
                    self._limbo.discard(page)
                    self._free.append(page)
                    self.pager.counters["frees"] += 1

    def live_pages_locked(self) -> int:
        """Pages not on the free list: entry-held + limbo."""
        return self.num_pages - len(self._free)

    # -- row addressing ------------------------------------------------

    def flat_rows(self, pages: Tuple[int, ...], valid: int) -> np.ndarray:
        """int32 (valid,) flat slab row of each entry row: row ``r``
        lives at ``pages[r // page_rows] * page_rows + r % page_rows``."""
        r = np.arange(int(valid))
        return (np.asarray(pages, np.int64)[r // self.page_rows]
                * self.page_rows + r % self.page_rows).astype(np.int32)

    # -- slab IO --------------------------------------------------------

    def _on_stream(self, *inputs: torch.Tensor):
        """Enter the arena stream after the caller's stream, where
        ``inputs`` were made; their memory is kept from reuse until the
        arena stream's work on them is done. Returns (caller, context)."""
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        for t in inputs:
            t.record_stream(self._stream)
        return caller, torch.cuda.stream(self._stream)

    def write_entry_locked(self, pages: Tuple[int, ...],
                           src_pool: torch.Tensor, src_row0: int,
                           valid: int) -> None:
        """Publish ``valid`` pool rows starting at ``src_row0`` into
        ``pages``: one page write each, with a fixed ``page_rows`` index
        vector (clamp-padded tails land in page rows no gather reads)."""
        from rnb_tpu_torch.ops.pages import write_rows_page
        base = np.arange(len(pages) * self.page_rows).reshape(
            len(pages), self.page_rows)
        idx = np.minimum(src_row0 + base, src_row0 + valid - 1)
        if self._stream is None:
            for pi, page in enumerate(pages):
                write_rows_page(self._slab, src_pool, idx[pi],
                                page * self.page_rows)
            return
        _, ctx = self._on_stream(src_pool)
        with ctx:
            dev_idx = torch.from_numpy(idx).to(self.device,
                                               non_blocking=True)
            for pi, page in enumerate(pages):
                write_rows_page(self._slab, src_pool, dev_idx[pi],
                                page * self.page_rows)

    def gather(self, dest_pool: torch.Tensor, src_rows) -> torch.Tensor:
        """Overlay slab rows onto ``dest_pool`` (counted); ``src_rows``
        is the emission-level int32 table (``-1`` keeps the pool row).
        On the card the gather runs on the arena stream and the caller's
        stream waits for it."""
        from rnb_tpu_torch.ops.pages import gather_rows
        src = np.ascontiguousarray(src_rows, np.int32)
        with self.pager.lock:
            self.pager.counters[self.gather_keys[0]] += 1
            self.pager.counters[self.gather_keys[1]] += int((src >= 0).sum())
        if self._stream is None:
            return gather_rows(dest_pool, self._slab, src)
        caller, ctx = self._on_stream(dest_pool)
        with ctx:
            table = torch.from_numpy(src).to(self.device,
                                             non_blocking=True)
            out = gather_rows(dest_pool, self._slab, table)
        caller.wait_stream(self._stream)
        out.record_stream(caller)
        return out

    def synchronize(self) -> None:
        """Block the host until every gather and write issued on this
        arena so far has run (a no-op off the card)."""
        if self._stream is not None:
            self._stream.synchronize()

    def snapshot_locked(self) -> Dict[str, int]:
        return {
            "name": self.name,
            "pages": self.num_pages,
            "page_rows": self.page_rows,
            "page_bytes": self.page_bytes,
            "free": len(self._free),
            "limbo": len(self._limbo),
            "bytes": self.nbytes,
        }


class _FeatureEntry:
    __slots__ = ("pages", "valid", "nbytes")

    def __init__(self, pages: Tuple[int, ...], valid: int, nbytes: int):
        self.pages = pages
        self.valid = int(valid)
        self.nbytes = int(nbytes)


class FeatureCache:
    """Final output rows on feature pages, keyed by (content key, stage
    fingerprint). First writer wins; LRU eviction frees pages until an
    insert fits."""

    def __init__(self, pager: "Pager"):
        self.pager = pager
        self._arena: Optional[Arena] = None
        self._fingerprint = None
        self._entries: "OrderedDict[tuple, _FeatureEntry]" = OrderedDict()

    def attach(self, arena: Arena, fingerprint) -> None:
        """Register the consuming stage's arena and fingerprint."""
        with self.pager.lock:
            self._arena = arena
            self._fingerprint = fingerprint

    @property
    def ready(self) -> bool:
        with self.pager.lock:
            return self._arena is not None

    def __len__(self) -> int:
        with self.pager.lock:
            return len(self._entries)

    def acquire(self, content_key) -> Optional[GatherPlan]:
        """Counted lookup -> pinned plan on a hit, None on a miss or
        before any stage attached."""
        with self.pager.lock:
            self.pager.counters["feature_lookups"] += 1
            arena = self._arena
            if arena is None:
                return None
            key = (content_key, self._fingerprint)
            entry = self._entries.get(key)
            if entry is None:
                return None
            self._entries.move_to_end(key)
            self.pager.counters["feature_hits"] += 1
            arena.pin_locked(entry.pages)
            return GatherPlan(arena, entry.pages,
                              arena.flat_rows(entry.pages, entry.valid),
                              entry.valid)

    def contains(self, content_key) -> bool:
        with self.pager.lock:
            if self._arena is None:
                return False
            return (content_key, self._fingerprint) in self._entries

    def insert(self, content_key, src_pool: torch.Tensor, row0: int,
               valid: int) -> bool:
        """Insert ``valid`` output rows (pool rows ``[row0, row0 +
        valid)``) under ``content_key``; False when skipped (present
        already, or no pages even after evicting every entry)."""
        valid = int(valid)
        if valid < 1:
            return False
        with self.pager.lock:
            arena = self._arena
            if arena is None:
                return False
            key = (content_key, self._fingerprint)
            if key in self._entries:
                return False
            needed = arena.pages_needed(valid)
            while True:
                pages = arena.alloc_locked(needed)
                if pages is not None or not self._entries:
                    break
                _, evicted = self._entries.popitem(last=False)
                arena.free_locked(evicted.pages)
                self.pager.counters["feature_evictions"] += 1
            if pages is None:
                return False
            arena.write_entry_locked(pages, src_pool, row0, valid)
            self._entries[key] = _FeatureEntry(pages, valid,
                                               needed * arena.page_bytes)
            self.pager.counters["feature_inserts"] += 1
            return True


class Pager:
    """The per-job page-allocator root: arena registry, shared lock,
    exact counters and the feature cache. Built by the benchmark from
    the ``pager`` root key and handed to every ``SUPPORTS_PAGER`` stage
    through ``enable_pager`` before the start barrier."""

    COUNTER_KEYS = ("allocs", "frees", "alloc_fails", "gathers",
                    "gather_rows", "feature_lookups", "feature_hits",
                    "feature_inserts", "feature_evictions",
                    "feature_gathers", "feature_gather_rows",
                    "feature_bytes_saved")

    GUARDED_BY = {
        "counters": "lock",
        "_arenas": "lock",
        "_size_hint_bytes": "lock",
        "_owned_ids": "lock",
    }

    def __init__(self, settings: PagerSettings):
        self.settings = settings
        self.lock = lockwitness.lock("Pager.lock", threading.RLock)
        self.counters: Dict[str, int] = {k: 0 for k in self.COUNTER_KEYS}
        self._arenas: List[Arena] = []
        self._size_hint_bytes: Optional[int] = None
        self._owned_ids: Dict[int, object] = {}
        self.feature: Optional[FeatureCache] = \
            FeatureCache(self) if settings.feature_cache else None

    # -- sizing ----------------------------------------------------------

    def size_hint(self, nbytes: int) -> None:
        """The loader's clip-cache budget; later arenas without an
        explicit ``pool_mb`` inherit it."""
        with self.lock:
            if nbytes and nbytes > 0:
                self._size_hint_bytes = int(nbytes)

    def resolve_budget(self, requested: Optional[int] = None) -> int:
        """Arena byte budget: explicit ``pool_mb`` wins; else the
        caller's own figure; else the size hint; else the default."""
        if self.settings.pool_mb is not None:
            return int(self.settings.pool_mb * (1 << 20))
        if requested and requested > 0:
            return int(requested)
        with self.lock:
            if self._size_hint_bytes:
                return self._size_hint_bytes
        return DEFAULT_ARENA_MB << 20

    # -- arenas ----------------------------------------------------------

    def create_arena(self, name: str, row_shape, dtype: torch.dtype,
                     budget_bytes: Optional[int] = None, device=None,
                     gather_keys: Tuple[str, str] = ("gathers",
                                                     "gather_rows")
                     ) -> Arena:
        arena = Arena(self, name, row_shape, dtype,
                      self.resolve_budget(budget_bytes), device=device,
                      gather_keys=gather_keys)
        with self.lock:
            self._arenas.append(arena)
        return arena

    def adopt_shared(self, name: str, tensor: torch.Tensor) -> None:
        """Mark a pager-owned device tensor (the zero pools hits and
        feature hits dispatch with) so :meth:`owns` knows it, and account
        it under the page_pool owner."""
        with self.lock:
            self._owned_ids[id(tensor)] = tensor
        memledger.register("page_pool", str(tensor.device),
                           ("pager-shared", name),
                           tensor.numel() * tensor.element_size(),
                           live=True)

    def arena_sizes(self) -> Dict[str, Dict[str, int]]:
        """Each arena's pages and bytes, by name, for the ``Pages
        arenas:`` log-meta line: the feature arena's budget depends on
        whether the loader's size hint came first."""
        with self.lock:
            return {a.name: {"pages": a.num_pages,
                             "page_bytes": a.page_bytes, "bytes": a.nbytes}
                    for a in self._arenas}

    def owns(self, tensor) -> bool:
        with self.lock:
            return id(tensor) in self._owned_ids

    # -- counters --------------------------------------------------------

    def note_feature_saved(self, nbytes: int) -> None:
        """Wire bytes a feature hit did not ship host->device."""
        with self.lock:
            self.counters["feature_bytes_saved"] += int(nbytes)

    def snapshot(self) -> Dict[str, int]:
        """Counters and occupancy for the ``Pages:`` log-meta line."""
        with self.lock:
            snap = dict(self.counters)
            snap["arenas"] = len(self._arenas)
            snap["pages"] = sum(a.num_pages for a in self._arenas)
            snap["page_rows"] = int(self.settings.page_rows)
            snap["live"] = sum(a.live_pages_locked() for a in self._arenas)
            snap["limbo"] = sum(len(a._limbo) for a in self._arenas)
            snap["bytes"] = sum(a.nbytes for a in self._arenas)
            snap["feature_entries"] = (len(self.feature._entries)
                                       if self.feature is not None else 0)
            return snap
