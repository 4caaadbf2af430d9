"""R(2+1)D pipeline stages: path iterator, fused loader, runner.

Counterpart of ``rnb_tpu/models/r2p1d/model.py`` for the fused serving
paths: yuv420 (``configs/rnb-fused-yuv-big.json`` and its ragged form)
and dct (``configs/rnb-fused-dct-ragged.json``):

* :class:`R2P1DFusingLoader` decodes requests on host threads into the
  pixel path's wire rows — packed 4:2:0 planes (uint8) or packed
  dequantized DCT coefficients (int16) — and fuses ready requests into
  one batch, padded to a row bucket or shipped as the one ragged pool
  shape with ``rows_valid`` and a segment table, assembled in a pinned
  staging slot and sent to the card on a dedicated stream;
* :class:`R2P1DRunner` runs the pixel path's ingest kernels and
  R(2+1)D layers [start..end] on the batch; one network and one
  parameter copy per (range, device) serve every replica.

With ``cache_mb`` the loader keeps a clip cache and coalesces requests
for a video that is decoding (``configs/rnb-fused-yuv-zipf-cache.json``);
with the root ``pager`` key the cache lives on pages of one device slab,
hits are gathered on the card, and feature pages let a repeated request
skip the forward (``configs/rnb-fused-yuv-paged-zipf.json``).

Not yet ported from the reference stages: the unfused loader and its
hit path, the autotune controller, fault containment, the rgb pixel
path, the native decode pool, sharding.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from rnb_tpu_torch.cache import ClipCache, InflightTable, content_key
from rnb_tpu_torch.decode import get_decoder
from rnb_tpu_torch.models.r2p1d.checkpoint import init_variables
from rnb_tpu_torch.models.r2p1d.network import (KINETICS_CLASSES,
                                                NUM_LAYERS, R18_LAYER_SIZES,
                                                R2Plus1DClassifier,
                                                cast_compute_weights,
                                                range_output_shape)
from rnb_tpu_torch.models.r2p1d.sampler import R2P1DSampler
from rnb_tpu_torch.ops.dct import (dct_frame_elems, default_dct_coeffs,
                                   normalize_dct, ragged_normalize_dct)
from rnb_tpu_torch.ops.ragged import (ragged_normalize_yuv420,
                                      resolve_pool_rows, segment_offsets_of)
from rnb_tpu_torch.ops.yuv import normalize_yuv420, packed_frame_bytes
from rnb_tpu_torch.stage import (PadCounter, PaddedBatch, RaggedBatch,
                                 StageModel, normalize_row_buckets)
from rnb_tpu_torch.staging import StagingPool, TransferWorker
from rnb_tpu_torch.telemetry import TimeCardList, cards_of
from rnb_tpu_torch.video_path_provider import (VideoPathIterator,
                                               scan_video_tree)

MAX_CLIPS = 15
CONSECUTIVE_FRAMES = 8
FRAME_HW = 112
NUM_WARMUPS = 3  # reference warm-up convention
#: the seed every stage's weights are drawn from
WEIGHT_SEED = 0
PIXEL_PATHS = ("yuv420", "dct")
#: the synthetic ids the path iterator cycles when there is no dataset
NUM_SYNTHETIC_VIDEOS = 200

_cache_lock = threading.Lock()
_network_cache: Dict[tuple, torch.nn.Module] = {}


def _check_pixel_path(pixel_path: str) -> None:
    if pixel_path not in PIXEL_PATHS:
        raise ValueError("pixel_path %r is not yet ported to rnb_tpu_torch "
                         "(ported: %s)" % (pixel_path, PIXEL_PATHS))


def _dct_coeffs(pixel_path: str, dct_coeffs_per_frame) -> Optional[int]:
    """The dct wire's per-frame coefficient budget (the default rule
    when unset); None on the other paths, which refuse the key."""
    if pixel_path != "dct":
        if dct_coeffs_per_frame is not None:
            raise ValueError("dct_coeffs_per_frame only applies to "
                             "pixel_path='dct'")
        return None
    if dct_coeffs_per_frame is None:
        return default_dct_coeffs(FRAME_HW, FRAME_HW)
    if int(dct_coeffs_per_frame) < 1:
        raise ValueError("dct_coeffs_per_frame must be >= 1, got %r"
                         % (dct_coeffs_per_frame,))
    return int(dct_coeffs_per_frame)


def _wire_batch_shape(rows: int, pixel_path: str,
                      dct_coeffs: Optional[int] = None) -> tuple:
    """A batch of wire rows, ``(rows, frames, elems)``: packed 4:2:0
    bytes, or packed int16 coefficients under dct."""
    if pixel_path == "dct":
        elems = dct_frame_elems(FRAME_HW, FRAME_HW, dct_coeffs)
    else:
        elems = packed_frame_bytes(FRAME_HW, FRAME_HW)
    return (int(rows), CONSECUTIVE_FRAMES, elems)


def _wire_dtype(pixel_path: str) -> torch.dtype:
    return torch.int16 if pixel_path == "dct" else torch.uint8


def _device_of(device) -> torch.device:
    """Accept a DeviceSpec or a torch.device."""
    return device.resolve() if hasattr(device, "resolve") else \
        torch.device(device)


def default_ragged_chunk(pool_rows: int) -> int:
    """Auto row-chunk for the ragged tile loop: the largest divisor of
    the pool capacity no bigger than a third of it, floored at 1."""
    pool_rows = int(pool_rows)
    for d in range(max(1, pool_rows // 3), 0, -1):
        if pool_rows % d == 0:
            return d
    return 1


def shared_network(start: int, end: int, num_classes: int,
                   layer_sizes: tuple, device: torch.device,
                   dtype: torch.dtype = torch.bfloat16) -> torch.nn.Module:
    """The one network (and parameter copy) per (range, device): weights
    drawn from ``WEIGHT_SEED``, filtered to the range, cast once to the
    compute dtype."""
    key = (start, end, num_classes, tuple(layer_sizes), str(device), dtype)
    with _cache_lock:
        net = _network_cache.get(key)
        if net is None:
            net = R2Plus1DClassifier(start, end, num_classes, layer_sizes,
                                     dtype=dtype)
            net.load_state_dict(init_variables(
                WEIGHT_SEED, start, end, num_classes, layer_sizes))
            net = cast_compute_weights(net).to(device).eval()
            _network_cache[key] = net
        return net


class R2P1DVideoPathIterator(VideoPathIterator):
    """Cycles a video dataset forever: ``root`` (or $RNB_TPU_DATA_ROOT)
    holds ``label/video`` files (.y4m, .mjpg/.mjpeg). Without one it
    cycles the reference's fixed population of ``synth://`` ids, which
    the decode layer makes procedurally."""

    def __init__(self, root: Optional[str] = None):
        root = root or os.environ.get("RNB_TPU_DATA_ROOT")
        videos = scan_video_tree(root) if root and os.path.isdir(root) \
            else []
        if not videos:
            videos = ["synth://kinetics/video-%04d" % i
                      for i in range(NUM_SYNTHETIC_VIDEOS)]
        self._videos = videos

    def dataset(self):
        """The finite universe, for the Zipf popularity wrapper."""
        return list(self._videos)

    def __iter__(self):
        return itertools.cycle(self._videos)


def _completed(value) -> Future:
    """A future that already holds ``value``: the rows of a hit, which
    need no decode, ride the fused window like a finished decode."""
    future: Future = Future()
    future.set_result(value)
    return future


class _FuseRecord:
    """One request of the fusing loader: where its rows come from (a
    decode future, a ragged blob hit's rows, or a paged hit's gather
    plan), its clip row count, and every TimeCard riding on it — the
    leader's and any coalesced followers', which share its rows."""

    __slots__ = ("future", "n", "cards", "key", "fkey", "plan", "t_ready")

    def __init__(self, future, n, card, key=None, fkey=None, plan=None):
        self.future = future
        self.n = n
        self.cards = [card]
        self.key = key     # cache key to insert under, None for a hit
        self.fkey = fkey   # content key for the feature-page insert
        self.plan = plan   # paged hit: its pinned GatherPlan
        self.t_ready = 0.0


class R2P1DFusingLoader(StageModel):
    """Decode stage with loader-side dynamic batching.

    Each request is submitted to a decode thread pool at once; requests
    whose decode finished are taken in FIFO order and emitted as ONE
    fused batch with a TimeCardList. Emission policy (the reference's):

      * emit when ``fuse`` requests are ready or their rows reach the
        max shape;
      * emit a partial batch when nothing is left in flight;
      * emit when the oldest ready request has waited ``max_hold_ms``;
      * block on the oldest in-flight decode once ``2 * fuse``
        requests are pending (backpressure toward the client queue).

    A batch is assembled in a pinned staging slot and transferred to
    the card on a dedicated stream; with ``transfer_async`` the
    transfer runs on a worker thread while the next batch decodes.
    Bucketed emissions zero their pad rows; ragged emissions ship the
    pool shape and leave the tail as it is — the ingest kernels treat
    rows past ``rows_valid`` as zero bytes.

    With ``cache_mb`` a clip cache serves repeated videos
    (:mod:`rnb_tpu_torch.cache`): a bucketed hit is emitted at once as
    its cached device batch; a ragged hit rides the next pool — a blob
    hit copies its host rows in, a paged hit (after ``enable_pager``)
    ships its slot rows as they are and has them overwritten on the
    card by the clip arena's gather after the transfer. A request whose
    video is decoding parks on that decode (coalescing). With feature
    pages, a request whose logits are stored skips decode, transfer and
    the forward: it is emitted at once as a stub, and the runner
    gathers its logits.
    """

    SUPPORTS_RAGGED = True
    SUPPORTS_PAGER = True

    #: staging depth: one slot filling, one transferring, one spare
    DEFAULT_STAGING_SLOTS = 3

    #: harvest-check tick while decodes are in flight
    HARVEST_TICK_S = 0.005
    #: ready-queue poll tick while draining the transfer worker
    FLUSH_TICK_S = 0.0005

    def __init__(self, device, fuse: int = 6, max_hold_ms: float = 5.0,
                 max_clips: int = MAX_CLIPS, num_warmups: int = NUM_WARMUPS,
                 row_buckets=None,
                 pixel_path: str = "rgb", staging_slots=None,
                 transfer_async: bool = False, ragged: bool = False,
                 ragged_pool_rows=None, dct_coeffs_per_frame=None,
                 cache_mb=None):
        super().__init__(device)
        _check_pixel_path(pixel_path)
        self.dct_coeffs = _dct_coeffs(pixel_path, dct_coeffs_per_frame)
        if int(fuse) < 1:
            raise ValueError("fuse must be >= 1, got %r" % (fuse,))
        self.torch_device = _device_of(device)
        self.pixel_path = pixel_path
        self.fuse = int(fuse)
        self.depth = 2 * self.fuse
        self.max_hold_ms = float(max_hold_ms)
        self.max_clips = int(max_clips)
        self.sampler = R2P1DSampler(consecutive_frames=CONSECUTIVE_FRAMES)
        self.row_buckets = normalize_row_buckets(row_buckets,
                                                 self.max_clips,
                                                 "max_clips")
        self.ragged = bool(ragged)
        self.pool_rows = (resolve_pool_rows(ragged_pool_rows,
                                            self.max_clips, "max_clips")
                          if self.ragged else None)
        self.padding = PadCounter()
        self.ragged_stats = ({"pool_rows": self.pool_rows, "emissions": 0,
                              "rows": 0, "pad_rows_eliminated": 0,
                              "cache_hit_rows": 0}
                             if self.ragged else None)
        slots = (self.DEFAULT_STAGING_SLOTS if staging_slots is None
                 else int(staging_slots))
        self.staging = StagingPool(self._batch_shape(self.max_clips),
                                   slots, self.torch_device,
                                   _wire_dtype(pixel_path))
        #: the pixel path and every decode backend that served a request
        self.ingest_stats = {"pixel_path": pixel_path, "backends": set()}
        self.transfer_async = bool(transfer_async)
        self._worker = (TransferWorker(self.staging)
                        if self.transfer_async else None)
        self._decode_pool = ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            thread_name_prefix="rnb-decode")
        self._starts_cache: Dict[str, list] = {}
        self._inflight: deque = deque()  # decode still running
        self._ready: deque = deque()     # decode complete
        #: completed emissions awaiting pickup; appended by the
        #: transfer worker under transfer_async
        self._out_ready: deque = deque()
        self._out_lock = threading.Lock()
        self.cache = None
        self._inflight_keys = None
        if cache_mb:
            self.cache = ClipCache(cache_mb, device=self.torch_device)
            self._inflight_keys = InflightTable()
            # decode-config fingerprint: everything that changes the
            # decoded bytes or the cached value's shape (the clip starts
            # are deterministic per video id given the sampler)
            self._cache_cfg = (
                "r2p1d", tuple(self.sampler.num_clips_population),
                tuple(float(p) for p in self.sampler.probabilities),
                CONSECUTIVE_FRAMES, FRAME_HW, self.pixel_path,
                self.max_clips, self.row_buckets,
                # ragged entries are host rows or pages, bucketed ones
                # padded device batches: the two never alias
                self.ragged, self.dct_coeffs)
        #: the page allocator and its clip arena (``enable_pager``)
        self.pager = None
        self._clip_arena = None
        self._zero_pool = None
        # warm-up: fault in the pinned slots and the transfer path at
        # every shape an emission ships
        for rows in self._warm_shapes():
            for _ in range(num_warmups):
                self.staging.transfer(self.staging.acquire(), rows)
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)

    @classmethod
    def output_shape_for(cls, max_clips: int = MAX_CLIPS,
                         pixel_path: str = "rgb",
                         dct_coeffs_per_frame=None, **_kwargs):
        return (_wire_batch_shape(max_clips, pixel_path, _dct_coeffs(
            pixel_path, dct_coeffs_per_frame)),)

    def enable_pager(self, pager) -> None:
        """Executor protocol: install the page allocator before the start
        barrier. The clip cache's entries become page reference lists in
        a ``clips`` arena sized from ``cache_mb``, and the loader
        allocates the one zero pool a feature hit ships as its stub (the
        runner gathers its own rows and never reads it; on the wire
        paths the stub is the zero wire pool itself). Needs ragged
        dispatch and a clip cache, as in the reference."""
        if not self.ragged:
            raise ValueError(
                "pager requires ragged dispatch: paged gathers overlay "
                "rows of the ONE pool shape (configure the root 'ragged' "
                "key)")
        if self.cache is None:
            raise ValueError(
                "pager requires an enabled clip cache (cache_mb): the page "
                "arena replaces its blob storage")
        self.pager = pager
        pager.size_hint(self.cache.capacity_bytes)
        self._clip_arena = pager.create_arena(
            "clips", self._batch_shape(1)[1:], _wire_dtype(self.pixel_path),
            budget_bytes=self.cache.capacity_bytes, device=self.torch_device)
        self.cache.attach_arena(self._clip_arena)
        self._zero_pool = torch.zeros(self._batch_shape(self.pool_rows),
                                      dtype=_wire_dtype(self.pixel_path),
                                      device=self.torch_device)
        pager.adopt_shared("loader-zero-pool", self._zero_pool)
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)

    def _batch_shape(self, rows: int):
        return _wire_batch_shape(rows, self.pixel_path, self.dct_coeffs)

    def _warm_shapes(self):
        return (self.pool_rows,) if self.ragged else self.row_buckets

    def _bucket_for(self, n: int) -> int:
        for bucket in self.row_buckets:
            if n <= bucket:
                return bucket
        return self.row_buckets[-1]

    def _sample_starts(self, decoder, video: str):
        """Clip starts for one video, cached: the sampler is
        deterministic per video id."""
        starts = self._starts_cache.get(video)
        if starts is None:
            starts = [int(s) for s in self.sampler.sample(
                decoder.num_frames(video), video_id=video)]
            starts = starts[: self.max_clips]
            self._starts_cache[video] = starts
        return starts

    # -- the clip cache and feature pages ---------------------------------

    def _feature_probe(self, video: str):
        """(content key, plan) from the feature pages, probed ahead of
        the clip cache; (None, None) when feature pages are off, (key,
        None) on a miss (the key then serves the clip-cache lookup)."""
        if self.pager is None or self.pager.feature is None \
                or self.cache is None:
            return None, None
        key = content_key(video, self._cache_cfg)
        return key, self.pager.feature.acquire(key)

    def _cache_lookup(self, video: str, key=None):
        """(key, entry) for one request, (None, None) without a cache. A
        paged hit is a pinned GatherPlan, a blob hit a CacheEntry."""
        if self.cache is None:
            return None, None
        if key is None:
            key = content_key(video, self._cache_cfg)
        if self.cache.paged:
            return key, self.cache.acquire(key)
        return key, self.cache.lookup(key)

    def _stamp_feature_insert(self, time_card, key, row0: int,
                              n: int) -> None:
        """Mark a request's pool rows as a feature-insert candidate; the
        runner inserts its output rows after its forward returned."""
        if self.pager is not None and self.pager.feature is not None \
                and self.pager.feature.ready and key is not None:
            time_card.feature_insert = (key, int(row0), int(n))

    def _drop_coalesce(self, rec: _FuseRecord) -> None:
        """Close a record's coalescing window: later requests for its
        key consult the cache or decode afresh."""
        if self._inflight_keys is not None:
            self._inflight_keys.pop(rec.key)

    def _note_emission(self, valid: int, shipped: int, cards) -> None:
        """Padding and ragged accounting for one emission (the
        reference's rule): a ragged emission computes no pad rows and
        counts what the bucketed rule would have shipped in
        ``pad_rows_eliminated``; the pad count rides the first card."""
        pad = self.padding.note(valid, valid if self.ragged else shipped)
        if self.ragged:
            self.ragged_stats["emissions"] += 1
            self.ragged_stats["rows"] += valid
            self.ragged_stats["pad_rows_eliminated"] += \
                self._bucket_for(valid) - valid
        for idx, tc in enumerate(cards):
            tc.pad_rows = pad if idx == 0 else 0

    def _emit_feature(self, plan, time_card):
        """A feature-page hit, emitted at once as its own dispatch: the
        stub pool goes downstream (never read), and the pinned plan rides
        the card to the runner, which gathers the stored logits and
        releases it."""
        n = plan.valid
        time_card.num_clips = n
        time_card.row0 = 0
        time_card.feature_hit = True
        time_card.feature_plan = plan
        self.pager.note_feature_saved(n * self._clip_arena.row_bytes)
        self.staging.note_bypassed()
        self._note_emission(n, self.pool_rows, [time_card])
        return ((RaggedBatch(self._zero_pool, n, (0, n)),), None,
                TimeCardList([time_card]))

    def _emit_hit(self, entry, time_card):
        """A bucketed blob hit, emitted at once as its cached device
        batch: there is no decode to overlap, so holding it for fusion
        would only add latency."""
        time_card.num_clips = entry.valid
        time_card.row0 = 0
        time_card.cache_hit = True
        self._note_emission(entry.valid, int(entry.batch.shape[0]),
                            [time_card])
        return ((PaddedBatch(entry.batch, entry.valid),), None,
                TimeCardList([time_card]))

    # -- admission ----------------------------------------------------------

    def __call__(self, tensors, non_tensors, time_card):
        video = str(non_tensors)
        time_card.video = video
        fkey, fplan = self._feature_probe(video)
        if fplan is not None:
            return self._emit_feature(fplan, time_card)
        key, entry = self._cache_lookup(video, key=fkey)
        if entry is not None and self.ragged:
            # a ragged hit fills its pool rows like a decode that
            # finished at once, and joins the window in arrival order
            n = entry.valid
            time_card.num_clips = n
            time_card.cache_hit = True
            self.ragged_stats["cache_hit_rows"] += n
            if self.cache.paged:
                rec = _FuseRecord(_completed(None), n, time_card,
                                  fkey=fkey, plan=entry)
            else:
                rec = _FuseRecord(_completed(entry.batch), n, time_card,
                                  fkey=fkey)
            self._inflight.append(rec)
            out = self.poll()
            return out if out is not None else (None, None, None)
        if entry is not None:
            return self._emit_hit(entry, time_card)
        if key is not None:
            time_card.cache_hit = False
            live = self._inflight_keys.get(key)
            if live is not None:
                # coalesce: ride the leader's decode and row range
                time_card.num_clips = live.n
                time_card.cache_coalesced = True
                self.cache.note_coalesced()
                live.cards.append(time_card)
                out = self.poll()
                return out if out is not None else (None, None, None)
        decoder = get_decoder(video)
        starts = self._sample_starts(decoder, video)
        time_card.num_clips = len(starts)
        self.ingest_stats["backends"].add(decoder.BACKEND)
        if self.pixel_path == "dct":
            future = self._decode_pool.submit(
                decoder.decode_clips_dct, video, starts, CONSECUTIVE_FRAMES,
                FRAME_HW, FRAME_HW, self.dct_coeffs)
        else:
            future = self._decode_pool.submit(
                decoder.decode_clips_yuv, video, starts, CONSECUTIVE_FRAMES,
                FRAME_HW, FRAME_HW)
        rec = _FuseRecord(future, len(starts), time_card, key=key,
                          fkey=fkey)
        if key is not None:
            self._inflight_keys.put(key, rec)
        self._inflight.append(rec)
        out = self.poll()
        if out is not None:
            return out
        if len(self._inflight) >= self.depth:
            # backpressure: retire the oldest decode before accepting
            # more work, then ship what is ready
            self._retire_oldest()
            self._harvest()
            self._emit()
            out = self._pop_ready()
            if out is not None:
                return out
        return None, None, None

    def _retire_oldest(self) -> None:
        rec = self._inflight.popleft()
        rec.future.result()  # a decode error fails the run here
        rec.t_ready = time.monotonic()
        self._ready.append(rec)

    def _harvest(self) -> None:
        """Move decode-complete requests to ready, in FIFO order."""
        while self._inflight and self._inflight[0].future.done():
            rec = self._inflight.popleft()
            rec.future.result()
            rec.t_ready = time.monotonic()
            self._ready.append(rec)

    # -- emission -------------------------------------------------------------

    def _emit(self) -> bool:
        """Fuse ready requests (up to ``fuse`` / the max rows) into one
        batch and ship it. False when nothing was ready."""
        take, rows = [], 0
        while self._ready and len(take) < self.fuse:
            n = self._ready[0].n
            if take and rows + n > self.max_clips:
                break
            rec = self._ready.popleft()
            # finalizing: a later same-key request consults the cache
            self._drop_coalesce(rec)
            take.append(rec)
            rows += n
        if not take:
            return False
        if rows > self.max_clips:
            raise RuntimeError("fused %d rows over max_clips=%d"
                               % (rows, self.max_clips))
        shipped = self.pool_rows if self.ragged else self._bucket_for(rows)
        paged = self.cache is not None and self.cache.paged
        offsets = segment_offsets_of(rec.n for rec in take)
        slot = self.staging.acquire()
        cards, gather_plans, insert_jobs = [], [], []
        for i, rec in enumerate(take):
            row0 = offsets[i]
            if rec.plan is None:
                slot.array[row0:row0 + rec.n] = rec.future.result()
            else:
                # a paged hit ships its slot rows as they are: the clip
                # arena's gather overwrites them after the transfer
                gather_plans.append((row0, rec.plan))
            for tc in rec.cards:
                tc.row0 = row0
            cards.extend(rec.cards)
            if paged:
                if rec.plan is None and rec.key is not None:
                    insert_jobs.append((rec.key, row0, rec.n))
                self._stamp_feature_insert(rec.cards[0], rec.fkey, row0,
                                           rec.n)
            elif self.cache is not None and rec.key is not None:
                # insert-after-success: the decode completed; both blob
                # inserts copy the rows out before the slot is reused
                if self.ragged:
                    self.cache.insert_rows(rec.key, rec.future.result(),
                                           rec.n)
                else:
                    self.cache.insert_host(
                        rec.key, rec.future.result(), rec.n,
                        self._batch_shape(self._bucket_for(rec.n)),
                        _wire_dtype(self.pixel_path))
        if not self.ragged:
            slot.array[rows:shipped] = 0
        self._note_emission(rows, shipped, cards)

        def job():
            batch = self.staging.transfer(slot, shipped)
            if gather_plans or insert_jobs:
                batch = self._overlay_pages(batch, gather_plans,
                                            insert_jobs)
            if self.ragged:
                wrapped = RaggedBatch(batch, rows, offsets)
            else:
                wrapped = PaddedBatch(batch, rows)
            with self._out_lock:
                self._out_ready.append(((wrapped,), None,
                                        TimeCardList(cards)))

        if self._worker is not None:
            self._worker.submit(job)
        else:
            job()
        return True

    def _overlay_pages(self, batch, gather_plans, insert_jobs):
        """The paged cache's device work for one emission, after its
        transfer and before it is published: gather the hit rows from the
        clip arena over the pool, release their plans, and publish the
        miss rows into pages (insert-after-success: decode and transfer
        are done). The arena's work is ordered after the transfer stream
        and confirmed before returning, so the runner's ingest never
        reads a pool row the gather has not written."""
        stream = self.staging.stream
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            if gather_plans:
                src = np.full((int(batch.shape[0]),), -1, np.int32)
                for row0, plan in gather_plans:
                    src[row0:row0 + plan.valid] = plan.src_rows
                batch = self._clip_arena.gather(batch, src)
                for _, plan in gather_plans:
                    # issued on the arena stream: a later write of these
                    # pages runs after it, so the pins can go
                    plan.release()
            for key, row0, n in insert_jobs:
                self.cache.insert_pages(key, batch, row0, n)
        self._clip_arena.synchronize()
        return batch

    def _pop_ready(self):
        with self._out_lock:
            return self._out_ready.popleft() if self._out_ready else None

    def take_ready(self):
        """A completed fused emission, or None; re-raises a failure of
        the transfer worker on the executor thread."""
        if self._worker is not None:
            self._worker.raise_if_failed()
        return self._pop_ready()

    def next_deadline_s(self):
        """Seconds until this stage next needs an idle poll, or None
        when it holds no work."""
        with self._out_lock:
            if self._out_ready:
                return 0.0
        self._harvest()
        if self._ready:
            if not self._inflight:
                return 0.0
            waited = time.monotonic() - self._ready[0].t_ready
            remaining = max(0.0, self.max_hold_ms / 1000.0 - waited)
            return min(remaining, self.HARVEST_TICK_S)
        if self._inflight:
            return self.HARVEST_TICK_S
        if self._worker is not None and self._worker.outstanding():
            return self.HARVEST_TICK_S
        return None

    def poll(self):
        """Idle tick: emit a held batch that meets an emission rule.
        Returns an emission or None."""
        out = self._pop_ready()
        if out is not None:
            return out
        self._harvest()
        if not self._ready:
            return None
        rows_ready = sum(rec.n for rec in self._ready)
        waited_s = time.monotonic() - self._ready[0].t_ready
        if (len(self._ready) >= self.fuse or rows_ready >= self.max_clips
                or not self._inflight
                or waited_s * 1000.0 > self.max_hold_ms):
            self._emit()
            return self._pop_ready()
        return None

    def flush(self):
        """End of stream: drain everything, one fused batch per call
        (the executor calls until None)."""
        out = self._pop_ready()
        if out is not None:
            return out
        while self._inflight:
            self._retire_oldest()
        while True:
            if self._ready:
                self._emit()
                out = self._pop_ready()
                if out is not None:
                    return out
                continue
            if self._worker is not None and self._worker.outstanding():
                self._worker.raise_if_failed()
                time.sleep(self.FLUSH_TICK_S)
                out = self._pop_ready()
                if out is not None:
                    return out
                continue
            if self._worker is not None:
                self._worker.raise_if_failed()
            return None

    def discard_pending(self) -> None:
        """Teardown: drop unemitted work, release the page pins of
        unemitted hits, and stop the helper threads."""
        for rec in list(self._inflight) + list(self._ready):
            self._drop_coalesce(rec)
            if rec.plan is not None:
                rec.plan.release()
        self._inflight.clear()
        self._ready.clear()
        if self._worker is not None:
            self._worker.close()
        self._decode_pool.shutdown(wait=True, cancel_futures=True)
        with self._out_lock:
            self._out_ready.clear()


class R2P1DRunner(StageModel):
    """Network stage over the layer range [start..end] with the fused
    ingest of its pixel path in front of layer 1: yuv420 planes through
    the colourspace and normalize kernels, dct coefficient rows through
    the unpack and IDCT/convert kernels.

    Bucketed mode takes ``PaddedBatch`` es at the warmed row buckets.
    Ragged mode takes the one pool shape plus ``rows_valid``: the
    ingest kernels mask the pool tail, and with ``ragged_chunk_rows``
    the network runs ``ceil(rows_valid / chunk)`` row tiles — host-side
    slicing by the host integer ``rows_valid`` — so network work scales
    with the valid rows; pad rows of the output stay zero.

    With feature pages (``enable_pager``) the runner stores each
    stamped request's output rows after its forward returned, and
    answers a feature hit by gathering them back over a zero logit pool
    without running the ingest or the network.
    """

    SUPPORTS_RAGGED = True
    SUPPORTS_PAGER = True

    def __init__(self, device, start_index: int = 1,
                 end_index: int = NUM_LAYERS,
                 num_classes: int = KINETICS_CLASSES,
                 layer_sizes=R18_LAYER_SIZES, max_rows: int = MAX_CLIPS,
                 num_warmups: int = NUM_WARMUPS, row_buckets=None,
                 pixel_path: str = "rgb", ragged: bool = False,
                 ragged_pool_rows=None, ragged_chunk_rows=None,
                 dct_coeffs_per_frame=None,
                 network: Optional[torch.nn.Module] = None):
        super().__init__(device)
        _check_pixel_path(pixel_path)
        self.pixel_path = pixel_path
        self.dct_coeffs = _dct_coeffs(pixel_path, dct_coeffs_per_frame)
        if not (1 <= start_index <= end_index <= NUM_LAYERS):
            raise ValueError("invalid layer range [%s..%s]"
                             % (start_index, end_index))
        if start_index != 1:
            raise ValueError("pixel_path=%r fuses the ingest in front of "
                             "layer 1; a [%d..%d] stage receives "
                             "activations, not frames"
                             % (pixel_path, start_index, end_index))
        self.torch_device = _device_of(device)
        self.start_index, self.end_index = int(start_index), int(end_index)
        self.num_classes = int(num_classes)
        self.layer_sizes = tuple(layer_sizes)
        self.max_rows = int(max_rows)
        #: the page allocator and the feature arena (``enable_pager``)
        self.pager = None
        self._feature_arena = None
        self._logit_pool = None
        self.ragged = bool(ragged)
        self.pool_rows = (resolve_pool_rows(ragged_pool_rows,
                                            self.max_rows, "max_rows")
                          if self.ragged else None)
        self.ragged_chunk_rows = 0
        if self.ragged:
            if ragged_chunk_rows is None:
                self.ragged_chunk_rows = default_ragged_chunk(
                    self.pool_rows)
            else:
                self.ragged_chunk_rows = int(ragged_chunk_rows)
                if self.ragged_chunk_rows < 0 or (
                        self.ragged_chunk_rows
                        and self.pool_rows % self.ragged_chunk_rows):
                    raise ValueError(
                        "ragged_chunk_rows=%r must be 0 (whole-pool "
                        "apply) or a positive divisor of pool_rows=%d"
                        % (ragged_chunk_rows, self.pool_rows))
        #: the network; tests hand in their own (bridged weights)
        self.network = network if network is not None else shared_network(
            self.start_index, self.end_index, int(num_classes),
            tuple(layer_sizes), self.torch_device)
        self._out_row_shape = range_output_shape(
            self.start_index, self.end_index, CONSECUTIVE_FRAMES,
            int(num_classes))
        warm_rows = ((self.pool_rows,) if self.ragged else
                     normalize_row_buckets(row_buckets, self.max_rows,
                                           "max_rows"))
        for rows in warm_rows:
            dummy = torch.zeros(
                _wire_batch_shape(rows, pixel_path, self.dct_coeffs),
                dtype=_wire_dtype(pixel_path), device=self.torch_device)
            for _ in range(num_warmups):
                self.forward(dummy, rows)
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)

    @classmethod
    def output_shape_for(cls, start_index: int = 1,
                         end_index: int = NUM_LAYERS,
                         num_classes: int = KINETICS_CLASSES,
                         max_rows: int = MAX_CLIPS, **_kwargs):
        return ((int(max_rows),) + range_output_shape(
            int(start_index), int(end_index), CONSECUTIVE_FRAMES,
            int(num_classes)),)

    def enable_pager(self, pager) -> None:
        """Executor protocol: attach as the feature-page consumer before
        the start barrier. The stage's fingerprint keys every entry, its
        ``features`` arena holds float32 logit rows (budget: the pager's
        size hint, or the default when this runs before the loader's),
        and a zero logit pool is what hits gather over. Refused, as in
        the reference, unless the stage is ragged and ends the network;
        the reference's third refusal, a sharded stage, cannot arise:
        the config reader refuses ``shard``."""
        self.pager = pager
        if pager.feature is None:
            return
        if not self.ragged:
            raise ValueError(
                "pager.feature_cache requires ragged dispatch on the "
                "consuming stage: feature rows gather into the ONE pool "
                "shape")
        if self.end_index != NUM_LAYERS:
            raise ValueError(
                "pager.feature_cache requires the consuming stage to end "
                "the network (end_index=%d): cached rows must be final "
                "outputs" % (self.end_index,))
        fingerprint = (
            "r2p1d-logits", self.start_index, self.end_index,
            self.num_classes, self.layer_sizes, False, CONSECUTIVE_FRAMES,
            self.pixel_path, self.dct_coeffs)
        self._feature_arena = pager.create_arena(
            "features", (self.num_classes,), torch.float32,
            device=self.torch_device,
            gather_keys=("feature_gathers", "feature_gather_rows"))
        pager.feature.attach(self._feature_arena, fingerprint)
        self._logit_pool = torch.zeros((self.pool_rows, self.num_classes),
                                       dtype=torch.float32,
                                       device=self.torch_device)
        pager.adopt_shared("runner-logit-pool", self._logit_pool)
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)

    def _take_feature_plan(self, time_card):
        """The pinned feature-page plan riding this dispatch's card, if
        any, taken off the card."""
        if self.pager is None or self.pager.feature is None:
            return None
        for tc in cards_of(time_card):
            plan = getattr(tc, "feature_plan", None)
            if plan is not None:
                tc.feature_plan = None
                return plan
        return None

    def _insert_features(self, out: torch.Tensor, time_card) -> None:
        """Store this forward's output rows for every request the loader
        stamped (insert-after-success: the forward has returned)."""
        feature = None if self.pager is None else self.pager.feature
        if feature is None or not feature.ready:
            return
        for tc in cards_of(time_card):
            job = getattr(tc, "feature_insert", None)
            if job is not None:
                tc.feature_insert = None
                key, row0, n = job
                feature.insert(key, out, row0, n)

    def _ingest(self, x: torch.Tensor, rows_valid: int) -> torch.Tensor:
        """Wire rows -> normalized bf16 NDHWC frames."""
        if self.pixel_path == "dct":
            if not self.ragged:
                return normalize_dct(x, FRAME_HW, FRAME_HW)
            return ragged_normalize_dct(x, rows_valid, FRAME_HW, FRAME_HW)
        if not self.ragged:
            return normalize_yuv420(x, FRAME_HW, FRAME_HW)
        return ragged_normalize_yuv420(x, rows_valid, FRAME_HW, FRAME_HW)

    @torch.inference_mode()
    def forward(self, x: torch.Tensor, rows_valid: int) -> torch.Tensor:
        """Wire rows ``(rows, F, elems)`` -> float32 outputs ``(rows,
        ...)``; ``rows_valid`` matters in ragged mode only."""
        xin = self._ingest(x, rows_valid)
        if not self.ragged:
            return self.network(xin)
        chunk = self.ragged_chunk_rows
        rows = int(xin.shape[0])
        if chunk <= 0 or chunk >= rows:
            return self.network(xin)
        # tile 0 always runs (an emission carries >= 1 valid row); the
        # rest run while they hold valid rows
        num_tiles = max(1, min(math.ceil(rows_valid / chunk),
                               rows // chunk))
        out = torch.zeros((rows,) + self._out_row_shape,
                          dtype=torch.float32, device=xin.device)
        for i in range(num_tiles):
            out[i * chunk:(i + 1) * chunk] = self.network(
                xin[i * chunk:(i + 1) * chunk])
        return out

    def __call__(self, tensors, non_tensors, time_card):
        pb = tensors[0]
        fplan = self._take_feature_plan(time_card)
        if fplan is not None:
            # a feature hit: no ingest, no forward — the stored logit
            # rows of the request's first forward, gathered on the card
            src = np.full((self.pool_rows,), -1, np.int32)
            src[:fplan.valid] = fplan.src_rows
            out = self._feature_arena.gather(self._logit_pool, src)
            fplan.release()
            return (RaggedBatch(out, pb.valid, pb.segment_offsets),), \
                non_tensors, time_card
        x = pb.data
        if x.device != self.torch_device:
            x = x.to(self.torch_device)
        elif x.is_cuda:
            # allocated on the loader's transfer stream; keep its memory
            # from being reused until this stream's work is done
            x.record_stream(torch.cuda.current_stream(x.device))
        out = self.forward(x, int(pb.valid))
        self._insert_features(out, time_card)
        if self.ragged:
            return (RaggedBatch(out, pb.valid, pb.segment_offsets),), \
                non_tensors, time_card
        return (PaddedBatch(out, pb.valid),), non_tensors, time_card
