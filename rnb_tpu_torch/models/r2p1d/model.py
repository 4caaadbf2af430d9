"""R(2+1)D pipeline stages: path iterator, loaders, runner, single step,
Large/Small router.

Counterpart of ``rnb_tpu/models/r2p1d/model.py``:

* :class:`R2P1DLoader` decodes one request at a time on host threads
  (with ``prefetch``, ahead of its turn), pads its clips to a row bucket
  or the one ragged pool shape in a pinned buffer, sends them to the
  card on a dedicated stream, and — on the rgb pixel path — normalizes
  them there on its own step: the normalize kernel when bucketed, the
  ragged normalize kernel (``rows_valid`` in device memory) when ragged.
  On the yuv420 and dct paths it ships the wire rows untouched.
* :class:`R2P1DFusingLoader` decodes requests on host threads into the
  pixel path's wire rows — RGB frames or packed 4:2:0 planes (uint8), or
  packed dequantized DCT coefficients (int16) — and fuses ready requests
  into one batch, padded to a row bucket or shipped as the one ragged
  pool shape with ``rows_valid`` and a segment table, assembled in a
  pinned staging slot and sent to the card on a dedicated stream; rgb
  emissions are normalized in the loader as well.
* :class:`R2P1DRunner` runs R(2+1)D layers [start..end] on the batch,
  with the pixel path's ingest kernels in front of layer 1 on the yuv420
  and dct paths; one network and one parameter copy per (range, device)
  serve every replica. A stage starting past layer 1 takes the previous
  range's float32 feature map, a stage ending before layer 5 emits one.
* :class:`R2P1DSingleStep` is loader and full network in one stage, the
  no-pipelining baseline; :class:`LargeSmallSelector` routes max-clip
  videos to their own queue.

With ``cache_mb`` a loader keeps a clip cache and coalesces requests
for a video that is decoding (``configs/rnb-fused-yuv-zipf-cache.json``);
with the root ``pager`` key the cache lives on pages of one device slab,
hits are gathered on the card, and feature pages let a repeated request
skip the forward (``configs/rnb-fused-yuv-paged-zipf.json``).

Not yet ported from the reference stages: the autotune controller,
fault containment, the native decode pool, ``raw_output`` and the mesh
runner, the aggregator, sharding.
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
from rnb_tpu_torch.ops.preprocess import normalize_u8
from rnb_tpu_torch.ops.ragged import (ragged_normalize_u8,
                                      ragged_normalize_yuv420,
                                      resolve_pool_rows, segment_offsets_of)
from rnb_tpu_torch.ops.yuv import normalize_yuv420, packed_frame_bytes
from rnb_tpu_torch.selector import QueueSelector
from rnb_tpu_torch.stage import (PadCounter, PaddedBatch, RaggedBatch,
                                 StageModel, normalize_row_buckets,
                                 note_emission_accounting)
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
PIXEL_PATHS = ("rgb", "yuv420", "dct")
#: the synthetic ids the path iterator cycles when there is no dataset
NUM_SYNTHETIC_VIDEOS = 200

_cache_lock = threading.Lock()
_network_cache: Dict[tuple, torch.nn.Module] = {}


def _check_pixel_path(pixel_path: str) -> None:
    if pixel_path not in PIXEL_PATHS:
        raise ValueError("pixel_path must be one of %s, got %r"
                         % (PIXEL_PATHS, pixel_path))


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
                      dct_coeffs: Optional[int] = None,
                      frames: int = CONSECUTIVE_FRAMES) -> tuple:
    """A batch of wire rows: RGB frames ``(rows, frames, H, W, 3)``, or
    ``(rows, frames, elems)`` of packed 4:2:0 bytes or, under dct, packed
    int16 coefficients."""
    if pixel_path == "rgb":
        return (int(rows), int(frames), FRAME_HW, FRAME_HW, 3)
    if pixel_path == "dct":
        elems = dct_frame_elems(FRAME_HW, FRAME_HW, dct_coeffs)
    else:
        elems = packed_frame_bytes(FRAME_HW, FRAME_HW)
    return (int(rows), int(frames), elems)


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


def normalize_emission(pixel_path: str, ragged: bool,
                       device_wire: torch.Tensor, valid: int):
    """The loaders' device step, shared by every emission path: on the
    rgb path the bucketed normalize, or the ragged one with
    ``rows_valid`` handed over in device memory; the yuv420 and dct wire
    rows pass through to the network stage's fused ingest."""
    if pixel_path != "rgb":
        return device_wire
    if device_wire.is_cuda:
        # allocated on the transfer or arena stream: keep its memory
        # until this stream's kernel has read it
        device_wire.record_stream(
            torch.cuda.current_stream(device_wire.device))
    if ragged:
        return ragged_normalize_u8(device_wire, int(valid))
    return normalize_u8(device_wire)


class _DecodeHandle:
    """Decode work of one request, started ahead of its turn: ``wait()``
    blocks until the clip rows are in ``out``.

    A ``cached`` handle carries a clip-cache hit and a ``feature_plan``
    handle a feature-page hit: neither owns decode work. A ``leader``
    handle is a coalesced follower sharing another request's decode. A
    failed ``wait()`` keeps its error and raises it again on every later
    wait, so a follower of a failed leader fails the same way."""

    __slots__ = ("out", "n", "future", "cached", "leader", "key", "error",
                 "feature_plan")

    def __init__(self, out, n, future=None, cached=None, leader=None,
                 key=None):
        self.out = out          # wire rows (n, ...), set by the decode
        self.n = n              # valid clip count
        self.future = future    # the decode thread's future, or None
        self.cached = cached    # a cache hit's entry or plan, or None
        self.leader = leader    # coalesced: the leader's handle
        self.key = key          # cache key this decode inserts under
        self.error = None
        self.feature_plan = None  # a pinned feature-page hit, or None

    def wait(self) -> None:
        if self.leader is not None:
            self.leader.wait()
            self.out = self.leader.out
            return
        if self.error is not None:
            raise self.error
        if self.future is not None:
            try:
                self.out = self.future.result()
            except Exception as e:
                self.error = e
                raise
            self.future = None


class R2P1DLoader(StageModel):
    """Decode stage: video path or id -> one padded clip batch on the
    card per request, normalized there on the rgb pixel path.

    Samples 1..max_clips clips, decodes them on the host, pads them to a
    row bucket (``row_buckets``) or ships them in the one ragged pool
    shape with ``rows_valid``, transfers once through a pinned buffer on
    a dedicated stream, and stamps ``num_clips`` on the TimeCard for
    content-aware routing. On the rgb path the stage's own device step
    normalizes uint8 frames to bfloat16 — the normalize kernel when
    bucketed, the ragged normalize kernel when ragged, whose pad rows
    come out exactly zero whatever the pool tail held; a bucketed
    emission zero-fills its pad rows on the host instead, which
    normalize to -1. On the yuv420 and dct paths the wire rows go to the
    network stage's fused ingest untouched.

    **Prefetch**: with a ``prefetch`` depth the stage exposes
    ``submit()`` / ``complete()`` / ``discard()`` and the executor starts
    the decode of requests N+1..N+k on a thread pool while request N's
    device work runs; the decode span on the TimeCard then measures only
    the residual wait.

    With ``cache_mb`` a clip cache serves repeated videos and a request
    whose video is decoding in the prefetch window shares that decode. A
    bucketed entry is the padded device batch before the normalize; a
    ragged entry is the request's host rows, or, after ``enable_pager``,
    pages of the clip arena that a hit gathers over a zero pool with no
    host bytes. With feature pages a request whose logits are stored
    ships a stub and the runner gathers its logits.
    """

    SUPPORTS_RAGGED = True
    SUPPORTS_PAGER = True

    #: pinned transfer buffers: one filling, one in flight
    TRANSFER_SLOTS = 2
    #: per-video clip-start cache cap
    STARTS_CACHE_MAX = 8192

    def __init__(self, device, max_clips: int = MAX_CLIPS,
                 consecutive_frames: int = CONSECUTIVE_FRAMES,
                 num_clips_population=None, weights=None,
                 num_warmups: int = NUM_WARMUPS, row_buckets=None,
                 prefetch: int = 0, pixel_path: str = "rgb",
                 cache_mb: float = 0, ragged: bool = False,
                 ragged_pool_rows=None, dct_coeffs_per_frame=None):
        super().__init__(device)
        _check_pixel_path(pixel_path)
        self.torch_device = _device_of(device)
        self.pixel_path = pixel_path
        self.dct_coeffs = _dct_coeffs(pixel_path, dct_coeffs_per_frame)
        sampler_kwargs = {}
        if num_clips_population is not None:
            sampler_kwargs["num_clips_population"] = num_clips_population
        if weights is not None:
            sampler_kwargs["weights"] = weights
        self.sampler = R2P1DSampler(consecutive_frames=consecutive_frames,
                                    **sampler_kwargs)
        self.max_clips = int(max_clips)
        self.consecutive_frames = int(consecutive_frames)
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
        self.prefetch_depth = int(prefetch)
        self._decode_pool = None  # built at the first submit
        self._starts_cache: Dict[str, list] = {}
        #: the staging plane counts only slots a decoder writes into; this
        #: loader copies its rows into a transfer buffer, as the reference
        #: does without its native decoder
        self.staging = None
        self._transfer = StagingPool(self._batch_shape(self.max_clips),
                                     self.TRANSFER_SLOTS,
                                     self.torch_device,
                                     _wire_dtype(pixel_path))
        self.ingest_stats = {"pixel_path": pixel_path, "backends": set()}
        self.cache = None
        self._inflight_keys = None
        if cache_mb:
            self.cache = ClipCache(cache_mb, device=self.torch_device)
            self._inflight_keys = InflightTable()
            self._cache_cfg = (
                "r2p1d", tuple(self.sampler.num_clips_population),
                tuple(float(p) for p in self.sampler.probabilities),
                self.consecutive_frames, FRAME_HW, self.pixel_path,
                self.max_clips, self.row_buckets, self.ragged,
                self.dct_coeffs)
        self.pager = None
        self._clip_arena = None
        self._zero_pool = None
        self._feature_stub = None
        # warm-up: fault in the pinned buffers and the transfer path at
        # every shipped shape, and build and launch the normalize kernel
        for rows in self._warm_shapes():
            for _ in range(num_warmups):
                self._normalize_emission(self._transfer.transfer(
                    self._transfer.acquire(), rows), rows)
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)
        if num_warmups > 0:
            self._warm_decode()

    @classmethod
    def output_shape_for(cls, max_clips: int = MAX_CLIPS,
                         consecutive_frames: int = CONSECUTIVE_FRAMES,
                         pixel_path: str = "rgb",
                         dct_coeffs_per_frame=None, **_kwargs):
        return (_wire_batch_shape(max_clips, pixel_path, _dct_coeffs(
            pixel_path, dct_coeffs_per_frame), consecutive_frames),)

    @classmethod
    def output_dtype_for(cls, pixel_path: str = "rgb", **_kwargs):
        """What the stage emits: normalized bfloat16 on the rgb path,
        the wire dtype otherwise."""
        return {"rgb": "bfloat16", "yuv420": "uint8",
                "dct": "int16"}[pixel_path]

    # -- shapes and helpers -------------------------------------------------

    def _batch_shape(self, rows: int):
        return _wire_batch_shape(rows, self.pixel_path, self.dct_coeffs,
                                 self.consecutive_frames)

    def _warm_shapes(self):
        return (self.pool_rows,) if self.ragged else self.row_buckets

    def _bucket_for(self, n: int) -> int:
        for bucket in self.row_buckets:
            if n <= bucket:
                return bucket
        return self.row_buckets[-1]

    def _ship_rows(self, n: int) -> int:
        """Rows an emission of ``n`` valid rows ships: its pad bucket, or
        the pool capacity under ragged."""
        return self.pool_rows if self.ragged else self._bucket_for(n)

    def _warm_decode(self, num_samples: int = 3) -> None:
        """Decode a few files of the dataset once, so the first measured
        request pays no cold file or header cost."""
        root = os.environ.get("RNB_TPU_DATA_ROOT")
        if not root or not os.path.isdir(root):
            return
        samples = [v for v in scan_video_tree(root)
                   if v.endswith(".y4m")][:num_samples]
        for path in samples:
            decoder = get_decoder(path)
            self._decode_sync(decoder, path,
                              self._sample_starts(decoder, path))

    def _sample_starts(self, decoder, video: str):
        """Clip starts for one video, cached: the sampler is
        deterministic per video id."""
        starts = self._starts_cache.get(video)
        if starts is None:
            starts = [int(s) for s in self.sampler.sample(
                decoder.num_frames(video), video_id=video)]
            starts = starts[: self.max_clips]
            if len(self._starts_cache) < self.STARTS_CACHE_MAX:
                self._starts_cache[video] = starts
        return starts

    def _decode_sync(self, decoder, video: str, starts) -> np.ndarray:
        """Decode through this loader's pixel path, on the calling
        thread."""
        self.ingest_stats["backends"].add(decoder.BACKEND)
        if self.pixel_path == "yuv420":
            return decoder.decode_clips_yuv(video, starts,
                                            self.consecutive_frames,
                                            FRAME_HW, FRAME_HW)
        if self.pixel_path == "dct":
            return decoder.decode_clips_dct(video, starts,
                                            self.consecutive_frames,
                                            FRAME_HW, FRAME_HW,
                                            self.dct_coeffs)
        return decoder.decode_clips(video, starts, self.consecutive_frames,
                                    FRAME_HW, FRAME_HW)

    def _note_emission_padding(self, valid: int, shipped: int,
                               cards) -> None:
        note_emission_accounting(
            self.padding, self.ragged_stats, cards, valid, shipped,
            self._bucket_for(valid) if self.ragged else 0)

    def _normalize_emission(self, device_wire: torch.Tensor, valid: int):
        return normalize_emission(self.pixel_path, self.ragged,
                                  device_wire, valid)

    def _wrap_batch(self, data, valid: int):
        if self.ragged:
            return RaggedBatch(data, valid, (0, int(valid)))
        return PaddedBatch(data, valid)

    # -- the clip cache and feature pages -----------------------------------

    def enable_pager(self, pager) -> None:
        """Executor protocol: install the page allocator before the start
        barrier. The clip cache's entries become page lists in a
        ``clips`` arena sized from ``cache_mb``; the loader allocates the
        one zero pool that paged hits gather over and the stub a feature
        hit ships (the zero pool through this stage's own device step:
        the declared wire value, made once here). Needs ragged dispatch
        and a clip cache, as in the reference."""
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
        stub = self._normalize_emission(self._zero_pool, 0)
        if stub is not self._zero_pool:
            pager.adopt_shared("loader-feature-stub", stub)
        self._feature_stub = stub
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)

    def _feature_probe(self, video: str):
        """(content key, plan) from the feature pages, probed ahead of
        the clip cache; (None, None) when feature pages are off."""
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
        if self.pager is not None and self.pager.feature is not None \
                and self.pager.feature.ready and key is not None:
            time_card.feature_insert = (key, int(row0), int(n))

    def _materialize_hit(self, entry, time_card):
        """Serve one request from the clip cache: no decode. A bucketed
        entry is the padded device batch, fed to the same device step a
        miss feeds; a ragged blob entry's host rows ride a fresh
        transfer in the pool shape; a paged entry is gathered."""
        time_card.num_clips = entry.valid
        time_card.cache_hit = True
        if self.ragged:
            self.ragged_stats["cache_hit_rows"] += entry.valid
            if self.cache.paged:
                return self._materialize_pages(entry, time_card)
            return self._materialize(entry.batch, entry.valid, time_card)
        self._note_emission_padding(entry.valid, int(entry.batch.shape[0]),
                                    [time_card])
        return (PaddedBatch(self._normalize_emission(entry.batch,
                                                     entry.valid),
                            entry.valid),), None, time_card

    def _materialize_pages(self, plan, time_card):
        """A paged hit, with no host bytes: the entry's page rows are
        gathered on the card over the zero pool, and the result goes
        through the same device step a miss feeds."""
        n = plan.valid
        src = np.full((self.pool_rows,), -1, np.int32)
        src[:n] = plan.src_rows
        device_wire = self._clip_arena.gather(self._zero_pool, src)
        plan.release()
        self._note_emission_padding(n, self.pool_rows, [time_card])
        return (self._wrap_batch(self._normalize_emission(device_wire, n),
                                 n),), None, time_card

    def _materialize_feature(self, plan, time_card):
        """A feature-page hit: no decode, no transfer, no forward. The
        stub pool goes downstream (never read) and the pinned plan rides
        the card to the consuming stage."""
        n = plan.valid
        time_card.num_clips = n
        time_card.feature_hit = True
        time_card.feature_plan = plan
        self.pager.note_feature_saved(n * self._clip_arena.row_bytes)
        self._note_emission_padding(n, self.pool_rows, [time_card])
        return (self._wrap_batch(self._feature_stub, n),), None, time_card

    def _materialize(self, clips: np.ndarray, n: int, time_card,
                     cache_key=None):
        """Pad decoded rows to their bucket (zeros) or the pool (tail
        left as it is) in a pinned buffer, transfer, normalize. With
        ``cache_key`` the rows enter the clip cache — only here, after
        decode and transfer succeeded."""
        shipped = self._ship_rows(n)
        slot = self._transfer.acquire()
        slot.array[:n] = clips
        if not self.ragged:
            slot.array[n:shipped] = 0
        caching = cache_key is not None and self.cache is not None
        if caching and self.ragged and not self.cache.paged:
            self.cache.insert_rows(cache_key, clips, n)
        device_wire = self._transfer.transfer(slot, shipped)
        if caching and self.ragged and self.cache.paged:
            self.cache.insert_pages(cache_key, device_wire, 0, n)
            self._stamp_feature_insert(time_card, cache_key, 0, n)
        if caching and not self.ragged:
            self.cache.insert_device(cache_key, device_wire, n)
        self._note_emission_padding(n, shipped, [time_card])
        return (self._wrap_batch(self._normalize_emission(device_wire, n),
                                 n),), None, time_card

    # -- prefetch: submit / complete / discard ------------------------------

    def submit(self, non_tensors, time_card) -> _DecodeHandle:
        """Start the decode of one request on the thread pool; pair with
        :meth:`complete`. A cache hit returns a handle with no work; a
        request whose video is decoding in the window shares it."""
        video = str(non_tensors)
        time_card.video = video
        fkey, fplan = self._feature_probe(video)
        if fplan is not None:
            handle = _DecodeHandle(None, fplan.valid)
            handle.feature_plan = fplan
            time_card.num_clips = fplan.valid
            time_card.feature_hit = True
            return handle
        key, entry = self._cache_lookup(video, key=fkey)
        if entry is not None:
            time_card.num_clips = entry.valid
            time_card.cache_hit = True
            return _DecodeHandle(None, entry.valid, cached=entry)
        if key is not None:
            time_card.cache_hit = False
            leader = self._inflight_keys.get(key)
            if leader is not None:
                time_card.num_clips = leader.n
                time_card.cache_coalesced = True
                self.cache.note_coalesced()
                return _DecodeHandle(None, leader.n, leader=leader)
        decoder = get_decoder(video)
        starts = self._sample_starts(decoder, video)
        time_card.num_clips = len(starts)
        if self._decode_pool is None:
            self._decode_pool = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                thread_name_prefix="rnb-decode")
        handle = _DecodeHandle(None, len(starts), key=key,
                               future=self._decode_pool.submit(
                                   self._decode_sync, decoder, video,
                                   starts))
        if key is not None:
            self._inflight_keys.put(key, handle)
        return handle

    def complete(self, handle: _DecodeHandle, non_tensors, time_card):
        """Wait for a submitted decode, then pad, transfer and normalize
        (or serve the cached or shared result without decode work)."""
        if handle.feature_plan is not None:
            plan, handle.feature_plan = handle.feature_plan, None
            return self._materialize_feature(plan, time_card)
        if handle.cached is not None:
            entry, handle.cached = handle.cached, None
            return self._materialize_hit(entry, time_card)
        if handle.leader is not None:
            # the leader decoded for both and made the cache insert
            handle.wait()
            return self._materialize(handle.out, handle.n, time_card)
        try:
            handle.wait()
        finally:
            # finalized either way: later requests for this key consult
            # the cache or decode afresh
            if self._inflight_keys is not None:
                self._inflight_keys.pop(handle.key)
        return self._materialize(handle.out, handle.n, time_card,
                                 cache_key=handle.key)

    def discard(self, handle: _DecodeHandle, non_tensors=None) -> None:
        """Retire a submitted decode whose result will never be used,
        and release the page pins of an unserved hit."""
        del non_tensors
        try:
            handle.wait()
        except Exception:
            pass  # abort path: decode errors are moot
        for plan in (handle.feature_plan, handle.cached):
            if plan is not None and hasattr(plan, "release"):
                plan.release()
        handle.feature_plan = handle.cached = None
        if self._inflight_keys is not None:
            self._inflight_keys.pop(handle.key)

    def discard_pending(self) -> None:
        """Teardown: stop the decode threads."""
        if self._decode_pool is not None:
            self._decode_pool.shutdown(wait=True, cancel_futures=True)
            self._decode_pool = None

    def __call__(self, tensors, non_tensors, time_card):
        # the synchronous path (no prefetching executor, the single
        # step): decode inline on the calling thread
        video = str(non_tensors)
        time_card.video = video
        fkey, fplan = self._feature_probe(video)
        if fplan is not None:
            return self._materialize_feature(fplan, time_card)
        key, entry = self._cache_lookup(video, key=fkey)
        if entry is not None:
            return self._materialize_hit(entry, time_card)
        decoder = get_decoder(video)
        clips = self._decode_sync(decoder, video,
                                  self._sample_starts(decoder, video))
        n = int(clips.shape[0])
        time_card.num_clips = n
        if key is not None:
            time_card.cache_hit = False
        return self._materialize(clips, n, time_card, cache_key=key)


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
        self._feature_stub = None
        # warm-up: fault in the pinned slots and the transfer path at
        # every shape an emission ships (and, on the rgb path, build and
        # launch the loader's normalize kernel)
        for rows in self._warm_shapes():
            for _ in range(num_warmups):
                self._normalize_emission(self.staging.transfer(
                    self.staging.acquire(), rows), rows)
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
        self._feature_stub = self._normalize_emission(self._zero_pool, 0)
        if self._feature_stub is not self._zero_pool:
            pager.adopt_shared("loader-feature-stub", self._feature_stub)
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)

    def _batch_shape(self, rows: int):
        return _wire_batch_shape(rows, self.pixel_path, self.dct_coeffs)

    def _normalize_emission(self, device_wire: torch.Tensor, valid: int):
        return normalize_emission(self.pixel_path, self.ragged,
                                  device_wire, valid)

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
        """Padding and ragged accounting for one emission (the shared
        rule, :func:`rnb_tpu_torch.stage.note_emission_accounting`); the
        counterfactual under ragged is this stage's bucket vocabulary."""
        note_emission_accounting(
            self.padding, self.ragged_stats, cards, valid, shipped,
            self._bucket_for(valid) if self.ragged else 0)

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
        return ((RaggedBatch(self._feature_stub, n, (0, n)),), None,
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
        return ((PaddedBatch(self._normalize_emission(entry.batch,
                                                      entry.valid),
                             entry.valid),), None,
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
        elif self.pixel_path == "yuv420":
            future = self._decode_pool.submit(
                decoder.decode_clips_yuv, video, starts, CONSECUTIVE_FRAMES,
                FRAME_HW, FRAME_HW)
        else:
            future = self._decode_pool.submit(
                decoder.decode_clips, video, starts, CONSECUTIVE_FRAMES,
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
            batch = self._normalize_emission(batch, rows)
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
    """Network stage over the layer range [start..end].

    What it takes depends on where it starts and on the pixel path. A
    stage starting at layer 1 takes the loader's batch: on the rgb path
    the loader's already normalized bfloat16 frames, which go to the
    network as they are; on the yuv420 and dct paths the wire rows, with
    the fused ingest in front of layer 1 (yuv420 planes through the
    colourspace and normalize kernels, dct coefficient rows through the
    unpack and IDCT/convert kernels). A stage starting past layer 1
    takes the previous range's float32 feature map. A stage ending
    before layer 5 emits its own feature map, float32 as every stage's
    output is.

    Bucketed mode takes ``PaddedBatch`` es at the warmed row buckets.
    Ragged mode takes the one pool shape plus ``rows_valid``: the
    ingest kernels (or, on the rgb path, the producing loader) mask the
    pool tail, and with ``ragged_chunk_rows`` the network runs
    ``ceil(rows_valid / chunk)`` row tiles — host-side slicing by the
    host integer ``rows_valid`` — so network work scales with the valid
    rows; pad rows of the output stay zero.

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
                 consecutive_frames: int = CONSECUTIVE_FRAMES,
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
        if pixel_path in ("yuv420", "dct") and start_index != 1:
            raise ValueError("pixel_path=%r fuses the ingest in front of "
                             "layer 1; a [%d..%d] stage receives "
                             "activations, not frames"
                             % (pixel_path, start_index, end_index))
        self.torch_device = _device_of(device)
        self.start_index, self.end_index = int(start_index), int(end_index)
        self.num_classes = int(num_classes)
        self.layer_sizes = tuple(layer_sizes)
        self.max_rows = int(max_rows)
        self.consecutive_frames = int(consecutive_frames)
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
            self.start_index, self.end_index, self.consecutive_frames,
            int(num_classes))
        # warm up on the declared steady shape and dtype
        declared = dict(start_index=self.start_index,
                        max_rows=self.max_rows,
                        consecutive_frames=self.consecutive_frames,
                        pixel_path=pixel_path,
                        dct_coeffs_per_frame=dct_coeffs_per_frame)
        self._steady_shape = self.input_shape_for(**declared)[0]
        warm_dtype = getattr(torch, self.input_dtype_for(**declared))
        warm_rows = ((self.pool_rows,) if self.ragged else
                     normalize_row_buckets(row_buckets, self.max_rows,
                                           "max_rows"))
        for rows in warm_rows:
            dummy = torch.zeros((rows,) + self._steady_shape[1:],
                                dtype=warm_dtype, device=self.torch_device)
            for _ in range(num_warmups):
                self.forward(dummy, rows)
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)

    @classmethod
    def input_shape_for(cls, start_index: int = 1,
                        max_rows: int = MAX_CLIPS,
                        consecutive_frames: int = CONSECUTIVE_FRAMES,
                        pixel_path: str = "rgb",
                        dct_coeffs_per_frame=None, **_kwargs):
        """The steady input shape: the loader's wire rows at layer 1,
        else what the range [1..start-1] makes of the frames."""
        if int(start_index) == 1 or pixel_path != "rgb":
            return (_wire_batch_shape(max_rows, pixel_path, _dct_coeffs(
                pixel_path, dct_coeffs_per_frame), consecutive_frames),)
        return ((int(max_rows),) + range_output_shape(
            1, int(start_index) - 1, int(consecutive_frames)),)

    @classmethod
    def input_dtype_for(cls, start_index: int = 1,
                        pixel_path: str = "rgb", **_kwargs):
        """The dtype the pipeline flows into this stage: packed uint8
        planes (yuv420), packed int16 coefficient rows (dct), the
        loader's bfloat16 frames into layer 1, an upstream network
        stage's float32 activations past it."""
        if pixel_path == "yuv420":
            return "uint8"
        if pixel_path == "dct":
            return "int16"
        return "bfloat16" if int(start_index) == 1 else "float32"

    @classmethod
    def output_dtype_for(cls, **_kwargs):
        return "float32"

    @classmethod
    def output_shape_for(cls, start_index: int = 1,
                         end_index: int = NUM_LAYERS,
                         num_classes: int = KINETICS_CLASSES,
                         max_rows: int = MAX_CLIPS,
                         consecutive_frames: int = CONSECUTIVE_FRAMES,
                         **_kwargs):
        return ((int(max_rows),) + range_output_shape(
            int(start_index), int(end_index), int(consecutive_frames),
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
            self.num_classes, self.layer_sizes, False,
            self.consecutive_frames, self.pixel_path, self.dct_coeffs)
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
        """Wire rows -> normalized bf16 NDHWC frames. The rgb path and
        every stage past layer 1 have no ingest: the loader normalized
        (and, ragged, masked) the frames, and a feature map is what the
        network takes."""
        if self.pixel_path == "rgb":
            return x
        if self.pixel_path == "dct":
            if not self.ragged:
                return normalize_dct(x, FRAME_HW, FRAME_HW)
            return ragged_normalize_dct(x, rows_valid, FRAME_HW, FRAME_HW)
        if not self.ragged:
            return normalize_yuv420(x, FRAME_HW, FRAME_HW)
        return ragged_normalize_yuv420(x, rows_valid, FRAME_HW, FRAME_HW)

    @torch.inference_mode()
    def forward(self, x: torch.Tensor, rows_valid: int) -> torch.Tensor:
        """The stage's input ``(rows, ...)`` -> float32 outputs ``(rows,
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
        offsets = getattr(pb, "segment_offsets", (0, int(pb.valid)))
        fplan = self._take_feature_plan(time_card)
        if fplan is not None:
            # a feature hit: no ingest, no forward — the stored logit
            # rows of the request's first forward, gathered on the card
            src = np.full((self.pool_rows,), -1, np.int32)
            src[:fplan.valid] = fplan.src_rows
            out = self._feature_arena.gather(self._logit_pool, src)
            fplan.release()
            return (RaggedBatch(out, pb.valid, offsets),), \
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
            return (RaggedBatch(out, pb.valid, offsets),), \
                non_tensors, time_card
        return (PaddedBatch(out, pb.valid),), non_tensors, time_card


class R2P1DSingleStep(StageModel):
    """Decode and the full network in one stage: the no-pipelining
    baseline. Emits the predicted class id as the non-tensor payload and
    declares no tensor outputs. Model keys other than the network's go
    to the embedded loader."""

    def __init__(self, device, num_classes: int = KINETICS_CLASSES,
                 layer_sizes=R18_LAYER_SIZES, max_clips: int = MAX_CLIPS,
                 consecutive_frames: int = CONSECUTIVE_FRAMES,
                 num_warmups: int = NUM_WARMUPS, **kwargs):
        super().__init__(device)
        self.loader = R2P1DLoader(device, max_clips=max_clips,
                                  consecutive_frames=consecutive_frames,
                                  num_warmups=num_warmups, **kwargs)
        # the executor's sinks read these off the stage
        self.cache = self.loader.cache
        self.padding = self.loader.padding
        self.ragged_stats = self.loader.ragged_stats
        self.ingest_stats = self.loader.ingest_stats
        # the inner runner warms the bucket shapes the loader emits
        self.net = R2P1DRunner(
            device, start_index=1, end_index=NUM_LAYERS,
            num_classes=num_classes, layer_sizes=layer_sizes,
            max_rows=max_clips, consecutive_frames=consecutive_frames,
            num_warmups=num_warmups, row_buckets=kwargs.get("row_buckets"),
            pixel_path=kwargs.get("pixel_path", "rgb"),
            dct_coeffs_per_frame=kwargs.get("dct_coeffs_per_frame"))

    @classmethod
    def output_shape_for(cls, **_kwargs):
        return None

    def discard_pending(self) -> None:
        self.loader.discard_pending()

    @torch.inference_mode()
    def __call__(self, tensors, non_tensors, time_card):
        (pb,), _, time_card = self.loader(None, non_tensors, time_card)
        (logits,), _, time_card = self.net((pb,), None, time_card)
        # sum and argmax on the card; only the class id crosses to the
        # host
        pred = int(torch.argmax(logits.data[: logits.valid].sum(dim=0)))
        return None, pred, time_card


class LargeSmallSelector(QueueSelector):
    """Content-aware router: rare large (max-clip) videos go to queue 1,
    everything else to queue 0, so small videos can be batched without
    waiting behind a large one — the Replicate & Batch placement. Keyed
    off the ``num_clips`` the loader stamped on the TimeCard; the
    threshold binds to the producing loader's clip population
    (``bind_stage``), capped at its ``max_clips``."""

    def __init__(self, num_queues: int):
        super().__init__(num_queues)
        if num_queues != 2:
            raise ValueError("LargeSmallSelector routes over exactly two "
                             "queues (got %d)" % num_queues)
        self._threshold = MAX_CLIPS

    def bind_stage(self, model) -> None:
        sampler = getattr(model, "sampler", None)
        threshold = getattr(sampler, "max_clips", None)
        if threshold:
            # the loader cuts every request at its own max_clips, so a
            # population max above it would never be reached
            cap = getattr(model, "max_clips", None)
            if cap:
                threshold = min(int(threshold), int(cap))
            self._threshold = int(threshold)

    def select(self, tensors, non_tensors, time_card) -> int:
        return (1 if getattr(time_card, "num_clips", 0) >= self._threshold
                else 0)
