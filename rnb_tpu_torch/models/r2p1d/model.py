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
* :class:`R2P1DAggregator` is the host step behind a segmented step: it
  sums each request's segment logits, merges the segments' TimeCards
  and emits the class id.
* :class:`R2P1DMeshRunner` is the clip-sharded successor of that
  topology: ``dp`` videos a dispatch, their clips split over ``sp``
  members (rnb_tpu_torch.parallel.sharded), the members' logit sums
  added on the device, class ids out; it takes the ``raw_output``
  batches of an ``R2P1DLoader``.

With ``cache_mb`` a loader keeps a clip cache and coalesces requests
for a video that is decoding (``configs/rnb-fused-yuv-zipf-cache.json``);
with the root ``pager`` key the cache lives on pages of one device slab,
hits are gathered on the card, and feature pages let a repeated request
skip the forward (``configs/rnb-fused-yuv-paged-zipf.json``).

Both loaders decode ``.y4m`` and ``.mjpg`` files on the native C++
pool (:mod:`rnb_tpu_torch.decode.native`) straight into the pinned
staging rows a request was given when it was submitted; the runner
replays one captured CUDA graph per input signature on the card.

On a traced run (root ``trace`` key) the loaders stamp the
phase-refinement stamps (``decode{i}_done``, ``transfer{i}_start``,
``transfer{i}_done``) on every card and register their occupancy
counters with the tracer (``enable_trace``).

With the step-level ``shard`` key the runner holds its temporal conv
kernels and its head in member shards over a ring of members that share
one card, gathers them inside the captured forward, and merges a head's
logits in a host-timed collective (rnb_tpu_torch.parallel.shardplan).
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import threading
import time
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Dict, Optional

import numpy as np
import torch

from rnb_tpu_torch import hostprof, trace
from rnb_tpu_torch.autotune import BatchController
from rnb_tpu_torch.cache import ClipCache, InflightTable, content_key
from rnb_tpu_torch.compilestats import SignatureTracker, signature_of
from rnb_tpu_torch.decode import get_decoder
from rnb_tpu_torch.decode.native import (PIX_DCT, PIX_RGB, PIX_YUV420,
                                         DecodePool, NativeY4MDecoder,
                                         default_decode_threads,
                                         native_enabled)
from rnb_tpu_torch.faults import (FATAL, TRANSIENT, TransientDecodeError,
                                  classify_error, fault_reason)
from rnb_tpu_torch.health import expired as deadline_expired
from rnb_tpu_torch.models.r2p1d.checkpoint import load_or_init
from rnb_tpu_torch.models.r2p1d.flops import range_flops_per_clip
from rnb_tpu_torch.models.r2p1d.network import (KINETICS_CLASSES,
                                                NUM_LAYERS, R18_LAYER_SIZES,
                                                range_output_shape)
from rnb_tpu_torch.models.r2p1d.sampler import R2P1DSampler
from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.ops.dct import (dct_frame_elems, default_dct_coeffs,
                                   normalize_dct, ragged_normalize_dct)
from rnb_tpu_torch.ops.preprocess import normalize_u8
from rnb_tpu_torch.ops.ragged import (ragged_normalize_u8,
                                      ragged_normalize_yuv420,
                                      resolve_pool_rows, segment_offsets_of)
from rnb_tpu_torch.ops.yuv import normalize_yuv420, packed_frame_bytes
from rnb_tpu_torch.parallel.mesh import (Member, Ring, build_mesh,
                                         this_process)
from rnb_tpu_torch.parallel.sharded import ShardedInference
from rnb_tpu_torch.parallel.shardplan import (build_shard_ring,
                                              make_merge, make_sharded_apply,
                                              min_feasible_degree,
                                              projected_device_mb,
                                              split_param_bytes,
                                              validate_degree)
from rnb_tpu_torch.selector import QueueSelector
from rnb_tpu_torch.stage import (ANOTHER_PROCESS, PadCounter, PaddedBatch,
                                 RaggedBatch, StageModel,
                                 normalize_row_buckets,
                                 note_emission_accounting)
from rnb_tpu_torch.staging import StagingPool, TransferWorker
from rnb_tpu_torch.telemetry import TimeCard, TimeCardList, cards_of
from rnb_tpu_torch.video_path_provider import (VideoPathIterator,
                                               scan_video_tree)

MAX_CLIPS = 15
CONSECUTIVE_FRAMES = 8
FRAME_HW = 112
NUM_WARMUPS = 3  # reference warm-up convention
PIXEL_PATHS = ("rgb", "yuv420", "dct")
#: the synthetic ids the path iterator cycles when there is no dataset
NUM_SYNTHETIC_VIDEOS = 200

_cache_lock = threading.Lock()
_network_cache: Dict[tuple, torch.nn.Module] = {}
#: a graph capture on one stage's thread fails when another thread
#: synchronizes the device meanwhile (the synchronize would wait on the
#: capturing stream), and ``torch.cuda.graph`` synchronizes the device
#: when it begins: captures and the device synchronizes of stage
#: construction take this lock in turn (several runners of one card
#: build at once)
_DEVICE_SYNC_LOCK = threading.RLock()


def _synchronize(device: torch.device) -> None:
    """``torch.cuda.synchronize`` outside any other stage's capture."""
    with _DEVICE_SYNC_LOCK:
        torch.cuda.synchronize(device)


def _check_pixel_path(pixel_path: str) -> None:
    if pixel_path not in PIXEL_PATHS:
        raise ValueError("pixel_path must be one of %s, got %r"
                         % (PIXEL_PATHS, pixel_path))


def _fallback_threads(fallback_decode_threads) -> int:
    """The width of a loader's pool for decodes off the native pool: the
    native pool's rule (``default_decode_threads``) unless given."""
    if fallback_decode_threads is None:
        return default_decode_threads()
    threads = int(fallback_decode_threads)
    if threads < 1:
        raise ValueError("fallback_decode_threads must be >= 1, got %r"
                         % (fallback_decode_threads,))
    return threads


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


def _member_of(device) -> Member:
    """Accept a DeviceSpec (in a launch, a global member) or a device of
    this process, as :func:`_device_of` does."""
    return device.member() if hasattr(device, "resolve") else \
        Member(this_process(), torch.device(device))


def _record_clamped(card, key: str, at: float) -> None:
    """Record a phase-refinement stamp no earlier than the card's latest
    stamp, so each card's stamps stay in time order (a coalesced
    follower admitted after its leader's decode reads a zero-length
    decode phase)."""
    if card.timings:
        last = next(reversed(card.timings.values()))
        if at < last:
            at = last
    card.record(key, at=at)


#: the refinement stamps, by stage (telemetry.TRACE_STAMP_REGISTRY)
_REFINEMENT_KEYS = {"decode": "decode%d_done",
                    "transfer_start": "transfer%d_start",
                    "transfer_done": "transfer%d_done"}
_ALL_STAGES = ("decode", "transfer_start", "transfer_done")


class _TraceStamps:
    """The loaders' side of tracing: ``enable_trace`` turns on the
    refinement stamps of step ``_trace_step``; off, every stamp call is
    one None test."""

    _trace_step: Optional[int] = None

    def enable_trace(self, tracer, step_idx: int) -> None:
        """Executor protocol (traced runs only): stamp the refinement
        stamps from now on, and let the tracer's sampler read this
        loader's free staging slots."""
        self._trace_step = int(step_idx)
        if self.staging is not None:
            tracer.add_counter_source(
                trace.name("staging.s%d.free", step_idx),
                self.staging.available)

    def _stamp(self, cards, *stages, at: Optional[float] = None) -> None:
        """Stamp ``decode``/``transfer_start``/``transfer_done``
        (``stages``) on every card, at ``at`` or now."""
        if self._trace_step is None:
            return
        at = time.time() if at is None else at
        step = self._trace_step
        for tc in cards:
            for stage in stages:
                _record_clamped(tc, _REFINEMENT_KEYS[stage] % step, at)


def default_ragged_chunk(pool_rows: int) -> int:
    """Auto row-chunk for the ragged tile loop: the largest divisor of
    the pool capacity no bigger than a third of it, floored at 1."""
    pool_rows = int(pool_rows)
    for d in range(max(1, pool_rows // 3), 0, -1):
        if pool_rows % d == 0:
            return d
    return 1


def _ckpt_kwargs(ckpt_path: Optional[str]) -> dict:
    """``shared_network``'s checkpoint argument, given only where a file
    is named."""
    return {} if ckpt_path is None else {"ckpt_path": ckpt_path}


def shared_network(start: int, end: int, num_classes: int,
                   layer_sizes: tuple, device: torch.device,
                   dtype: torch.dtype = torch.bfloat16,
                   factored_shortcut: bool = False,
                   shards: int = 1,
                   ckpt_path: Optional[str] = None) -> torch.nn.Module:
    """The one network (and parameter copy) per (range, shortcut form,
    checkpoint, device, shard degree): weights read from ``ckpt_path``
    or drawn from ``WEIGHT_SEED`` (``checkpoint.load_or_init``), filtered
    to the range, split into ``shards`` member shards where sharded
    (members sharing ``device``), cast once to the compute dtype."""
    factored_shortcut = bool(factored_shortcut)
    if ckpt_path is not None:
        ckpt_path = os.path.abspath(ckpt_path)
    key = (start, end, num_classes, tuple(layer_sizes), factored_shortcut,
           ckpt_path, str(device), dtype, int(shards))
    with _cache_lock:
        net = _network_cache.get(key)
        if net is None:
            net = make_sharded_apply(
                start, end, num_classes, tuple(layer_sizes),
                Ring([device] * int(shards)), factored_shortcut,
                dtype)(load_or_init(start, end, num_classes, layer_sizes,
                                    ckpt_path, factored_shortcut))
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


def dataset_samples(suffixes, num_samples: int = 3) -> list:
    """A few files of the dataset (``$RNB_TPU_DATA_ROOT``) with one of
    ``suffixes``, for a loader's decode warm-up; none without one."""
    root = os.environ.get("RNB_TPU_DATA_ROOT")
    if not root or not os.path.isdir(root):
        return []
    return [v for v in scan_video_tree(root)
            if v.endswith(tuple(suffixes))][:num_samples]


#: the native pixel format of each pixel path
PIXFMT = {"rgb": PIX_RGB, "yuv420": PIX_YUV420, "dct": PIX_DCT}
#: clips per native ticket: one request's decode fans out over the pool
POOL_CHUNK_CLIPS = 4


def submit_native(video: str, starts, frames: int, target: np.ndarray,
                  pixel_path: str) -> list:
    """Queue one request's native decode into ``target`` (its planned
    staging rows), a ticket per :data:`POOL_CHUNK_CLIPS` clips. A
    submit that fails part way waits the tickets already queued, so
    none is left writing into the rows."""
    pool = DecodePool.shared()
    tickets = []
    try:
        for lo in range(0, len(starts), POOL_CHUNK_CLIPS):
            hi = min(lo + POOL_CHUNK_CLIPS, len(starts))
            tickets.append(pool.submit_into(
                video, starts[lo:hi], frames, target[lo:hi],
                PIXFMT[pixel_path], FRAME_HW, FRAME_HW))
    except Exception:
        wait_tickets(tickets, video, swallow=True)
        raise
    return tickets


def wait_tickets(tickets, video: str, swallow: bool = False) -> None:
    """Wait every ticket, even after one failed (an unwaited ticket
    would leave its rows pinned in the pool), then raise the first
    decode error unless ``swallow``."""
    pool = DecodePool.shared()
    first_error = None
    for ticket in tickets:
        try:
            pool.wait(ticket, video)
        except ValueError as e:
            first_error = first_error or e
    if first_error is not None and not swallow:
        raise first_error


def warn_warmup_skipped(path: str, error: Exception) -> None:
    """A decode warm-up met a classified error: skip that sample (the
    hot loop contains the same error per request); anything else
    raises, as stage init must."""
    if classify_error(error) is FATAL:
        raise error
    print("[rnb-tpu-torch] WARNING: decode warm-up skipped %s: %s"
          % (path, error))


#: the longest a request waits for a fallback decode thread (the
#: reference's bound): past it the decode is a transient failure of that
#: request, never a hang of the stage
FALLBACK_DECODE_TIMEOUT_S = 120.0


def _fallback_result(future, video: str, timeout: float):
    """A fallback decode thread's result, waited at most ``timeout``
    seconds; a wedged decode raises :class:`TransientDecodeError`."""
    try:
        return future.result(timeout=timeout)
    except FuturesTimeout:
        raise TransientDecodeError(
            "fallback decode of %s unresponsive for %.0fs"
            % (video, timeout)) from None


class _DecodeHandle:
    """Decode work of one request, started ahead of its turn: ``wait()``
    blocks until the clip rows are in ``out``.

    A native decode writes into rows of a staging ``slot`` (``out`` is
    that view) through pool ``tickets``; the handle holds one reference
    on the slot until its rows are shipped or dropped. A numpy decode
    runs on a thread (``future``). A ``cached`` handle carries a
    clip-cache hit and a ``feature_plan`` handle a feature-page hit:
    neither owns decode work. A ``leader`` handle is a coalesced
    follower sharing another request's decode (and, on a slot, holding
    its own reference on the leader's rows). A failed ``wait()`` keeps
    its error and raises it again on every later wait, so a follower of
    a failed leader fails the same way."""

    __slots__ = ("out", "n", "future", "cached", "leader", "key", "error",
                 "feature_plan", "slot", "tickets", "video")

    def __init__(self, out, n, future=None, cached=None, leader=None,
                 key=None, slot=None, tickets=None, video=None):
        self.out = out          # wire rows (n, ...), set by the decode
        self.n = n              # valid clip count
        self.future = future    # the decode thread's future, or None
        self.cached = cached    # a cache hit's entry or plan, or None
        self.leader = leader    # coalesced: the leader's handle
        self.key = key          # cache key this decode inserts under
        self.error = None
        self.feature_plan = None  # a pinned feature-page hit, or None
        self.slot = slot        # the staging slot ``out`` lies in
        self.tickets = tickets  # native pool tickets, or None
        self.video = video

    def wait(self, timeout: float = FALLBACK_DECODE_TIMEOUT_S) -> None:
        if self.leader is not None:
            self.leader.wait(timeout=timeout)
            self.out = self.leader.out
            return
        if self.error is not None:
            raise self.error
        try:
            if self.tickets:
                tickets, self.tickets = self.tickets, None
                wait_tickets(tickets, self.video)
            if self.future is not None:
                self.out = _fallback_result(self.future, self.video,
                                            timeout)
                self.future = None
        except Exception as e:
            self.error = e
            raise


class R2P1DLoader(_TraceStamps, StageModel):
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
    network stage's fused ingest untouched, and so do the rgb path's
    with ``raw_output`` (the padded uint8 batch, for a mesh stage that
    ingests on its mesh; refused with dct, ragged or several row
    buckets, as in the reference).

    **Prefetch**: with a ``prefetch`` depth the stage exposes
    ``submit()`` / ``complete()`` / ``discard()`` and the executor starts
    the decode of requests N+1..N+k on a thread pool while request N's
    device work runs; the decode span on the TimeCard then measures only
    the residual wait. The native pool decodes prefetched requests
    straight into staging slots: ``staging_slots`` of them (default
    ``prefetch + 2``, never fewer; 0 turns the slots off and the native
    decodes are copied like the numpy ones); without ``prefetch`` every
    decode is synchronous and takes no slot. Decodes off the native pool
    (numpy, PIL, synthetic) run on ``fallback_decode_threads`` threads
    (default ``default_decode_threads()``). ``transfer_async`` is
    refused, as in the reference: this stage completes each request
    synchronously.

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
                 num_warmups: int = NUM_WARMUPS, raw_output: bool = False,
                 row_buckets=None, prefetch: int = 0,
                 pixel_path: str = "rgb", cache_mb: float = 0,
                 staging_slots=None, transfer_async: bool = False,
                 fallback_decode_threads=None,
                 ragged: bool = False, ragged_pool_rows=None,
                 dct_coeffs_per_frame=None):
        super().__init__(device)
        _check_pixel_path(pixel_path)
        if transfer_async:
            raise ValueError(
                "transfer_async requires a stage that emits "
                "asynchronously (R2P1DFusingLoader); %s completes "
                "requests synchronously" % type(self).__name__)
        self.fallback_decode_threads = _fallback_threads(
            fallback_decode_threads)
        self.torch_device = _device_of(device)
        self.pixel_path = pixel_path
        #: raw mode ships the padded uint8 wire batch unnormalized, for a
        #: consumer that ingests it on its mesh (R2P1DMeshRunner)
        self.raw_output = bool(raw_output)
        if pixel_path == "dct" and self.raw_output:
            raise ValueError(
                "pixel_path='dct' cannot combine with raw_output: mesh "
                "consumers ingest raw pixel batches, not packed "
                "coefficient rows")
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
        if self.ragged and self.raw_output:
            raise ValueError("ragged cannot be combined with raw_output: "
                             "mesh consumers shard a fixed clip axis, not "
                             "a rows_valid pool")
        self.padding = PadCounter()
        self.ragged_stats = ({"pool_rows": self.pool_rows, "emissions": 0,
                              "rows": 0, "pad_rows_eliminated": 0,
                              "cache_hit_rows": 0}
                             if self.ragged else None)
        if self.raw_output and len(self.row_buckets) > 1:
            raise ValueError("row_buckets cannot be combined with "
                             "raw_output: mesh consumers need a fixed clip "
                             "axis")
        self.prefetch_depth = int(prefetch)
        self._decode_pool = None  # built at the first numpy submit
        self._starts_cache: Dict[str, list] = {}
        #: the slots the native pool decodes prefetched requests into,
        #: one a request: by default the prefetch window, the head
        #: request and one transferring, and never fewer (fewer would
        #: deadlock submit against its own complete); the reference's
        #: sizing. Without prefetch every decode is synchronous and
        #: targets no slot, so ``staging_slots`` is ignored there.
        if staging_slots is not None and int(staging_slots) < 0:
            raise ValueError("staging_slots must be >= 0 (0 disables "
                             "staging), got %r" % (staging_slots,))
        min_slots = self.prefetch_depth + 2
        slots = min_slots if staging_slots is None else int(staging_slots)
        self.staging = None
        if self.prefetch_depth > 0 and slots and native_enabled():
            self.staging = StagingPool(self._batch_shape(self.max_clips),
                                       max(slots, min_slots),
                                       self.torch_device,
                                       _wire_dtype(pixel_path))
        #: the copy path: a numpy decode or a synchronous one is copied
        #: into one of these pinned buffers, as the reference does
        #: without its native decoder
        self._transfer = StagingPool(self._batch_shape(self.max_clips),
                                     self.TRANSFER_SLOTS,
                                     self.torch_device,
                                     _wire_dtype(pixel_path))
        #: entry signatures of the rgb device step (the reference's
        #: preprocess jit); the wire paths and raw mode run no device
        #: step here
        self.compiles = (SignatureTracker() if pixel_path == "rgb"
                         and not self.raw_output else None)
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
            _synchronize(self.torch_device)
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
    def output_dtype_for(cls, pixel_path: str = "rgb",
                         raw_output: bool = False, **_kwargs):
        """What the stage emits: normalized bfloat16 on the rgb path,
        the wire dtype otherwise (and in raw mode)."""
        if raw_output and pixel_path == "rgb":
            return "uint8"
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
        request pays no cold file or header cost. Best effort, as in the
        reference: a corrupt sample is skipped (the hot loop contains the
        same error per request); an unclassified error still raises."""
        for path in dataset_samples((".y4m",), num_samples):
            try:
                decoder = get_decoder(path)
                self._decode_sync(decoder, path,
                                  self._sample_starts(decoder, path))
            except Exception as e:
                warn_warmup_skipped(path, e)

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
        if self.raw_output:
            return device_wire
        if self.compiles is not None:
            self.compiles.observe(device_wire)
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
            _synchronize(self.torch_device)

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
        self._stamp((time_card,), "decode")
        if self.ragged:
            self.ragged_stats["cache_hit_rows"] += entry.valid
            if self.cache.paged:
                return self._materialize_pages(entry, time_card)
            return self._materialize(entry.batch, entry.valid, time_card)
        self._stamp((time_card,), "transfer_start", "transfer_done")
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
        self._stamp((time_card,), "transfer_start", "transfer_done")
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
        self._stamp((time_card,), *_ALL_STAGES)
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
        self._stamp((time_card,), "transfer_start")
        with hostprof.section("loader.transfer"), \
                trace.span("loader.transfer", time_card.id):
            device_wire = self._transfer.transfer(slot, shipped)
        self._stamp((time_card,), "transfer_done")
        if self.staging is not None:
            self.staging.note_emission(copied=True)
        return self._materialized(device_wire, n, time_card, cache_key)

    def _materialize_slot(self, handle: _DecodeHandle, time_card,
                          cache_key=None):
        """The staged twin of :meth:`_materialize`: the native pool
        decoded into the handle's slot rows, so they ship from there
        with no copy; a bucketed emission's pad rows are zeroed on the
        card. The handle's slot reference goes once the transfer is
        confirmed (a ragged blob insert copies the rows out first)."""
        n = handle.n
        try:
            if cache_key is not None and self.cache is not None \
                    and self.ragged and not self.cache.paged:
                self.cache.insert_rows(cache_key, handle.out, n)
            self._stamp((time_card,), "transfer_start")
            with hostprof.section("loader.transfer"), \
                    trace.span("loader.transfer", time_card.id):
                device_wire = self.staging.transfer_rows(
                    ((handle.slot, 0, n),), self._ship_rows(n),
                    zero_tail=not self.ragged)
            self._stamp((time_card,), "transfer_done")
        finally:
            self._release_handle_slot(handle)
        self.staging.note_emission(copied=False)
        return self._materialized(device_wire, n, time_card, cache_key)

    def _materialized(self, device_wire, n: int, time_card, cache_key):
        """An emission's device rows into the cache (paged or bucketed
        blob, insert-after-success), the padding counters and the
        device step."""
        if cache_key is not None and self.cache is not None:
            if self.ragged and self.cache.paged:
                self.cache.insert_pages(cache_key, device_wire, 0, n)
                self._stamp_feature_insert(time_card, cache_key, 0, n)
            elif not self.ragged:
                self.cache.insert_device(cache_key, device_wire, n)
        self._note_emission_padding(n, int(device_wire.shape[0]),
                                    [time_card])
        with hostprof.section("loader.normalize"):
            batch = self._normalize_emission(device_wire, n)
        return (self._wrap_batch(batch, n),), None, time_card

    def _release_handle_slot(self, handle: _DecodeHandle) -> None:
        """Retire a handle's slot reference (idempotent): its rows are
        shipped or dropped."""
        if handle.slot is not None:
            slot, handle.slot = handle.slot, None
            self.staging.release(slot)

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
                follower = _DecodeHandle(None, leader.n, leader=leader)
                if leader.slot is not None:
                    # the follower ships the leader's slot rows itself:
                    # its own reference keeps them from being reused
                    self.staging.add_ref(leader.slot)
                    follower.slot = leader.slot
                return follower
        decoder = get_decoder(video)
        starts = self._sample_starts(decoder, video)
        n = len(starts)
        time_card.num_clips = n
        if isinstance(decoder, NativeY4MDecoder) and self.staging is not None:
            self.ingest_stats["backends"].add(decoder.BACKEND)
            slot = self.staging.acquire()
            target = slot.array[:n]
            try:
                tickets = submit_native(video, starts,
                                        self.consecutive_frames, target,
                                        self.pixel_path)
            except Exception:
                self.staging.release(slot)
                raise
            handle = _DecodeHandle(target, n, key=key, slot=slot,
                                   tickets=tickets, video=video)
        else:
            if self._decode_pool is None:
                self._decode_pool = ThreadPoolExecutor(
                    max_workers=self.fallback_decode_threads,
                    thread_name_prefix="rnb-decode")
            handle = _DecodeHandle(None, n, key=key,
                                   future=self._decode_pool.submit(
                                       self._decode_sync, decoder, video,
                                       starts))
        if key is not None:
            self._inflight_keys.put(key, handle)
        trace.instant("loader.decode_submit", rid=time_card.id)
        return handle

    def _decode_waited(self, handle: "_DecodeHandle", time_card) -> None:
        """Wait a submitted decode (the residual the prefetch did not
        hide) and stamp its end."""
        with hostprof.section("loader.decode_wait"):
            handle.wait(timeout=FALLBACK_DECODE_TIMEOUT_S)
        self._stamp((time_card,), "decode")
        trace.instant("loader.decode_ready", rid=time_card.id)

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
            try:
                self._decode_waited(handle, time_card)
            except Exception:
                self._release_handle_slot(handle)
                raise
            if handle.slot is not None:
                return self._materialize_slot(handle, time_card)
            return self._materialize(handle.out, handle.n, time_card)
        try:
            self._decode_waited(handle, time_card)
        except Exception:
            self._release_handle_slot(handle)
            raise
        finally:
            # finalized either way: later requests for this key consult
            # the cache or decode afresh
            if self._inflight_keys is not None:
                self._inflight_keys.pop(handle.key)
        if handle.slot is not None:
            return self._materialize_slot(handle, time_card,
                                          cache_key=handle.key)
        return self._materialize(handle.out, handle.n, time_card,
                                 cache_key=handle.key)

    def discard(self, handle: _DecodeHandle, non_tensors=None) -> None:
        """Retire a submitted decode whose result will never be used,
        and release the page pins of an unserved hit."""
        del non_tensors
        try:
            handle.wait(timeout=FALLBACK_DECODE_TIMEOUT_S)
        except Exception:
            pass  # abort path: decode errors are moot
        # waited, so no decoder writes into the slot rows any more
        self._release_handle_slot(handle)
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
        with hostprof.section("loader.decode"):
            clips = self._decode_sync(decoder, video,
                                      self._sample_starts(decoder, video))
        self._stamp((time_card,), "decode")
        n = int(clips.shape[0])
        time_card.num_clips = n
        if key is not None:
            time_card.cache_hit = False
        return self._materialize(clips, n, time_card, cache_key=key)


class _FuseRecord:
    """One request of the fusing loader: its planned rows (``row0`` ..
    ``row0 + n`` of a staging ``slot``, on which it holds one
    reference), what fills them — native pool ``tickets``, a numpy
    decode ``future`` that copies into them, a ragged blob hit's rows
    copied at admission, or a paged hit's gather ``plan`` (the rows ship
    unfilled and the clip arena overwrites them on the card) — and every
    TimeCard riding on it: the leader's and any coalesced followers',
    which share its rows."""

    __slots__ = ("n", "cards", "key", "fkey", "plan", "slot", "row0",
                 "tickets", "future", "copied", "video", "t_ready")

    def __init__(self, n, card, slot, row0, key=None, fkey=None, plan=None,
                 video=None):
        self.n = n
        self.cards = [card]
        self.key = key     # cache key to insert under, None for a hit
        self.fkey = fkey   # content key for the feature-page insert
        self.plan = plan   # paged hit: its pinned GatherPlan
        self.slot = slot
        self.row0 = row0
        self.tickets = None  # native decode into the rows
        self.future = None   # numpy decode, copied into the rows
        #: the rows were placed by a host copy, not by the decoder
        self.copied = False
        self.video = video
        self.t_ready = 0.0

    @property
    def rows(self) -> np.ndarray:
        return self.slot.array[self.row0:self.row0 + self.n]

    def ready(self) -> bool:
        """The rows are filled (native tickets are only peeked)."""
        if self.tickets:
            pool = DecodePool.shared()
            return all(pool.peek(t) for t in self.tickets)
        return self.future is None or self.future.done()

    def wait(self, timeout: float = FALLBACK_DECODE_TIMEOUT_S) -> None:
        """Retire the decode that fills the rows; its error raises, and
        so does a fallback decode past ``timeout`` seconds."""
        if self.tickets:
            tickets, self.tickets = self.tickets, None
            wait_tickets(tickets, self.video)
        if self.future is not None:
            future, self.future = self.future, None
            _fallback_result(future, self.video, timeout)


class R2P1DFusingLoader(_TraceStamps, StageModel):
    """Decode stage with loader-side dynamic batching.

    Each request is given its rows in a pinned staging slot when it is
    admitted (submit-time row planning: a slot takes ``fuse`` requests
    or ``max_clips`` rows, the emission rules below) and its decode
    starts at once: ``.y4m`` and ``.mjpg`` files on the native C++ pool,
    which decodes straight into those rows, everything else (synthetic
    ids, and the numpy and PIL decoders under ``RNB_DISABLE_NATIVE``) on
    ``fallback_decode_threads`` threads (default
    ``default_decode_threads()``), which copy their result into them.
    ``prefetch`` is refused with the reference's message: the in-flight
    window is ``depth``. Requests whose decode finished
    are taken in FIFO order and emitted as ONE fused batch with a
    TimeCardList; the emission copies their rows from the slots to the
    card (one copy per run of adjacent rows) with no assembly copy on
    the host. Emission policy (the reference's):

      * emit when ``fuse`` requests are ready or their rows reach the
        max shape;
      * emit a partial batch when nothing is left in flight;
      * emit when the oldest ready request has waited ``max_hold_ms``;
      * block on the oldest in-flight decode once ``depth`` (default
        ``2 * fuse``) requests are pending (backpressure toward the
        client queue).

    Under the root ``autotune`` key (``enable_autotune``) the load-adaptive
    controller's decision takes the place of the ``max_hold_ms`` rule: it
    emits at once when growing the batch cannot meet the latency budget,
    holds toward a warmed bucket when it can, and ``fuse`` / the max rows
    stay ceilings.

    The transfer runs on a dedicated stream; with ``transfer_async`` on
    a worker thread while the next batch decodes. Bucketed emissions
    zero their pad rows on the card; ragged emissions ship the pool
    shape with the tail unwritten — the ingest kernels treat rows past
    ``rows_valid`` as zero bytes and never read them.

    With ``cache_mb`` a clip cache serves repeated videos
    (:mod:`rnb_tpu_torch.cache`): a bucketed hit is emitted at once as
    its cached device batch; a ragged hit takes rows in the next pool —
    a blob hit copies its host rows in, a paged hit (after
    ``enable_pager``) ships them unfilled and has them overwritten on
    the card by the clip arena's gather after the transfer. A request
    whose video is decoding parks on that decode (coalescing). With
    feature pages, a request whose logits are stored skips decode,
    transfer and the forward: it is emitted at once as a stub, and the
    runner gathers its logits.

    **Containment** (:mod:`rnb_tpu_torch.faults`): a decode that fails
    inside a fused take does not poison its batchmates. A transient
    failure is retried by a synchronous re-decode into the same planned
    rows, up to the step's ``fault_retry_budget`` (the executor hands it
    the step's ``max_retries`` and ``retry_backoff_ms``); a permanent one
    (or an exhausted budget) parks every card riding the record on
    :meth:`take_failed`, releases its rows and page pins, and the take
    emits the survivors in a warmed bucket. A record whose every card's
    deadline passed while it waited to be fused is dropped the same way
    and surfaces through :meth:`take_shed` (site ``hold``).
    """

    SUPPORTS_RAGGED = True
    SUPPORTS_PAGER = True
    #: the hold deadline / accumulation target can be driven by the
    #: load-adaptive controller (rnb_tpu_torch.autotune)
    SUPPORTS_AUTOTUNE = True
    #: this stage feeds the controller's service estimator itself (batch
    #: close -> ready queue, fed at ``_pop_ready``): under transfer_async
    #: every emission surfaces through ``take_ready``/``poll``, never
    #: through a stamp-bearing call, so the executor must not feed it
    AUTOTUNE_SELF_SERVICE = True

    #: staging depth: one slot filling, one transferring, one spare
    DEFAULT_STAGING_SLOTS = 3

    #: harvest-check tick while decodes are in flight
    HARVEST_TICK_S = 0.005
    #: ready-queue poll tick while draining the transfer worker
    FLUSH_TICK_S = 0.0005

    GUARDED_BY = {"_out_ready": "_out_lock"}

    UNGUARDED_OK = {
        "_ready": "executor-thread confined; only the _out_ready "
                  "handoff crosses the transfer-worker boundary",
        "_open_slot": "executor-thread confined (see _ready)",
        "_open_rows": "executor-thread confined (see _ready)",
        "_open_count": "executor-thread confined (see _ready)",
        "_failed": "executor-thread confined (see _ready)",
        "_stage_retries": "executor-thread confined (see _ready)",
        "_deadline_shed": "executor-thread confined (see _ready)",
        "_starts_cache": "executor-thread confined (see _ready)",
        "_decode_pool": "built at the executor's first numpy submit, "
                        "shut down by discard_pending at teardown",
        "autotune": "set by enable_autotune before the start barrier",
        "ragged_stats": "executor-thread confined (see _ready)",
        "pager": "set by enable_pager before the start barrier",
        "_clip_arena": "set by enable_pager before the start barrier",
        "_zero_pool": "set by enable_pager before the start barrier",
        "_feature_stub": "set by enable_pager before the start barrier",
    }

    def __init__(self, device, fuse: int = 6, depth: Optional[int] = None,
                 max_hold_ms: float = 5.0,
                 max_clips: int = MAX_CLIPS, num_warmups: int = NUM_WARMUPS,
                 consecutive_frames: int = CONSECUTIVE_FRAMES,
                 num_clips_population=None, weights=None,
                 row_buckets=None,
                 pixel_path: str = "rgb", staging_slots=None,
                 transfer_async: bool = False, ragged: bool = False,
                 ragged_pool_rows=None, dct_coeffs_per_frame=None,
                 cache_mb=None, fallback_decode_threads=None,
                 prefetch: int = 0):
        if prefetch:
            raise ValueError(
                "R2P1DFusingLoader manages its own decode pipeline; "
                "its in-flight window is `depth`, not `prefetch`")
        super().__init__(device)
        _check_pixel_path(pixel_path)
        self.fallback_decode_threads = _fallback_threads(
            fallback_decode_threads)
        self.dct_coeffs = _dct_coeffs(pixel_path, dct_coeffs_per_frame)
        if int(fuse) < 1:
            raise ValueError("fuse must be >= 1, got %r" % (fuse,))
        self.torch_device = _device_of(device)
        self.pixel_path = pixel_path
        self.fuse = int(fuse)
        #: the in-flight decode window
        self.depth = int(depth) if depth is not None else 2 * self.fuse
        self.max_hold_ms = float(max_hold_ms)
        self.max_clips = int(max_clips)
        self.consecutive_frames = int(consecutive_frames)
        # the sampler's population and weights, as the reference's
        # fusing loader inherits them from its base loader
        sampler_kwargs = {}
        if num_clips_population is not None:
            sampler_kwargs["num_clips_population"] = num_clips_population
        if weights is not None:
            sampler_kwargs["weights"] = weights
        self.sampler = R2P1DSampler(
            consecutive_frames=self.consecutive_frames, **sampler_kwargs)
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
        if slots < 1:
            # the reference falls back to copying emissions; here every
            # request's rows are planned into a slot at submit
            raise ValueError(
                "R2P1DFusingLoader plans each request's rows into a "
                "staging slot: staging_slots must be >= 1, got %r"
                % (staging_slots,))
        self.staging = StagingPool(self._batch_shape(self.max_clips),
                                   slots, self.torch_device,
                                   _wire_dtype(pixel_path))
        #: the slot rows are planned into: it holds one reference of its
        #: own until it is sealed
        self._open_slot = None
        self._open_rows = 0
        self._open_count = 0
        #: the pixel path and every decode backend that served a request
        self.ingest_stats = {"pixel_path": pixel_path, "backends": set()}
        #: entry signatures of the rgb device step (the reference's
        #: preprocess jit); the wire paths run no device step here
        self.compiles = SignatureTracker() if pixel_path == "rgb" else None
        self.transfer_async = bool(transfer_async)
        self._worker = (TransferWorker(self.staging)
                        if self.transfer_async else None)
        self._decode_pool = None  # numpy decode threads, at first use
        self._starts_cache: Dict[str, list] = {}
        self._inflight: deque = deque()  # decode still running
        self._ready: deque = deque()     # decode complete
        #: completed emissions awaiting pickup, each with its shipped
        #: rows and close -> ready seconds; appended by the transfer
        #: worker under transfer_async
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
                self.consecutive_frames, FRAME_HW, self.pixel_path,
                self.max_clips, self.row_buckets,
                # ragged entries are host rows or pages, bucketed ones
                # padded device batches: the two never alias
                self.ragged, self.dct_coeffs)
        #: the page allocator and its clip arena (``enable_pager``)
        self.pager = None
        self._clip_arena = None
        self._zero_pool = None
        self._feature_stub = None
        #: the load-adaptive controller (``enable_autotune``); None keeps
        #: the static ``max_hold_ms`` rule
        self.autotune = None
        #: the transient-retry budget ``(max_retries, backoff_ms)``, set by
        #: the executor from the step's keys (``(0, 0)`` in strict mode)
        self.fault_retry_budget = (0, 0.0)
        #: contained failures ``[(card, reason)]``, retries made and
        #: deadline sheds ``[(card, where)]``, drained by the executor
        self._failed: list = []
        self._stage_retries = 0
        self._deadline_shed: list = []
        # warm-up: fault in the pinned slots and the transfer path at
        # every shape an emission ships (and, on the rgb path, build and
        # launch the loader's normalize kernel)
        for rows in self._warm_shapes():
            for _ in range(num_warmups):
                self._normalize_emission(self.staging.transfer(
                    self.staging.acquire(), rows), rows)
        if self.torch_device.type == "cuda":
            _synchronize(self.torch_device)
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
        """What the stage emits: the loader's dtypes (normalized
        bfloat16 on the rgb path, the wire dtype otherwise)."""
        return R2P1DLoader.output_dtype_for(pixel_path=pixel_path)

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
            _synchronize(self.torch_device)

    def enable_autotune(self, settings) -> BatchController:
        """Executor protocol: a BatchController over this stage's own
        warmed buckets — on the card, the shapes whose forward graphs the
        runner captured before the start barrier, so no decision can
        cause a capture inside the measured window. Under ragged dispatch
        every row count ships the one pool shape, so the candidates are
        1..pool_rows."""
        if self.ragged:
            self.autotune = BatchController.for_stage(
                settings, tuple(range(1, self.pool_rows + 1)),
                self.pool_rows)
        else:
            self.autotune = BatchController.for_stage(
                settings, self.row_buckets, self.max_clips)
        return self.autotune

    def _batch_shape(self, rows: int):
        return _wire_batch_shape(rows, self.pixel_path, self.dct_coeffs,
                                 self.consecutive_frames)

    def _normalize_emission(self, device_wire: torch.Tensor, valid: int):
        if self.compiles is not None:
            self.compiles.observe(device_wire)
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

    def _warm_decode(self, num_samples: int = 3) -> None:
        """Decode a few files of the dataset once before the measured
        window, as the reference's loaders do: the native library is
        built or loaded and its pool started here, so the first measured
        request pays neither that nor a cold file or header."""
        suffixes = ((".mjpg", ".mjpeg") if self.pixel_path == "dct"
                    else (".y4m",))
        for path in dataset_samples(suffixes, num_samples):
            try:
                decoder = get_decoder(path)
                starts = self._sample_starts(decoder, path)
                self._decode_into(decoder, path, starts, np.empty(
                    self._batch_shape(len(starts)),
                    np.int16 if self.pixel_path == "dct" else np.uint8))
            except Exception as e:
                warn_warmup_skipped(path, e)
                continue
            if isinstance(decoder, NativeY4MDecoder):
                DecodePool.shared()

    def _decode_into(self, decoder, video: str, starts, target) -> None:
        """A numpy decode on a decode thread, copied into the request's
        planned rows."""
        if self.pixel_path == "dct":
            target[...] = decoder.decode_clips_dct(
                video, starts, self.consecutive_frames, FRAME_HW, FRAME_HW,
                self.dct_coeffs)
        elif self.pixel_path == "yuv420":
            target[...] = decoder.decode_clips_yuv(
                video, starts, self.consecutive_frames, FRAME_HW, FRAME_HW)
        else:
            target[...] = decoder.decode_clips(
                video, starts, self.consecutive_frames, FRAME_HW, FRAME_HW)

    # -- submit-time row planning ------------------------------------------

    def _stage_target(self, n: int):
        """Place ``n`` rows of a request in the open slot, opening a
        fresh one when it has taken ``fuse`` requests or its rows would
        pass ``max_clips`` (the emission rules, so a full take is one
        slot). The request holds a reference on the slot. -> (slot,
        row0)."""
        if (self._open_slot is None or self._open_count >= self.fuse
                or self._open_rows + n > self.max_clips):
            self._seal_open_slot()
            self._open_slot = self._acquire_fused_slot()
        slot, row0 = self._open_slot, self._open_rows
        self.staging.add_ref(slot)
        self._open_rows += n
        self._open_count += 1
        return slot, row0

    def _seal_open_slot(self) -> None:
        """Plan no more rows into the open slot: drop its own
        reference (its requests keep theirs)."""
        if self._open_slot is not None:
            slot, self._open_slot = self._open_slot, None
            self._open_rows = self._open_count = 0
            self.staging.release(slot)

    def _acquire_fused_slot(self):
        """A fresh slot. When none is free, finish this stage's own work
        first — wait the oldest decode and emit, which releases slots —
        since the emissions run on this same thread; block only when
        nothing is left but transfers in flight on the worker."""
        slot = self.staging.try_acquire()
        while slot is None:
            if self._inflight or self._ready:
                if not self._ready:
                    self._retire_oldest()
                self._harvest()
                self._emit()
                slot = self.staging.try_acquire()
                continue
            slot = self.staging.acquire()
        return slot

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

    def enable_trace(self, tracer, step_idx: int) -> None:
        """On top of the staging counter: sample the decode window —
        decodes in flight plus decoded but unemitted requests (deque
        lengths are safe to read from the sampler thread)."""
        super().enable_trace(tracer, step_idx)
        tracer.add_counter_source(
            trace.name("loader.s%d.inflight", step_idx),
            lambda: len(self._inflight) + len(self._ready))

    def _emit_feature(self, plan, time_card):
        """A feature-page hit, emitted at once as its own dispatch: the
        stub pool goes downstream (never read), and the pinned plan rides
        the card to the runner, which gathers the stored logits and
        releases it."""
        self._stamp((time_card,), *_ALL_STAGES)
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
        self._stamp((time_card,), *_ALL_STAGES)
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

    def _admit(self, rec: _FuseRecord):
        """A planned record joins the window in arrival order; then the
        emission rules and the depth backpressure."""
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

    def __call__(self, tensors, non_tensors, time_card):
        video = str(non_tensors)
        time_card.video = video
        fkey, fplan = self._feature_probe(video)
        if fplan is not None:
            return self._emit_feature(fplan, time_card)
        key, entry = self._cache_lookup(video, key=fkey)
        if entry is not None and self.ragged:
            # a ragged hit takes pool rows like a decode that finished
            # at once, and joins the window in arrival order
            n = entry.valid
            time_card.num_clips = n
            time_card.cache_hit = True
            self.ragged_stats["cache_hit_rows"] += n
            if self.autotune is not None:
                self.autotune.observe_rows(n)
            slot, row0 = self._stage_target(n)
            if self.cache.paged:
                rec = _FuseRecord(n, time_card, slot, row0, fkey=fkey,
                                  plan=entry)
            else:
                rec = _FuseRecord(n, time_card, slot, row0, fkey=fkey)
                rec.rows[...] = entry.batch[:n]
                rec.copied = True
            return self._admit(rec)
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
        n = len(starts)
        time_card.num_clips = n
        self.ingest_stats["backends"].add(decoder.BACKEND)
        slot, row0 = self._stage_target(n)
        rec = _FuseRecord(n, time_card, slot, row0, key=key, fkey=fkey,
                          video=video)
        try:
            if isinstance(decoder, NativeY4MDecoder):
                rec.tickets = submit_native(video, starts,
                                            self.consecutive_frames, rec.rows,
                                            self.pixel_path)
            else:
                if self._decode_pool is None:
                    self._decode_pool = ThreadPoolExecutor(
                        max_workers=self.fallback_decode_threads,
                        thread_name_prefix="rnb-decode")
                rec.copied = True
                rec.future = self._decode_pool.submit(
                    self._decode_into, decoder, video, starts, rec.rows)
        except Exception:
            self.staging.release(slot)
            raise
        if key is not None:
            self._inflight_keys.put(key, rec)
        trace.instant("loader.decode_submit", rid=time_card.id)
        if self.autotune is not None:
            # rows per request: converts a bucket target into a count of
            # requests still to arrive (coalesced followers add cards,
            # not rows, so they do not feed it)
            self.autotune.observe_rows(n)
        return self._admit(rec)

    def _retire_oldest(self) -> None:
        rec = self._inflight.popleft()
        with hostprof.section("loader.decode_wait"):
            ok = self._wait_contained(rec)
        if ok:
            rec.t_ready = time.monotonic()
            self._ready.append(rec)
            trace.instant("loader.decode_ready", rid=rec.cards[0].id)

    # -- containment ------------------------------------------------------

    def _wait_contained(self, rec: _FuseRecord) -> bool:
        """Wait one record's decode; True on success. A transient failure
        is retried by a synchronous re-decode into the same rows, up to
        ``fault_retry_budget``; a permanent one, or an exhausted budget,
        parks the record (:meth:`_park_failed`); an unclassified error
        raises. The failed decode's tickets are all waited before the
        error surfaces, so no decoder still writes into the rows."""
        try:
            rec.wait(timeout=FALLBACK_DECODE_TIMEOUT_S)
            return True
        except Exception as e:
            kind = classify_error(e)
            if kind is FATAL:
                raise
            reason = fault_reason(e)
        if kind is TRANSIENT:
            max_retries, backoff_ms = self.fault_retry_budget
            for _ in range(int(max_retries)):
                self._stage_retries += 1
                if backoff_ms > 0:
                    time.sleep(backoff_ms / 1000.0)
                try:
                    decoder = get_decoder(rec.video)
                    self._decode_into(decoder, rec.video,
                                      self._sample_starts(decoder, rec.video),
                                      rec.rows)
                    rec.copied = True
                    return True
                except Exception as e:
                    kind = classify_error(e)
                    if kind is FATAL:
                        raise
                    reason = fault_reason(e)
                    if kind is not TRANSIENT:
                        # a permanent verdict: no retry can help
                        self._park_failed(rec, reason)
                        return False
            reason = "retries-exhausted:" + reason
        self._park_failed(rec, reason)
        return False

    def _park_failed(self, rec: _FuseRecord, reason: str) -> None:
        """Every card riding the record (leader and coalesced followers)
        fails as a unit and nothing of it is cached: its slot reference
        and any page pin go, and the executor dead-letters its cards."""
        self._drop_record(rec)
        self._failed.extend((tc, reason) for tc in rec.cards)

    def _drop_record(self, rec: _FuseRecord) -> None:
        """Retire a record that will not be emitted: its coalescing
        window, its page pin and its slot reference (its decode is
        already waited)."""
        self._drop_coalesce(rec)
        if rec.plan is not None:
            rec.plan.release()
            rec.plan = None
        self.staging.release(rec.slot)

    def take_failed(self):
        """Executor hook: the contained failures ``[(card, reason)]``."""
        out, self._failed = self._failed, []
        return out

    def take_retries(self) -> int:
        """Executor hook: the retries made while assembling takes."""
        n, self._stage_retries = self._stage_retries, 0
        return n

    def take_shed(self):
        """Executor hook: the requests shed here because their deadline
        passed while their decoded rows waited ``[(card, "hold")]``."""
        out, self._deadline_shed = self._deadline_shed, []
        return out

    def _drop_expired_ready(self) -> None:
        """The loader's hold boundary of the deadline layer: a decoded
        record whose every card's deadline passed while it waited to be
        fused is dropped before the take (its rows shared by every card
        riding it, one live card keeps it). Inert when no card carries a
        deadline."""
        if not self._ready or not any(
                getattr(rec.cards[0], "deadline_s", None) is not None
                for rec in self._ready):
            return
        kept = deque()
        for rec in self._ready:
            if all(deadline_expired(tc) for tc in rec.cards):
                try:
                    # decode-complete: retires its tickets
                    rec.wait(timeout=FALLBACK_DECODE_TIMEOUT_S)
                except Exception:
                    pass  # shed either way
                self._drop_record(rec)
                self._deadline_shed.extend((tc, "hold") for tc in rec.cards)
            else:
                kept.append(rec)
        self._ready = kept

    def _harvest(self) -> None:
        """Move decode-complete requests to ready, in FIFO order."""
        while self._inflight and self._inflight[0].ready():
            rec = self._inflight.popleft()
            rec.t_ready = time.monotonic()
            self._ready.append(rec)
            trace.instant("loader.decode_ready", rid=rec.cards[0].id)

    # -- emission -------------------------------------------------------------

    def _emit(self) -> bool:
        """Fuse ready requests (up to ``fuse`` / the max rows) into one
        batch and ship it. False when nothing was ready."""
        with hostprof.section("loader.emit"), trace.span("loader.emit"):
            return self._emit_take()

    def _emit_take(self) -> bool:
        """:meth:`_emit`'s body: take, assemble, hand to the transfer."""
        take, rows = [], 0
        while self._ready and len(take) < self.fuse:
            n = self._ready[0].n
            if take and rows + n > self.max_clips:
                break
            take.append(self._ready.popleft())
            rows += n
        # a failed decode leaves the take: the survivors are emitted
        take = [rec for rec in take if self._wait_contained(rec)]
        if not take:
            return False
        rows = sum(rec.n for rec in take)
        for rec in take:
            # finalizing: a later same-key request consults the cache
            self._drop_coalesce(rec)
        if rows > self.max_clips:
            raise RuntimeError("fused %d rows over max_clips=%d"
                               % (rows, self.max_clips))
        if self._trace_step is not None:
            # each request's decode ended when it was harvested (its
            # monotonic t_ready on the wall clock), its hold ends now
            now, now_mono = time.time(), time.monotonic()
            for rec in take:
                self._stamp(rec.cards, "decode",
                            at=now - max(0.0, now_mono - rec.t_ready))
                self._stamp(rec.cards, "transfer_start", at=now)
        shipped = self.pool_rows if self.ragged else self._bucket_for(rows)
        if self.autotune is not None:
            # every emission is attributed to its shipped bucket (the
            # valid rows under ragged); one no decision preceded counts
            # as an immediate decision
            self.autotune.note_emission(rows if self.ragged else shipped)
        # the service span the controller budgets opens here, where the
        # batch stopped accumulating, and closes when the emission lands
        # on the ready queue: after the transfer's copies are confirmed
        # (transfer_rows waits on its event, as it always does) and the
        # ingest kernel is queued; nothing more waits on the card for it
        t_close = time.monotonic()
        paged = self.cache is not None and self.cache.paged
        offsets = segment_offsets_of(rec.n for rec in take)
        cards, gather_plans, insert_jobs, runs = [], [], [], []
        for i, rec in enumerate(take):
            row0 = offsets[i]
            if runs and runs[-1][0] is rec.slot \
                    and runs[-1][1] + runs[-1][2] == rec.row0:
                runs[-1][2] += rec.n  # adjacent rows: one copy
            else:
                runs.append([rec.slot, rec.row0, rec.n])
            hit = rec.plan is not None
            if hit:
                # a paged hit's rows ship unfilled: the clip arena's
                # gather overwrites them after the transfer
                gather_plans.append((row0, rec.plan))
                rec.plan = None
            for tc in rec.cards:
                tc.row0 = row0
            cards.extend(rec.cards)
            if paged:
                if not hit and rec.key is not None:
                    insert_jobs.append((rec.key, row0, rec.n))
                self._stamp_feature_insert(rec.cards[0], rec.fkey, row0,
                                           rec.n)
            elif self.cache is not None and rec.key is not None:
                # insert-after-success: the decode completed; both blob
                # inserts copy the rows out before the slot is released
                if self.ragged:
                    self.cache.insert_rows(rec.key, rec.rows, rec.n)
                else:
                    self.cache.insert_host(
                        rec.key, rec.rows, rec.n,
                        self._batch_shape(self._bucket_for(rec.n)),
                        _wire_dtype(self.pixel_path))
        self._note_emission(rows, shipped, cards)
        self.staging.note_emission(any(rec.copied for rec in take))
        slots = [rec.slot for rec in take]

        def job():
            try:
                with hostprof.section("loader.transfer"), \
                        trace.span("loader.transfer"):
                    batch = self.staging.transfer_rows(
                        [tuple(run) for run in runs], shipped,
                        zero_tail=not self.ragged)
            finally:
                # the copies are confirmed (or failed): the rows go
                for slot in slots:
                    self.staging.release(slot)
            self._stamp(cards, "transfer_done")
            if gather_plans or insert_jobs:
                batch = self._overlay_pages(batch, gather_plans,
                                            insert_jobs)
            batch = self._normalize_emission(batch, rows)
            if self.ragged:
                wrapped = RaggedBatch(batch, rows, offsets)
            else:
                wrapped = PaddedBatch(batch, rows)
            with self._out_lock:
                self._out_ready.append((((wrapped,), None,
                                         TimeCardList(cards)), shipped,
                                        time.monotonic() - t_close))

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
        are done). The arena's work is ordered after the transfer stream,
        and the calling thread's stream after the gather, on the card:
        the normalize and the runner's ingest behind it never read a pool
        row the gather has not written, and the host does not wait."""
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
        if stream is not None:
            # the normalize runs on this thread's stream: order it after
            # the gather (which the transfer stream waits for) on the
            # card, and keep the rows from reuse until it has read them
            current = torch.cuda.current_stream(batch.device)
            current.wait_stream(stream)
            batch.record_stream(current)
        return batch

    def _pop_ready(self):
        """The oldest completed emission, or None. Its close -> ready
        span feeds the controller here, on the executor thread that
        owns it (the span may have been measured on the worker)."""
        with self._out_lock:
            if not self._out_ready:
                return None
            emission, shipped, service_s = self._out_ready.popleft()
        if self.autotune is not None:
            self.autotune.observe_service(shipped, service_s)
        return emission

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
            if self.autotune is not None:
                # the controller's deadline; peek, since this runs every
                # poll and a tick is not a decision
                dec = self.autotune.peek(
                    len(self._ready), sum(rec.n for rec in self._ready),
                    waited)
                remaining = max(0.0, dec.hold_s - waited)
            else:
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
        self._drop_expired_ready()
        if not self._ready:
            return None
        rows_ready = sum(rec.n for rec in self._ready)
        waited_s = time.monotonic() - self._ready[0].t_ready
        if self.autotune is not None:
            # the controller's target and deadline replace max_hold_ms;
            # fuse and the max rows stay ceilings
            dec = self.autotune.decide(len(self._ready), rows_ready,
                                       waited_s)
            held_out = (rows_ready >= dec.target_rows
                        or waited_s >= dec.hold_s)
        else:
            held_out = waited_s * 1000.0 > self.max_hold_ms
        if (len(self._ready) >= self.fuse or rows_ready >= self.max_clips
                or not self._inflight or held_out):
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
        """Teardown: drop unemitted work — every decode is waited first,
        so no decoder writes into a slot after its rows are released —
        release the page pins of unemitted hits, and stop the helper
        threads."""
        for rec in list(self._inflight) + list(self._ready):
            try:
                rec.wait(timeout=FALLBACK_DECODE_TIMEOUT_S)
            except Exception:
                pass  # abort path: decode errors are moot
            self._drop_record(rec)
        self._inflight.clear()
        self._ready.clear()
        self._seal_open_slot()
        if self._worker is not None:
            self._worker.close()
        if self._decode_pool is not None:
            self._decode_pool.shutdown(wait=True, cancel_futures=True)
        with self._out_lock:
            self._out_ready.clear()


class CapturedForward:
    """One captured CUDA graph of a stage's forward at one input
    signature: the card's counterpart of one compiled executable.

    A replay reads fixed addresses, so the stage input is copied into
    ``static_in`` and its second input into ``static_rows_valid`` (the
    one int32 element the ragged ingest reads, an int filled in; or the
    mesh step's clip mask, a tensor copied in; None where the forward
    reads none), both on the current stream and outside the graph; the
    graph then runs, and ``static_out`` is copied out, since the next
    replay overwrites it. ``launches`` is the tally of hand-written
    kernel launches recorded at capture; every replay counts it once."""

    __slots__ = ("graph", "static_in", "static_rows_valid", "static_out",
                 "launches", "capture_s")

    def __init__(self, graph, static_in, static_rows_valid, static_out,
                 launches, capture_s: float = 0.0):
        self.graph = graph
        self.static_in = static_in
        self.static_rows_valid = static_rows_valid
        self.static_out = static_out
        self.launches = dict(launches)
        self.capture_s = float(capture_s)

    def replay(self, x: torch.Tensor, rows_valid) -> torch.Tensor:
        with hostprof.section("runner.copy_in"):
            self.static_in.copy_(x)
            if isinstance(rows_valid, torch.Tensor):
                self.static_rows_valid.copy_(rows_valid)
            elif self.static_rows_valid is not None:
                self.static_rows_valid.fill_(int(rows_valid))
        with hostprof.section("runner.graph_replay"):
            self.graph.replay()
        _kernels.add_launches(self.launches)
        with hostprof.section("runner.copy_out"):
            return _clone_out(self.static_out)


def _clone_out(out):
    """A forward's output copied: a tensor, or a sharded head's column
    blocks."""
    if isinstance(out, list):
        return [t.clone() for t in out]
    return out.clone()


def capture_forward(run, static_in: torch.Tensor, static_rows_valid,
                    pool, stream: torch.cuda.Stream) -> CapturedForward:
    """Capture ``run()`` (a forward over the static inputs) as one CUDA
    graph: warm up on the capture stream (PyTorch's rule), then record
    into the stage's memory pool, in thread-local mode since other
    stages issue work on the card meanwhile. The caller holds
    ``_DEVICE_SYNC_LOCK``: no other stage captures or synchronizes the
    device until it is done."""
    device = static_in.device
    stream.wait_stream(torch.cuda.current_stream(device))
    t0 = time.monotonic()
    with torch.cuda.stream(stream):
        run()
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with _kernels.recording() as tally, torch.cuda.graph(
            graph, pool=pool, stream=stream,
            capture_error_mode="thread_local"):
        static_out = run()
    return CapturedForward(graph, static_in, static_rows_valid, static_out,
                           tally, time.monotonic() - t0)


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

    The weights come from ``ckpt_path`` where a file is named (the
    port's checkpoint format, or a flax msgpack file of the JAX package;
    a converted torch checkpoint needs ``factored_shortcut``), the stage
    holding its range's keys only, else from the seeded init
    (``checkpoint.load_or_init``); an explicit path that does not exist
    raises ``FileNotFoundError`` before any warm-up.

    With feature pages (``enable_pager``) the runner stores each
    stamped request's output rows after its forward returned, and
    answers a feature hit by gathering them back over a zero logit pool
    without running the ingest or the network.

    On the card the forward is compiled, as the reference's is: after
    the eager warm-ups, ``__init__`` captures one CUDA graph
    (:class:`CapturedForward`) per signature — each bucket's input
    shape and dtype; under ragged, the pool shape and each tile count
    ``1 .. pool_rows / chunk`` — and every forward replays the graph of
    its signature. ``compiles`` counts the input signatures as the
    reference's does; a signature first seen in the measured window is
    captured then and counted as ``steady_new``. A capture or a replay
    that fails raises: there is no eager fallback. On the CPU the
    forward is eager.

    With ``shard_degree`` (the step's ``shard`` key; rnb_tpu_torch.
    parallel.shardplan) the stage runs over a ring of ``shard_degree``
    members, which must share its device: the network holds its
    temporal conv kernels and its head in member shards and gathers
    them all to full width at the start of the forward, inside the
    captured graph, so the logits are bitwise the unsharded stage's. A head stage's
    forward leaves the logits in column blocks, and the merge gather
    runs after it, outside the graph, timed on the host as
    ``exec{i}.collective`` (``shard_stats``). A declared degree, 1
    included, projects the per-member HBM footprint and, with
    ``shard_hbm_budget_mb``, refuses a launch that does not fit.
    """

    SUPPORTS_RAGGED = True
    SUPPORTS_PAGER = True
    #: the step's ``shard`` key slices its layer range's weights
    SUPPORTS_SHARD = True

    def __init__(self, device, start_index: int = 1,
                 end_index: int = NUM_LAYERS,
                 num_classes: int = KINETICS_CLASSES,
                 layer_sizes=R18_LAYER_SIZES, max_rows: int = MAX_CLIPS,
                 consecutive_frames: int = CONSECUTIVE_FRAMES,
                 num_warmups: int = NUM_WARMUPS, row_buckets=None,
                 pixel_path: str = "rgb", ragged: bool = False,
                 ragged_pool_rows=None, ragged_chunk_rows=None,
                 dct_coeffs_per_frame=None, factored_shortcut: bool = False,
                 shard_devices=None, shard_degree=None,
                 shard_axis: str = "tp", shard_hbm_budget_mb=None,
                 ckpt_path: Optional[str] = None,
                 network: Optional[torch.nn.Module] = None):
        super().__init__(device)
        _check_pixel_path(pixel_path)
        self.factored_shortcut = bool(factored_shortcut)
        #: the checkpoint file the weights come from (None: seeded)
        self.ckpt_path = ckpt_path
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
        # a declared degree, 1 included, arms the feasibility gate and
        # the Shard: accounting; None means no shard key at all
        self.shard_declared = shard_degree is not None
        self.shard_degree = (int(shard_degree) if self.shard_declared
                             else 1)
        self.shard_axis = str(shard_axis)
        self.shard_hbm_budget_mb = (float(shard_hbm_budget_mb)
                                    if shard_hbm_budget_mb is not None
                                    else None)
        if self.shard_degree < 1:
            raise ValueError("shard_degree must be >= 1, got %r"
                             % (shard_degree,))
        #: the shard ring and the head's merge (degree > 1 only)
        self.ring = None
        self._merge = None
        if self.shard_degree > 1:
            validate_degree(self.shard_degree, self.start_index,
                            self.end_index, int(num_classes))
            if self.ragged and self.ragged_chunk_rows:
                if ragged_chunk_rows is not None:
                    raise ValueError(
                        "ragged_chunk_rows=%r cannot be combined with "
                        "shard_degree=%d: the sharded applier is ONE "
                        "whole-pool program (chunking would change the op "
                        "graph and break bit parity with the unsharded "
                        "forward)" % (ragged_chunk_rows, self.shard_degree))
                # the auto-chunk default collapses to whole-pool apply
                self.ragged_chunk_rows = 0
            members = ([_device_of(d) for d in shard_devices]
                       if shard_devices is not None
                       else [self.torch_device] * self.shard_degree)
            if len(members) != self.shard_degree:
                raise ValueError(
                    "shard_degree=%d needs exactly that many devices, got "
                    "%d" % (self.shard_degree, len(members)))
            self.ring = build_shard_ring(members, self.shard_degree,
                                         self.shard_axis)
            if self.ring.device != self.torch_device:
                raise ValueError("the shard ring's members lie on %s, the "
                                 "stage on %s" % (self.ring.device,
                                                  self.torch_device))
            if self.end_index == NUM_LAYERS:
                self._merge = make_merge(self.ring)
        #: the network; tests hand in their own (bridged weights)
        sharded = ({"shards": self.shard_degree} if self.shard_degree > 1
                   else {})
        self.network = network if network is not None else shared_network(
            self.start_index, self.end_index, int(num_classes),
            tuple(layer_sizes), self.torch_device,
            factored_shortcut=self.factored_shortcut, **sharded,
            **_ckpt_kwargs(ckpt_path))
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
        self._warm_rows = ((self.pool_rows,) if self.ragged else
                           normalize_row_buckets(row_buckets, self.max_rows,
                                                 "max_rows"))
        self.shard_stats = None
        if self.shard_declared:
            self.shard_stats = self._shard_feasibility(warm_dtype)
        #: set by the executor's bind_shard_step(): the merge's hostprof
        #: section and trace span name the step
        self._sec_collective = None
        self._tr_collective = None
        #: entry signatures (rnb_tpu_torch.compilestats), the declared
        #: vocabulary observed even without warm-ups, as the reference's
        self.compiles = SignatureTracker()
        for rows in self._warm_rows:
            dummy = torch.zeros((rows,) + self._steady_shape[1:],
                                dtype=warm_dtype, device=self.torch_device)
            self.compiles.observe(dummy)
            for _ in range(num_warmups):
                out = self.eager_forward(dummy, rows)
                if self._merge is not None:
                    # the merge collective is warmed too
                    self._merge(out)
        #: signature key -> CapturedForward (the card only)
        self._graphs: Dict[tuple, CapturedForward] = {}
        #: graphs held, capture seconds, replays (the ``Graphs:`` line);
        #: None off the card
        self.graph_stats = None
        if self.torch_device.type == "cuda":
            self.graph_stats = {"graphs": 0, "capture_s": 0.0,
                                "replays": 0}
            self._graph_pool = torch.cuda.graph_pool_handle()
            # a capture stream of this stage's own
            self._capture_stream = torch.cuda.Stream(self.torch_device)
            with _DEVICE_SYNC_LOCK:
                torch.cuda.synchronize(self.torch_device)
                for key in self.graph_keys():
                    self._capture(key, warm_dtype)
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

    def _pool_bytes(self, dtype: torch.dtype) -> int:
        """Bytes of the one ragged pool-shaped input (0 when bucketed)."""
        if not self.ragged:
            return 0
        return (self.pool_rows * math.prod(self._steady_shape[1:])
                * torch.empty((), dtype=dtype).element_size())

    def _shard_feasibility(self, dtype: torch.dtype) -> dict:
        """The ``shard_stats`` of a declared degree: the per-member HBM
        projection of the network's bytes at rest and the ragged pool,
        the smallest feasible degree under the budget, and the merge
        counters. Raises the reference's rejection when the projection
        exceeds ``shard_hbm_budget_mb``."""
        rep_bytes, sh_bytes = split_param_bytes(self.network.state_dict())
        pool_bytes = self._pool_bytes(dtype)
        projected = projected_device_mb(rep_bytes, sh_bytes, pool_bytes,
                                        self.shard_degree)
        budget = self.shard_hbm_budget_mb
        feasible = (min_feasible_degree(rep_bytes, sh_bytes, pool_bytes,
                                        budget)
                    if budget is not None else 1)
        if budget is not None and projected > budget:
            raise ValueError(
                "shard launch rejected: projected per-device HBM %.1f MiB "
                "at shard degree %d exceeds hbm_budget_mb=%.1f for layers "
                "[%d..%d] (replicated %.1f MiB + sharded %.1f MiB / degree "
                "+ pool %.1f MiB); smallest feasible degree of (1, 2, 4, "
                "8): %s" % (projected, self.shard_degree, budget,
                            self.start_index, self.end_index,
                            rep_bytes / 2**20, sh_bytes / 2**20,
                            pool_bytes / 2**20,
                            feasible if feasible is not None else "none"))
        return {
            "degree": self.shard_degree,
            "axis": self.shard_axis,
            "gathers": 0,
            "collective_ms": 0.0,
            "rows": 0,
            "budget_mb": budget,
            "projected_mb": projected,
            "replicated_bytes": int(rep_bytes),
            "sharded_bytes": int(sh_bytes),
            "pool_bytes": int(pool_bytes),
            "min_degree": feasible if feasible is not None else 0,
        }

    def bind_shard_step(self, step_idx: int) -> None:
        """Executor protocol: the step index the merge collective's
        hostprof section and trace span carry (``exec{i}.collective``).
        Called on every run, traced or not, so the collective tax reaches
        hostprof and the ``Shard:`` line; a no-op without a merge."""
        if self._merge is None:
            return
        self._sec_collective = "exec%d.collective" % int(step_idx)
        self._tr_collective = trace.name("exec%d.collective",
                                         int(step_idx))

    def enable_pager(self, pager) -> None:
        """Executor protocol: attach as the feature-page consumer before
        the start barrier. The stage's fingerprint keys every entry, its
        ``features`` arena holds float32 logit rows (budget: the pager's
        size hint, or the default when this runs before the loader's),
        and a zero logit pool is what hits gather over. Refused, as in
        the reference, for a sharded stage, and unless the stage is
        ragged and ends the network."""
        self.pager = pager
        if pager.feature is None:
            return
        if self.shard_degree > 1:
            raise ValueError(
                "pager.feature_cache cannot attach to a shard-sharded "
                "stage (shard_degree=%d): the feature arena is a "
                "single-device gather pool, while sharded logits live "
                "on a %d-device mesh" % (self.shard_degree,
                                         self.shard_degree))
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
            self.num_classes, self.layer_sizes, self.factored_shortcut,
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
            _synchronize(self.torch_device)

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

    def _num_tiles(self, rows: int, rows_valid: int) -> Optional[int]:
        """The row tiles a ragged forward runs, ``ceil(rows_valid /
        chunk)`` (at least one: an emission carries a valid row); None
        where the network takes the whole input in one call."""
        chunk = self.ragged_chunk_rows
        if not self.ragged or chunk <= 0 or chunk >= rows:
            return None
        return max(1, min(math.ceil(rows_valid / chunk), rows // chunk))

    def graph_key(self, x, rows_valid: int) -> tuple:
        """The captured graph a forward of ``x`` replays: the input's
        signature and, tiled, the tile count."""
        return (signature_of(x), self._num_tiles(int(x.shape[0]),
                                                 rows_valid))

    def graph_keys(self) -> list:
        """The graphs ``__init__`` captures on the card: one per warmed
        row count, and per tile count where the forward is tiled."""
        dtype = getattr(torch, self.input_dtype_for(
            start_index=self.start_index, pixel_path=self.pixel_path))
        keys = []
        for rows in self._warm_rows:
            sig = signature_of(torch.empty((rows,) + self._steady_shape[1:],
                                           dtype=dtype, device="meta"))
            tiles = self._num_tiles(rows, rows)
            keys.extend([(sig, None)] if tiles is None else
                        [(sig, t) for t in range(1, tiles + 1)])
        return keys

    def _apply(self, x: torch.Tensor, rows_valid,
               num_tiles: Optional[int]) -> torch.Tensor:
        """Ingest and network: the whole input, or ``num_tiles`` row
        tiles with the output's other rows zero. ``rows_valid`` (an int,
        or the graph's int32 element) reaches the ragged ingest only."""
        xin = self._ingest(x, rows_valid)
        if num_tiles is None:
            return self.network(xin)
        chunk = self.ragged_chunk_rows
        out = torch.zeros((int(xin.shape[0]),) + self._out_row_shape,
                          dtype=torch.float32, device=xin.device)
        for i in range(num_tiles):
            out[i * chunk:(i + 1) * chunk] = self.network(
                xin[i * chunk:(i + 1) * chunk])
        return out

    @torch.inference_mode()
    def eager_forward(self, x: torch.Tensor, rows_valid: int
                      ) -> torch.Tensor:
        """The forward op by op, as on the CPU."""
        return self._apply(x, rows_valid,
                           self._num_tiles(int(x.shape[0]), rows_valid))

    @torch.inference_mode()
    def forward(self, x: torch.Tensor, rows_valid: int) -> torch.Tensor:
        """The stage's input ``(rows, ...)`` -> float32 outputs ``(rows,
        ...)``; ``rows_valid`` matters in ragged mode only. On the card,
        one replay of the captured graph of the input's signature."""
        if not x.is_cuda:
            return self.eager_forward(x, rows_valid)
        key = self.graph_key(x, rows_valid)
        graph = self._graphs.get(key)
        if graph is None:
            # a signature warm-up did not declare: compiles counts it
            graph = self._capture(key, x.dtype)
        out = graph.replay(x, rows_valid)
        self.graph_stats["replays"] += 1
        return out

    @torch.inference_mode()
    def _capture(self, key: tuple, dtype: torch.dtype) -> CapturedForward:
        """Capture the forward at one signature key
        (:func:`capture_forward`), under the device lock."""
        with _DEVICE_SYNC_LOCK:
            return self._capture_locked(key, dtype)

    def _capture_locked(self, key: tuple, dtype: torch.dtype
                        ) -> CapturedForward:
        (((shape, _dtype_name),), num_tiles) = key
        rows = int(shape[0])
        device = self.torch_device
        static_in = torch.zeros(shape, dtype=dtype, device=device)
        static_rows_valid = None
        rows_valid = rows if num_tiles is None else min(
            rows, num_tiles * self.ragged_chunk_rows)
        if self.ragged and self.pixel_path != "rgb":
            static_rows_valid = torch.full((1,), rows_valid,
                                           dtype=torch.int32, device=device)
        ingest_rows_valid = (rows_valid if static_rows_valid is None
                             else static_rows_valid)
        captured = capture_forward(
            lambda: self._apply(static_in, ingest_rows_valid, num_tiles),
            static_in, static_rows_valid, self._graph_pool,
            self._capture_stream)
        self._graphs[key] = captured
        self.graph_stats["graphs"] = len(self._graphs)
        self.graph_stats["capture_s"] += captured.capture_s
        return captured

    def compute_profile(self) -> dict:
        """The devobs compute/memory seam (rnb_tpu_torch.devobs): the
        declared per-row FLOPs of the analytic walk over this stage's
        network shape, the network's parameter and buffer bytes on the
        card (keyed by the module's identity, so stages sharing one
        network count it once) and, ragged, the one pool-shaped input's
        bytes. ``bytes_per_row`` is None: the reference takes it from
        XLA's cost model, and PyTorch has none."""
        flops_per_row = range_flops_per_clip(
            self.start_index, self.end_index,
            consecutive_frames=self.consecutive_frames,
            num_classes=self.num_classes, layer_sizes=self.layer_sizes,
            factored_shortcut=self.factored_shortcut)
        tensors = list(self.network.parameters()) + list(
            self.network.buffers())
        params_bytes = sum(t.numel() * t.element_size() for t in tensors)
        pool_bytes = self._pool_bytes(getattr(torch, self.input_dtype_for(
            start_index=self.start_index, pixel_path=self.pixel_path)))
        return {
            "flops_per_row": int(flops_per_row),
            "devices": 1,
            "bytes_per_row": None,
            "params_key": ("params", id(self.network)),
            "params_bytes": int(params_bytes),
            "pool_bytes": int(pool_bytes),
        }

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
            # allocated on the loader's transfer stream (a segment is a
            # view of the loader's output, shared with its siblings);
            # keep its memory from being reused until this stream's work
            # is done
            x.record_stream(torch.cuda.current_stream(x.device))
        self.compiles.observe(x)
        out = self.forward(x, int(pb.valid))
        if self._merge is not None:
            out = self._merged(out, time_card)
        if self.shard_stats is not None:
            self.shard_stats["rows"] += int(pb.valid)
        self._insert_features(out, time_card)
        if self.ragged:
            return (RaggedBatch(out, pb.valid, offsets),), \
                non_tensors, time_card
        return (PaddedBatch(out, pb.valid),), non_tensors, time_card

    def _merged(self, blocks, time_card) -> torch.Tensor:
        """The merge collective over a sharded head's column blocks,
        timed on the host alone: the forward is waited for first, and
        the merge before the clock stops."""
        stream = (torch.cuda.current_stream(self.torch_device)
                  if self.torch_device.type == "cuda" else None)
        if stream is not None:
            stream.synchronize()
        t0 = time.perf_counter()
        if self._sec_collective is not None:
            with hostprof.section(self._sec_collective), trace.span(
                    self._tr_collective, getattr(time_card, "id", None)):
                out = self._merge(blocks)
                if stream is not None:
                    stream.synchronize()
        else:
            out = self._merge(blocks)
            if stream is not None:
                stream.synchronize()
        stats = self.shard_stats
        stats["gathers"] += 1
        stats["collective_ms"] += (time.perf_counter() - t0) * 1e3
        return out


class R2P1DSingleStep(StageModel):
    """Decode and the full network in one stage: the no-pipelining
    baseline. Emits the predicted class id as the non-tensor payload and
    declares no tensor outputs. The network's keys (``num_classes``,
    ``layer_sizes``, ``ckpt_path``, ``factored_shortcut``) go to the
    embedded runner, the others to the embedded loader."""

    #: the static unconsumed-key check unions their constructor
    #: parameters with the stage's own
    FORWARDS_CONFIG_TO = (R2P1DLoader, R2P1DRunner)

    def __init__(self, device, num_classes: int = KINETICS_CLASSES,
                 layer_sizes=R18_LAYER_SIZES, max_clips: int = MAX_CLIPS,
                 consecutive_frames: int = CONSECUTIVE_FRAMES,
                 num_warmups: int = NUM_WARMUPS,
                 ckpt_path: Optional[str] = None,
                 factored_shortcut: bool = False, **kwargs):
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
            dct_coeffs_per_frame=kwargs.get("dct_coeffs_per_frame"),
            factored_shortcut=factored_shortcut, ckpt_path=ckpt_path)
        self.graph_stats = self.net.graph_stats

    @classmethod
    def output_shape_for(cls, **_kwargs):
        return None

    def discard_pending(self) -> None:
        self.loader.discard_pending()

    def compute_profile(self) -> dict:
        """devobs seam: the embedded network's profile is this fused
        step's (the loader's cache and staging are its own owners)."""
        return self.net.compute_profile()

    @torch.inference_mode()
    def __call__(self, tensors, non_tensors, time_card):
        (pb,), _, time_card = self.loader(None, non_tensors, time_card)
        (logits,), _, time_card = self.net((pb,), None, time_card)
        # sum and argmax on the card; only the class id crosses to the
        # host
        pred = int(torch.argmax(logits.data[: logits.valid].sum(dim=0)))
        return None, pred, time_card


#: what the processes of a launch's mesh stage agree on where its stream
#: starts and ends
STREAM_VALUES = ("dispatches", "request digest")


class R2P1DMeshRunner(StageModel):
    """Clip-sharded inference stage over a ``dp x sp`` mesh.

    The reference's successor to the segment topology: instead of
    fanning each video's clips out to replica stages and re-summing the
    logits on a host aggregator, one stage computes over a mesh of
    ``mesh_devices`` factored as ``dp`` x ``sp = len(mesh_devices) /
    dp`` (rnb_tpu_torch.parallel.sharded): every ``sp`` member sums the
    logits of its clip shard and the members' sums are added on the
    device. ``sp`` need not divide ``max_clips``: the step pads the clip
    axis with masked rows. It consumes the loader's ``raw_output``
    batches (uint8 frames, or packed 4:2:0 planes with ``pixel_path``
    "yuv420" on both stages) and emits predicted class ids (a final
    stage: no tensor outputs).

    With ``dp > 1`` it accumulates ``dp`` videos and dispatches them as
    one step; ``flush()`` pads a partial batch with zero videos at end of
    stream. With ``sync_preds=False`` the emitted predictions are device
    tensors: no per-video host sync blocks the executor thread, at most
    ``max_inflight`` dispatches are unretired, and ``finalize()`` drains
    them before the finish barrier, so the measured window covers all
    compute. Per-record ``inference{i}`` spans then measure dispatch,
    not device compute, as in the reference.

    Members share one device, so the mesh runs one forward a card over
    every row of a dispatch; a mesh over distinct devices of one process
    raises. On the card the step is compiled as the runner's forward is:
    one captured CUDA graph per signature (:class:`CapturedForward`), the
    pixel path's ingest kernel inside it, captured under the device lock
    after the eager warm-ups; the predictions are the argmax of a copy of
    the graph's output, so no later replay overwrites them. The whole
    network's weights come from ``ckpt_path`` where a file is named, else
    from the seeded init.

    In a launch of several processes (every process serving the whole
    config, as the reference does) ``mesh_devices`` name global members,
    one a process (``rnb_tpu_torch.devices``): the mesh spans the
    processes (``ShardedInference`` over it), the home device is one of
    its members, and the stage runs on this process's member. Each
    dispatch keeps this process's block of the batch
    (``ShardedInference.block``) and runs ``ShardedInference.run``'s
    captured step, the sp ring's gather inside it; the predictions of
    rows another process computes are :data:`ANOTHER_PROCESS`. Every
    member builds, warms and captures in the same order, so their hops
    pair. With ``sync_preds=False`` a dispatch waits for nothing: it
    reads the ring's sticky report first (``ShardedInference.poll``),
    and ``finalize`` waits once, after every process of the mesh has
    gathered the count and request digest of its dispatches and held
    them to its own (``ShardedInference.agree``; once at construction
    too, which makes the ring's memory before the measured window), so
    streams that diverged end every process's run with the ring's
    error.
    """

    def __init__(self, device, mesh_devices, dp: int = 1,
                 max_clips: int = MAX_CLIPS,
                 consecutive_frames: int = CONSECUTIVE_FRAMES,
                 num_classes: int = KINETICS_CLASSES,
                 layer_sizes=R18_LAYER_SIZES,
                 num_warmups: int = NUM_WARMUPS,
                 ckpt_path: Optional[str] = None,
                 max_inflight: int = 4, sync_preds: bool = True,
                 factored_shortcut: bool = False,
                 pixel_path: str = "rgb"):
        super().__init__(device)
        self.dp = int(dp)
        if len(mesh_devices) % self.dp != 0:
            raise ValueError("dp=%d must divide len(mesh_devices)=%d"
                             % (self.dp, len(mesh_devices)))
        mesh = build_mesh([_member_of(d) for d in mesh_devices],
                          axes={"dp": self.dp, "sp": -1})
        # in a launch the config placed the home on this process's member
        self.torch_device = _device_of(device)
        if mesh.device != self.torch_device:
            raise ValueError("the mesh's members lie on %s, the stage "
                             "on %s" % (mesh.device, self.torch_device))
        self.max_clips = int(max_clips)
        self.consecutive_frames = int(consecutive_frames)
        self.max_inflight = int(max_inflight)
        self.sync_preds = bool(sync_preds)
        self.pixel_path = pixel_path
        self._si = ShardedInference(
            mesh, network=shared_network(
                1, NUM_LAYERS, int(num_classes), tuple(layer_sizes),
                mesh.device, factored_shortcut=factored_shortcut,
                **_ckpt_kwargs(ckpt_path)),
            max_clips=self.max_clips,
            consecutive_frames=self.consecutive_frames, frame_hw=FRAME_HW,
            num_classes=num_classes, pixel_path=pixel_path)
        self._flops_args = dict(
            consecutive_frames=self.consecutive_frames,
            num_classes=int(num_classes), layer_sizes=tuple(layer_sizes),
            factored_shortcut=bool(factored_shortcut))
        self._acc = []            # (PaddedBatch, TimeCard) awaiting dp fill
        self._inflight = deque()  # unretired dispatches' events
        #: the most dispatches unretired at once, and the ones the last
        #: finalize waited for (the card only: CPU work is synchronous)
        self.inflight_peak = 0
        self.drained = 0
        #: across processes, the dispatches served and a CRC-32 over
        #: their request ids in order (a padded row's id -1): what
        #: ``finalize`` holds every process of the launch's mesh to
        self.dispatches = 0
        self.digest = 0
        #: entry signatures of the step (the dispatch batch and its mask)
        self.compiles = SignatureTracker()
        self.across = mesh.spans_processes
        full = [self.max_clips] * self.dp
        dummy, full = self._si.block(torch.zeros(
            self._si.batch_shape(self.dp), dtype=torch.uint8), full)
        self.compiles.observe(dummy, full)
        for _ in range(num_warmups):
            self.eager_forward(dummy, full)
        #: signature key -> CapturedForward (the card only)
        self._graphs: Dict[tuple, CapturedForward] = {}
        self.graph_stats = None
        if self.across:
            # the step across processes is ShardedInference.run's graph
            if mesh.device.type == "cuda":
                self.graph_stats = self._si.graph_stats
                self._si.capture(dummy, full)
            # every process of the mesh has built the stage, and the ring
            # the stream's end is agreed over holds its peers' memory
            # before the measured window
            self._si.agree([self.dispatches, self.digest], STREAM_VALUES)
        elif mesh.device.type == "cuda":
            self.graph_stats = {"graphs": 0, "capture_s": 0.0,
                                "replays": 0}
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(mesh.device)
            with _DEVICE_SYNC_LOCK:
                torch.cuda.synchronize(mesh.device)
                self._capture(dummy, full)
                torch.cuda.synchronize(mesh.device)

    def input_shape(self):
        # one source of truth for the per-video shape in either pixel
        # path: the sharded step's own batch geometry
        return (self._si.batch_shape(1)[1:],)

    def input_sharding(self) -> torch.device:
        """Edge-contract target (rnb_tpu_torch.handoff): payloads land
        on the mesh's device, the one every member shares."""
        return self._si.mesh.device

    @classmethod
    def input_shape_for(cls, max_clips: int = MAX_CLIPS,
                        consecutive_frames: int = CONSECUTIVE_FRAMES,
                        pixel_path: str = "rgb", **_kwargs):
        """One raw loader video batch per dispatch row."""
        return (_wire_batch_shape(max_clips, pixel_path, None,
                                  consecutive_frames),)

    @classmethod
    def input_dtype_for(cls, **_kwargs):
        """The loader's raw_output uint8 batches, in either pixel path
        (the sharded step owns the ingest)."""
        return "uint8"

    def compute_profile(self) -> dict:
        """The devobs compute/memory seam: full-range per-row FLOPs over
        the distinct devices the mesh spans (one on a one-card copy,
        where the reference counts every mesh member), the network's
        bytes counted once per network."""
        flops_per_row = range_flops_per_clip(1, NUM_LAYERS,
                                             **self._flops_args)
        network = self._si.network
        tensors = list(network.parameters()) + list(network.buffers())
        return {
            "flops_per_row": int(flops_per_row),
            "devices": len({str(d) for d in self._si.mesh.devices.flat}),
            "bytes_per_row": None,
            "params_key": ("params", id(network)),
            "params_bytes": int(sum(t.numel() * t.element_size()
                                    for t in tensors)),
            "pool_bytes": 0,
        }

    @torch.inference_mode()
    def eager_forward(self, vids: torch.Tensor, mask: torch.Tensor
                      ) -> torch.Tensor:
        """The step op by op, as on the CPU; across processes this
        process's block in, its videos' logits out, the run's end
        waited for (``ShardedInference.step_across``, ``finish``)."""
        if not self.across:
            return self._si.step(vids, mask)
        out = self._si.step_across(vids, mask)
        self._si.finish()
        return out

    @torch.inference_mode()
    def forward(self, vids: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
        """A dispatch's (dp, max_clips, ...) batch and its mask -> the
        per-video logits; on the card one replay of the captured graph
        of the batch's signature. Across processes this process's block
        (``ShardedInference.block``) in, its videos' logits out, through
        ``ShardedInference.run``: with ``sync_preds`` it waits for the
        card and checks the ring, else it waits for nothing."""
        if self.across:
            return self._si.run(vids, mask, finish=self.sync_preds)
        if not vids.is_cuda:
            return self.eager_forward(vids, mask)
        graph = self._graphs.get(signature_of(vids, mask))
        if graph is None:
            # a signature warm-up did not declare: compiles counts it
            graph = self._capture(vids, mask)
        out = graph.replay(vids, mask)
        self.graph_stats["replays"] += 1
        return out

    @torch.inference_mode()
    def _capture(self, vids: torch.Tensor, mask: torch.Tensor
                 ) -> CapturedForward:
        """Capture the step at the signature of ``vids`` and ``mask``
        (:func:`capture_forward`), under the device lock."""
        with _DEVICE_SYNC_LOCK:
            static_in = torch.zeros_like(vids)
            static_mask = torch.ones_like(mask)
            captured = capture_forward(
                lambda: self._si.step(static_in, static_mask), static_in,
                static_mask, self._graph_pool, self._capture_stream)
        self._graphs[signature_of(vids, mask)] = captured
        self.graph_stats["graphs"] = len(self._graphs)
        self.graph_stats["capture_s"] += captured.capture_s
        return captured

    def _dispatch(self, pbs, cards):
        """One step over len(pbs) == dp videos; device predictions out,
        the unretired dispatches bounded."""
        datas = [pb.data for pb in pbs]
        for data in datas:
            if data.is_cuda and data.device == self._si.device:
                # allocated on the loader's transfer stream: keep its
                # memory until this stream's work is done
                data.record_stream(torch.cuda.current_stream(data.device))
        if self.across:
            ids = [tc.id for tc in cards] + [-1] * (len(pbs) - len(cards))
            self.digest = zlib.crc32(np.asarray(ids, np.int64).tobytes(),
                                     self.digest)
            self.dispatches += 1
            if not self.sync_preds:
                # a hop of an earlier dispatch that failed fails this one
                self._si.poll()
        # batch first (this process's block of it), transfer once
        batch, mask = self._si.block(torch.stack(datas),
                                     [pb.valid for pb in pbs])
        self.compiles.observe(batch, mask)
        preds = self.forward(batch, mask).argmax(dim=-1)
        if self.across:
            first, last = self._si.rows(len(pbs))
            if (first, last) != (0, len(pbs)):
                mine = preds
                preds = torch.full((len(pbs),), ANOTHER_PROCESS,
                                   dtype=preds.dtype, device=preds.device)
                preds[first:last] = mine
        if preds.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(preds.device))
            if self.sync_preds:
                # honest latency spans: the executor stamps the finish
                # right after this returns
                done.synchronize()
            else:
                self._retire()
                self._inflight.append(done)
                while len(self._inflight) > self.max_inflight:
                    self._inflight.popleft().synchronize()
                self.inflight_peak = max(self.inflight_peak,
                                         len(self._inflight))
        out_card = (TimeCardList(list(cards)) if len(cards) > 1
                    else cards[0])
        return None, preds, out_card

    def __call__(self, tensors, non_tensors, time_card):
        pb = tensors[0]
        want = self.input_shape()[0]
        if tuple(pb.data.shape) != tuple(want):
            # fail fast with the likely cause: the loader and this stage
            # must agree on pixel_path
            raise ValueError(
                "mesh stage received batch shape %r but expects %r — "
                "do the loader's and this stage's pixel_path settings "
                "agree? (this stage: %r)"
                % (tuple(pb.data.shape), tuple(want), self.pixel_path))
        self._acc.append((pb, time_card))
        if len(self._acc) < self.dp:
            return None, None, None  # swallow until the dp axis fills
        pbs, cards = zip(*self._acc)
        self._acc = []
        return self._dispatch(list(pbs), list(cards))

    def flush(self):
        """End of stream: run the partial video batch, padding the dp
        axis with zero videos (mask 0: dead rows, no result rows)."""
        if not self._acc:
            return None
        pbs, cards = zip(*self._acc)
        self._acc = []
        pbs = list(pbs)
        while len(pbs) < self.dp:
            pbs.append(PaddedBatch(torch.zeros_like(pbs[0].data), 0))
        return self._dispatch(pbs, list(cards))

    def _retire(self) -> None:
        """Drop the dispatches the card has finished."""
        while self._inflight and self._inflight[0].query():
            self._inflight.popleft()

    def finalize(self) -> None:
        """Drain the unretired dispatches (the executor calls it before
        the finish barrier, keeping the measured window honest). Across
        processes every process of the mesh then holds the others'
        dispatch count and request digest to its own, with the run's one
        wait (``ShardedInference.agree``): a stream that diverged in one
        process fails every process's run."""
        self._retire()
        self.drained = len(self._inflight)
        while self._inflight:
            self._inflight.popleft().synchronize()
        if self.across:
            self._si.agree([self.dispatches, self.digest], STREAM_VALUES)


class R2P1DAggregator(StageModel):
    """The host step behind a segmented step: sums each request's
    float32 segment logits over their valid rows, in arrival order
    (numpy, as the reference does), swallows segments until
    ``aggregate`` of a request have arrived, then merges their TimeCards
    (:meth:`TimeCard.merge`) and emits the argmax class id as the
    non-tensor payload. An empty segment (no valid rows) adds zeros.
    Declares no tensor outputs."""

    def __init__(self, device, aggregate: int, **kwargs):
        super().__init__(device)
        self.aggregate = int(aggregate)
        if self.aggregate < 1:
            raise ValueError("aggregate must be >= 1")
        #: request id -> [summed logits, [TimeCard, ...]]
        self._pending: Dict[int, list] = {}

    @classmethod
    def output_shape_for(cls, **_kwargs):
        return None

    def __call__(self, tensors, non_tensors, time_card):
        pb = tensors[0]
        logits = pb.data[: pb.valid].to(torch.float32).cpu().numpy()
        contribution = logits.sum(axis=0)
        entry = self._pending.setdefault(
            time_card.id, [np.zeros_like(contribution), []])
        entry[0] = entry[0] + contribution
        entry[1].append(time_card)
        if len(entry[1]) < self.aggregate:
            return None, None, None
        del self._pending[time_card.id]
        merged = (TimeCard.merge(entry[1]) if self.aggregate > 1
                  else entry[1][0])
        return None, int(entry[0].argmax()), merged


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
