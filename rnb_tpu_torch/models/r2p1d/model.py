"""R(2+1)D pipeline stages: path iterator, fused yuv420 loader, runner.

Counterpart of ``rnb_tpu/models/r2p1d/model.py`` for the fused yuv420
serving path (``configs/rnb-fused-yuv-big.json`` and its ragged form):

* :class:`R2P1DFusingLoader` decodes y4m requests on host threads into
  packed 4:2:0 planes and fuses ready requests into one batch —
  padded to a row bucket, or shipped as the one ragged pool shape with
  ``rows_valid`` and a segment table — assembled in a pinned staging
  slot and sent to the card on a dedicated stream;
* :class:`R2P1DRunner` runs the yuv420 ingest kernels and R(2+1)D
  layers [start..end] on the batch; one network and one parameter copy
  per (range, device) serve every replica.

Not yet ported from the reference stages: the clip cache, the pager,
the autotune controller, fault containment, the rgb and dct pixel
paths, the native decode pool, sharding.
"""

from __future__ import annotations

import itertools
import math
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import torch

from rnb_tpu_torch.decode import get_decoder
from rnb_tpu_torch.models.r2p1d.checkpoint import init_variables
from rnb_tpu_torch.models.r2p1d.network import (KINETICS_CLASSES,
                                                NUM_LAYERS, R18_LAYER_SIZES,
                                                R2Plus1DClassifier,
                                                cast_compute_weights,
                                                range_output_shape)
from rnb_tpu_torch.models.r2p1d.sampler import R2P1DSampler
from rnb_tpu_torch.ops.ragged import (ragged_normalize_yuv420,
                                      resolve_pool_rows, segment_offsets_of)
from rnb_tpu_torch.ops.yuv import normalize_yuv420, packed_frame_bytes
from rnb_tpu_torch.stage import (PadCounter, PaddedBatch, RaggedBatch,
                                 StageModel, normalize_row_buckets)
from rnb_tpu_torch.staging import StagingPool, TransferWorker
from rnb_tpu_torch.telemetry import TimeCardList
from rnb_tpu_torch.video_path_provider import (VideoPathIterator,
                                               scan_video_tree)

MAX_CLIPS = 15
CONSECUTIVE_FRAMES = 8
FRAME_HW = 112
NUM_WARMUPS = 3  # reference warm-up convention
#: the seed every stage's weights are drawn from
WEIGHT_SEED = 0
PIXEL_PATHS = ("yuv420",)

_cache_lock = threading.Lock()
_network_cache: Dict[tuple, torch.nn.Module] = {}


def _check_pixel_path(pixel_path: str) -> None:
    if pixel_path not in PIXEL_PATHS:
        raise ValueError("pixel_path %r is not yet ported to rnb_tpu_torch "
                         "(ported: %s)" % (pixel_path, PIXEL_PATHS))


def _packed_batch_shape(rows: int) -> tuple:
    """A batch of packed 4:2:0 clip rows: ``(rows, frames, bytes)``."""
    return (int(rows), CONSECUTIVE_FRAMES,
            packed_frame_bytes(FRAME_HW, FRAME_HW))


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
    """Cycles a y4m dataset forever: ``root`` (or $RNB_TPU_DATA_ROOT)
    holds ``label/video.y4m`` files."""

    def __init__(self, root: Optional[str] = None):
        root = root or os.environ.get("RNB_TPU_DATA_ROOT")
        videos = scan_video_tree(root) if root and os.path.isdir(root) \
            else []
        if not videos:
            raise ValueError(
                "no .y4m videos under %r: point RNB_TPU_DATA_ROOT at a "
                "root/label/video.y4m tree" % (root,))
        self._videos = videos

    def __iter__(self):
        return itertools.cycle(self._videos)


class _FuseRecord:
    """One request of the fusing loader: its decode future, clip row
    count and TimeCard."""

    __slots__ = ("future", "n", "card", "t_ready")

    def __init__(self, future, n, card):
        self.future = future
        self.n = n
        self.card = card
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
    """

    SUPPORTS_RAGGED = True

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
                 ragged_pool_rows=None):
        super().__init__(device)
        _check_pixel_path(pixel_path)
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
                              "rows": 0, "pad_rows_eliminated": 0}
                             if self.ragged else None)
        slots = (self.DEFAULT_STAGING_SLOTS if staging_slots is None
                 else int(staging_slots))
        self.staging = StagingPool(self._batch_shape(self.max_clips),
                                   slots, self.torch_device)
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
        # warm-up: fault in the pinned slots and the transfer path at
        # every shape an emission ships
        for rows in self._warm_shapes():
            for _ in range(num_warmups):
                self.staging.transfer(self.staging.acquire(), rows)
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)

    @classmethod
    def output_shape_for(cls, max_clips: int = MAX_CLIPS, **_kwargs):
        return (_packed_batch_shape(max_clips),)

    def _batch_shape(self, rows: int):
        return _packed_batch_shape(rows)

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

    def __call__(self, tensors, non_tensors, time_card):
        video = str(non_tensors)
        decoder = get_decoder(video)
        starts = self._sample_starts(decoder, video)
        time_card.num_clips = len(starts)
        time_card.video = video
        future = self._decode_pool.submit(
            decoder.decode_clips_yuv, video, starts, CONSECUTIVE_FRAMES,
            FRAME_HW, FRAME_HW)
        self._inflight.append(_FuseRecord(future, len(starts), time_card))
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

    def _emit(self) -> bool:
        """Fuse ready requests (up to ``fuse`` / the max rows) into one
        batch and ship it. False when nothing was ready."""
        take, rows = [], 0
        while self._ready and len(take) < self.fuse:
            n = self._ready[0].n
            if take and rows + n > self.max_clips:
                break
            take.append(self._ready.popleft())
            rows += n
        if not take:
            return False
        assert rows <= self.max_clips, (rows, self.max_clips)
        shipped = self.pool_rows if self.ragged else self._bucket_for(rows)
        slot = self.staging.acquire()
        row = 0
        for rec in take:
            slot.array[row:row + rec.n] = rec.future.result()
            row += rec.n
        if not self.ragged:
            slot.array[rows:shipped] = 0
        cards = [rec.card for rec in take]
        pad = self.padding.note(rows, rows if self.ragged else shipped)
        if self.ragged:
            self.ragged_stats["emissions"] += 1
            self.ragged_stats["rows"] += rows
            self.ragged_stats["pad_rows_eliminated"] += \
                self._bucket_for(rows) - rows
        for idx, tc in enumerate(cards):
            tc.pad_rows = pad if idx == 0 else 0
        offsets = segment_offsets_of(rec.n for rec in take)

        def job():
            batch = self.staging.transfer(slot, shipped)
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
        """Teardown: drop unemitted work and stop the helper threads."""
        self._inflight.clear()
        self._ready.clear()
        if self._worker is not None:
            self._worker.close()
        self._decode_pool.shutdown(wait=True, cancel_futures=True)
        with self._out_lock:
            self._out_ready.clear()


class R2P1DRunner(StageModel):
    """Network stage over the layer range [start..end] with the fused
    yuv420 ingest in front of layer 1.

    Bucketed mode takes ``PaddedBatch`` es at the warmed row buckets.
    Ragged mode takes the one pool shape plus ``rows_valid``: the
    ingest kernels mask the pool tail, and with ``ragged_chunk_rows``
    the network runs ``ceil(rows_valid / chunk)`` row tiles — host-side
    slicing by the host integer ``rows_valid`` — so network work scales
    with the valid rows; pad rows of the output stay zero.
    """

    SUPPORTS_RAGGED = True

    def __init__(self, device, start_index: int = 1,
                 end_index: int = NUM_LAYERS,
                 num_classes: int = KINETICS_CLASSES,
                 layer_sizes=R18_LAYER_SIZES, max_rows: int = MAX_CLIPS,
                 num_warmups: int = NUM_WARMUPS, row_buckets=None,
                 pixel_path: str = "rgb", ragged: bool = False,
                 ragged_pool_rows=None, ragged_chunk_rows=None,
                 network: Optional[torch.nn.Module] = None):
        super().__init__(device)
        _check_pixel_path(pixel_path)
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
        self.max_rows = int(max_rows)
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
            dummy = torch.zeros(_packed_batch_shape(rows),
                                dtype=torch.uint8, device=self.torch_device)
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

    @torch.inference_mode()
    def forward(self, x: torch.Tensor, rows_valid: int) -> torch.Tensor:
        """Packed u8 planes ``(rows, F, packed)`` -> float32 outputs
        ``(rows, ...)``; ``rows_valid`` matters in ragged mode only."""
        if not self.ragged:
            return self.network(normalize_yuv420(x, FRAME_HW, FRAME_HW))
        xin = ragged_normalize_yuv420(x, rows_valid, FRAME_HW, FRAME_HW)
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
        x = pb.data
        if x.device != self.torch_device:
            x = x.to(self.torch_device)
        elif x.is_cuda:
            # allocated on the loader's transfer stream; keep its memory
            # from being reused until this stream's work is done
            x.record_stream(torch.cuda.current_stream(x.device))
        out = self.forward(x, int(pb.valid))
        if self.ragged:
            return (RaggedBatch(out, pb.valid, pb.segment_offsets),), \
                non_tensors, time_card
        return (PaddedBatch(out, pb.valid),), non_tensors, time_card
