"""The sharded inference step: R(2+1)D over a dp x sp mesh.

Counterpart of ``rnb_tpu/parallel/sharded.py``. The reference jits one
``shard_map`` program over a ``dp x sp`` mesh: ``dp`` shards the video
axis, ``sp`` the clip axis, every member computes logits for its clip
shard, sums them per video under the clip mask, and a ``psum`` over
``sp`` reduces the members' sums on the device (the reference's
successor to the segment topology's host aggregator).

The port computes what that step computes, member by member: the clip
axis padded to a multiple of ``sp`` with zero-mask rows, the pixel
path's fused ingest (``normalize_u8`` for rgb, ``normalize_yuv420`` for
yuv420, each its hand-written kernel on the card), the network over
layers [1..5] and the head, each member's masked sum over its clip
shard, and the sum over the ``sp`` members in member order. Members
that share one card run one forward a card, over every row of the
dispatch (the padded ones too), and the logits are then split into the
member partials; a mesh over several cards of one process raises
(:class:`rnb_tpu_torch.parallel.mesh.Mesh`).

A mesh may span the processes of a launch (``distributed.global_mesh``),
as the reference's spans hosts; each process's members then form a
block of dp rows by sp columns (process-major member order makes
them). :meth:`ShardedInference.place` keeps this process's part of the
batch (its videos and its members' clip shards), as a multi-controller
program feeds its addressable shards; :meth:`ShardedInference.run` runs
one forward over those rows, sums each member's clip shard into a
``(videos, num_classes)`` float32 partial, gathers every member's
partial over the ring of the processes that share its dp rows (the ring
all-gather, through the kernel on the card), and sums them in member
order, the order the one-process step uses. It returns the logits of
this process's videos.

On the card :meth:`ShardedInference.run` replays one CUDA graph per input
signature (videos, mask), captured at the signature's first call, as the
reference runs one compiled ``jit(shard_map)``: the ingest, the forward,
the masked sums and, across processes, the gather over the sp ring
(issued with no host wait: ``ring_all_gather_issued``), all inside the
graph. Across processes the run then waits for the card once and checks
the ring's error word (:meth:`ShardedInference.finish`). On the CPU the
run is the eager step with the same end.

:class:`ShardedInference` builds its network as the reference does
(``variables``, else ``ckpt_path``, else the seeded init, through
``checkpoint.load_or_init``) or takes a stage's finished one;
:func:`make_sharded_inference` builds it over a factored mesh.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from rnb_tpu_torch.compilestats import signature_of
from rnb_tpu_torch.models.r2p1d import checkpoint as ckpt
from rnb_tpu_torch.models.r2p1d.network import (KINETICS_CLASSES,
                                                NUM_LAYERS, R18_LAYER_SIZES)
from rnb_tpu_torch.ops.handoff_dma import ring_all_gather_issued
from rnb_tpu_torch.ops.preprocess import normalize_u8
from rnb_tpu_torch.ops.yuv import normalize_yuv420, packed_frame_bytes
from rnb_tpu_torch.parallel import peers
from rnb_tpu_torch.parallel.mesh import (Member, Mesh, Ring, build_mesh,
                                         this_process, visible_devices)
from rnb_tpu_torch.parallel.shardplan import make_sharded_apply


class ShardedInference:
    """Full R(2+1)D inference over a ``dp x sp`` mesh.

    :meth:`run` (the stage's :meth:`step`) takes a uint8 batch of shape
    ``(videos, max_clips, frames, H, W, 3)`` (rgb) or ``(videos,
    max_clips, frames, packed)`` (yuv420) and a float32 mask ``(videos,
    max_clips)`` (1.0 = valid clip), both on the mesh's device
    (:meth:`place`), and returns per-video aggregated logits ``(videos,
    num_classes)`` in float32: summed over each video's valid clips, per
    member and then over the ``sp`` members.

    The mesh's ``dp`` size must divide the video axis. The clip axis
    needs no divisibility: when ``sp`` does not divide ``max_clips`` the
    step pads it to the next multiple with zero rows of mask 0 (the
    flagship's 15 clips over ``sp`` 4 become 16), which change no
    result.

    The [1..5] network is ``variables`` (a port state dict, what
    ``checkpoint.from_jax_variables`` returns), else the file at
    ``ckpt_path``, else the seeded init, in ``dtype`` (bf16 by default),
    on the mesh's device. A stage passes its finished ``network``
    instead (the one copy on its card); the ingest produces that
    network's compute dtype.
    """

    def __init__(self, mesh: Mesh, max_clips: int = 15,
                 consecutive_frames: int = 8, frame_hw: int = 112,
                 num_classes: int = KINETICS_CLASSES,
                 layer_sizes: Sequence[int] = R18_LAYER_SIZES,
                 dtype: Optional[torch.dtype] = None,
                 ckpt_path: Optional[str] = None,
                 variables: Optional[Dict[str, torch.Tensor]] = None,
                 factored_shortcut: bool = False,
                 pixel_path: str = "rgb",
                 network: Optional[torch.nn.Module] = None):
        if "dp" not in mesh.axis_names or "sp" not in mesh.axis_names:
            raise ValueError("mesh %r lacks axis 'dp'/'sp'"
                             % (mesh.axis_names,))
        if pixel_path not in ("rgb", "yuv420"):
            raise ValueError("pixel_path must be 'rgb' or 'yuv420', "
                             "got %r" % (pixel_path,))
        self.mesh = mesh
        self.device = mesh.device
        if network is None:
            if variables is None:
                variables = ckpt.load_or_init(
                    1, NUM_LAYERS, num_classes, layer_sizes, ckpt_path,
                    factored_shortcut=factored_shortcut)
            network = make_sharded_apply(
                1, NUM_LAYERS, num_classes, tuple(layer_sizes),
                Ring([self.device]), factored_shortcut,
                dtype or torch.bfloat16)(variables)
        elif variables is not None or ckpt_path is not None:
            raise ValueError("a finished network carries its weights: "
                             "pass it without variables or ckpt_path")
        self.network = network
        self.dtype = network.dtype
        self.max_clips = int(max_clips)
        self.consecutive_frames = int(consecutive_frames)
        self.frame_hw = int(frame_hw)
        self.num_classes = int(num_classes)
        self.pixel_path = pixel_path
        self.dp_size = mesh.shape["dp"]
        self.sp_size = mesh.shape["sp"]
        #: internal clip-axis extent: max_clips rounded up to a multiple
        #: of sp so every sp member gets an equal shard
        self.padded_clips = -(-self.max_clips // self.sp_size) * self.sp_size
        #: row n is the mask of a video of n valid clips, on the device:
        #: a dispatch's mask is stacked from its rows with no host copy
        self._mask_rows = torch.tril(torch.ones(
            (self.max_clips + 1, self.max_clips)), diagonal=-1).to(
                self.device)
        #: over a mesh that spans processes: this process's dp rows and sp
        #: columns, and the ring of the processes sharing its dp rows
        self.local_dp = self.local_sp = None
        self.sp_ring: Optional[Ring] = None
        if mesh.spans_processes:
            self._place_across()
        #: on the card: signature -> (CapturedForward, peers.Capture) of
        #: :meth:`run`, and its graphs, capture seconds and replays
        self._graphs: Dict[tuple, tuple] = {}
        self._graph_pool = self._capture_stream = None
        self.graph_stats = {"graphs": 0, "capture_s": 0.0, "replays": 0}

    def _place_across(self) -> None:
        """This process's block of the mesh (dp rows x sp columns) and
        the ring over the processes of its sp row."""
        mesh = self.mesh
        extra = [a for a in mesh.axis_names
                 if a not in ("dp", "sp") and mesh.shape[a] > 1]
        if extra:
            raise ValueError("a mesh across processes shards over dp and "
                             "sp only, got axes %r" % (mesh.shape,))
        order = [mesh.axis_names.index("dp"), mesh.axis_names.index("sp")]
        perm = order + [i for i in range(len(mesh.axis_names))
                        if i not in order]
        shape = (self.dp_size, self.sp_size)
        procs = np.transpose(mesh.processes, perm).reshape(shape)
        devices = np.transpose(mesh.devices, perm).reshape(shape)
        me = this_process()
        mine = procs == me
        rows = sorted(set(np.nonzero(mine)[0].tolist()))
        cols = sorted(set(np.nonzero(mine)[1].tolist()))
        if not rows or rows != list(range(rows[0], rows[-1] + 1)) \
                or cols != list(range(cols[0], cols[-1] + 1)) \
                or int(mine.sum()) != len(rows) * len(cols):
            raise ValueError(
                "a mesh across processes needs each process's members to "
                "form a block of dp rows by sp columns: process %d holds "
                "%s" % (me, [tuple(int(i) for i in idx)
                             for idx in np.argwhere(mine)]))
        row = procs[rows[0]].tolist()
        owners = list(dict.fromkeys(row))
        changes = sum(a != b for a, b in zip(row, row[1:]))
        if any(procs[d].tolist() != row for d in rows) \
                or changes != len(owners) - 1 \
                or len({row.count(p) for p in owners}) != 1:
            raise ValueError("a mesh across processes needs every process "
                             "of a block's sp rows to hold equally many "
                             "consecutive members, got %s" % (row,))
        self.local_dp, self.local_sp = rows, cols
        if len(owners) > 1:
            self.sp_ring = Ring([Member(p, devices[rows[0], row.index(p)])
                                 for p in owners], "sp")

    def batch_shape(self, num_videos: int) -> Tuple[int, ...]:
        if self.pixel_path == "yuv420":
            return (num_videos, self.max_clips, self.consecutive_frames,
                    packed_frame_bytes(self.frame_hw, self.frame_hw))
        return (num_videos, self.max_clips, self.consecutive_frames,
                self.frame_hw, self.frame_hw, 3)

    def place_mask(self, valid_clips: Sequence[int]) -> torch.Tensor:
        """The one clip-validity mask convention: float32 (videos,
        max_clips), 1.0 = valid row, on the mesh's device."""
        return torch.stack([self._mask_rows[min(int(n), self.max_clips)]
                            for n in valid_clips])

    def place(self, videos_u8: np.ndarray, valid_clips: Sequence[int]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A host batch on the mesh's device (one copy) and its mask.
        Over a mesh that spans processes, every process passes the whole
        batch and keeps its part: its dp rows' videos and its sp columns'
        clips of the padded clip axis (zero rows of mask 0 past
        ``max_clips``)."""
        if self.local_dp is None:
            vids = torch.from_numpy(np.ascontiguousarray(videos_u8,
                                                         np.uint8))
            return vids.to(self.device), self.place_mask(valid_clips)
        v = len(valid_clips)
        if v % self.dp_size:
            raise ValueError("the video axis (%d) must be a multiple of the "
                             "mesh's dp size %d" % (v, self.dp_size))
        per_row = v // self.dp_size
        first, last = self.local_dp[0] * per_row, \
            (self.local_dp[-1] + 1) * per_row
        shard = self.padded_clips // self.sp_size
        lo, hi = self.local_sp[0] * shard, (self.local_sp[-1] + 1) * shard
        videos = np.asarray(videos_u8, np.uint8)[first:last]
        part = np.zeros((last - first, hi - lo) + videos.shape[2:],
                        np.uint8)
        part[:, :max(0, min(hi, self.max_clips) - lo)] = \
            videos[:, lo:min(hi, self.max_clips)]
        mask = torch.zeros((last - first, self.padded_clips),
                           device=self.device)
        mask[:, :self.max_clips] = self.place_mask(valid_clips[first:last])
        return (torch.from_numpy(part).to(self.device),
                mask[:, lo:hi].contiguous())

    @torch.inference_mode()
    def run(self, vids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """-> per-video aggregated logits (videos, num_classes), float32
        (:meth:`step`); over a mesh that spans processes, this process's
        part in (:meth:`place`), its videos' logits out
        (:meth:`step_across`). On the card one replay of the step's CUDA
        graph at the inputs' signature (captured at its first call,
        :meth:`_capture`), with no host wait inside; on the CPU the eager
        step. Then :meth:`finish`: across processes the run's one host
        wait and the ring's check."""
        step = self.step if self.local_dp is None else self.step_across
        if self.device.type == "cuda":
            captured = self._graphs.get(signature_of(vids, mask))
            if captured is None:
                captured = self._capture(step, vids, mask)
            graph, capture = captured
            out = graph.replay(vids, mask)
            capture.replayed()
            self.graph_stats["replays"] += 1
        else:
            out = step(vids, mask)
        self.finish()
        return out

    def finish(self) -> None:
        """Where a step over a mesh that spans processes ends: one host
        wait for this process's stream (``peers.wait_for_card``), then the
        sp ring's error word checked (``peers.Endpoint.check_reported``),
        which raises naming the ring and the hop that failed. Nothing
        where the step issued no collective (one process, or a process
        holding its whole sp row)."""
        if self.sp_ring is None:
            return
        peers.wait_for_card(self.device)
        if self.device.type == "cuda":
            peers.endpoint(self.sp_ring).check_reported()

    def _capture(self, step, vids: torch.Tensor, mask: torch.Tensor
                 ) -> tuple:
        """Capture ``step`` at the signature of ``vids`` and ``mask`` as
        one CUDA graph (``model.capture_forward``: static inputs, a
        warm-up on the capture stream, the capture in thread-local mode),
        under the device lock. Across processes every member captures the
        same signature at the same call: the warm-up's hops pair as an
        eager step's, and the capture gets the arena tensors the warm-up
        took, which the graph holds for its life (``peers.Capture``). A
        capture that fails raises."""
        from rnb_tpu_torch.models.r2p1d.model import (_DEVICE_SYNC_LOCK,
                                                      capture_forward)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)
        capture = peers.Capture()
        static_in = torch.zeros_like(vids, device=self.device)
        static_mask = torch.ones_like(mask, device=self.device)

        def run():
            phase = capture.capture \
                if torch.cuda.is_current_stream_capturing() else capture.warm
            with phase():
                return step(static_in, static_mask)
        with _DEVICE_SYNC_LOCK:
            graph = capture_forward(run, static_in, static_mask,
                                    self._graph_pool, self._capture_stream)
        capture.held(torch.cuda.current_stream(self.device))
        self._graphs[signature_of(vids, mask)] = (graph, capture)
        self.graph_stats["graphs"] = len(self._graphs)
        self.graph_stats["capture_s"] += graph.capture_s
        return graph, capture

    def predict(self, videos_u8: np.ndarray,
                valid_clips: Sequence[int]) -> np.ndarray:
        """Host convenience: class ids for one padded uint8 batch."""
        logits = self.run(*self.place(videos_u8, valid_clips))
        return logits.argmax(dim=-1).cpu().numpy()

    def step(self, vids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The sharded step on tensors already on the mesh's device (what
        a stage captures): pad the clip axis, ingest, one forward over
        every row, each member's masked sum over its clip shard, the
        members' sums added in member order."""
        v = int(vids.shape[0])
        if v % self.dp_size:
            raise ValueError("the video axis (%d) must be a multiple of the "
                             "mesh's dp size %d" % (v, self.dp_size))
        pad = self.padded_clips - int(vids.shape[1])
        if pad:
            vids = torch.cat([vids, vids.new_zeros(
                (v, pad) + tuple(vids.shape[2:]))], dim=1)
            mask = torch.cat([mask, mask.new_zeros((v, pad))], dim=1)
        c = self.padded_clips
        flat = vids.reshape((v * c,) + tuple(vids.shape[2:]))
        if self.pixel_path == "yuv420":
            x = normalize_yuv420(flat, self.frame_hw, self.frame_hw,
                                 self.dtype)
        else:
            x = normalize_u8(flat, self.dtype)
        logits = self.network(x).reshape(v, c, self.num_classes)
        masked = logits * mask[..., None]
        # member s holds clips [s*c/sp, (s+1)*c/sp) of every video
        partials = masked.reshape(v, self.sp_size, c // self.sp_size,
                                  self.num_classes).sum(dim=2)
        total = partials[:, 0]
        for member in range(1, self.sp_size):
            total = total + partials[:, member]
        return total


    def step_partials(self, vids: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
        """One forward over a block's rows (videos, clips of whole
        members' shards): each member's masked sum over its clip shard,
        ``(videos, members, num_classes)`` float32."""
        v, clips = int(vids.shape[0]), int(vids.shape[1])
        flat = vids.reshape((v * clips,) + tuple(vids.shape[2:]))
        if self.pixel_path == "yuv420":
            x = normalize_yuv420(flat, self.frame_hw, self.frame_hw,
                                 self.dtype)
        else:
            x = normalize_u8(flat, self.dtype)
        logits = self.network(x).reshape(v, clips, self.num_classes)
        masked = logits * mask[..., None]
        shard = self.padded_clips // self.sp_size
        return masked.reshape(v, clips // shard, shard,
                              self.num_classes).sum(dim=2)

    def step_across(self, vids: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
        """The sharded step of this process's block: one forward over its
        rows (:meth:`step_partials`), every member's partial of these
        videos gathered over the sp ring (the ring all-gather across
        processes, issued with no host wait) and summed in member order.
        What a stage captures; its caller ends it with :meth:`finish`."""
        partials = self.step_partials(vids, mask)
        if self.sp_ring is not None:
            ((partials,),) = ring_all_gather_issued(
                [[partials.contiguous()]], 1, self.sp_ring)
        total = partials[:, 0]
        for member in range(1, self.sp_size):
            total = total + partials[:, member]
        return total


def make_sharded_inference(mesh: Optional[Mesh] = None,
                           num_devices: Optional[int] = None,
                           **kwargs) -> ShardedInference:
    """A :class:`ShardedInference` over ``mesh``, or over a dp x sp mesh
    factored over the first ``num_devices`` visible cards (all of them
    by default)."""
    if mesh is None:
        devices = visible_devices()
        if num_devices is not None:
            if num_devices > len(devices):
                raise ValueError(
                    "asked for %d devices but only %d are visible"
                    % (num_devices, len(devices)))
            devices = devices[:num_devices]
        mesh = build_mesh(devices, axis_names=("dp", "sp"))
    return ShardedInference(mesh, **kwargs)
