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
member partials; a mesh over several cards raises
(:class:`rnb_tpu_torch.parallel.mesh.Mesh`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from rnb_tpu_torch.models.r2p1d.network import KINETICS_CLASSES
from rnb_tpu_torch.ops.preprocess import normalize_u8
from rnb_tpu_torch.ops.yuv import normalize_yuv420, packed_frame_bytes
from rnb_tpu_torch.parallel.mesh import Mesh


class ShardedInference:
    """Full R(2+1)D inference over a ``dp x sp`` mesh.

    :meth:`step` takes a uint8 batch of shape ``(videos, max_clips,
    frames, H, W, 3)`` (rgb) or ``(videos, max_clips, frames, packed)``
    (yuv420) and a float32 mask ``(videos, max_clips)`` (1.0 = valid
    clip), both on the mesh's device, and returns per-video aggregated
    logits ``(videos, num_classes)`` in float32: summed over each video's
    valid clips, per member and then over the ``sp`` members.

    The mesh's ``dp`` size must divide the video axis. The clip axis
    needs no divisibility: when ``sp`` does not divide ``max_clips`` the
    step pads it to the next multiple with zero rows of mask 0 (the
    flagship's 15 clips over ``sp`` 4 become 16), which change no
    result.

    ``network`` is the [1..5] classifier the members share (the stage's
    copy on its card); the ingest produces its compute dtype.
    """

    def __init__(self, mesh: Mesh, network: torch.nn.Module,
                 max_clips: int = 15, consecutive_frames: int = 8,
                 frame_hw: int = 112, num_classes: int = KINETICS_CLASSES,
                 pixel_path: str = "rgb"):
        if "dp" not in mesh.axis_names or "sp" not in mesh.axis_names:
            raise ValueError("mesh %r lacks axis 'dp'/'sp'"
                             % (mesh.axis_names,))
        if pixel_path not in ("rgb", "yuv420"):
            raise ValueError("pixel_path must be 'rgb' or 'yuv420', "
                             "got %r" % (pixel_path,))
        self.mesh = mesh
        self.device = mesh.device
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
