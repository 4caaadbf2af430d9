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

:class:`ShardedInference` builds its network as the reference does
(``variables``, else ``ckpt_path``, else the seeded init, through
``checkpoint.load_or_init``) or takes a stage's finished one;
:func:`make_sharded_inference` builds it over a factored mesh.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from rnb_tpu_torch.models.r2p1d import checkpoint as ckpt
from rnb_tpu_torch.models.r2p1d.network import (KINETICS_CLASSES,
                                                NUM_LAYERS, R18_LAYER_SIZES)
from rnb_tpu_torch.ops.preprocess import normalize_u8
from rnb_tpu_torch.ops.yuv import normalize_yuv420, packed_frame_bytes
from rnb_tpu_torch.parallel.mesh import (Mesh, Ring, build_mesh,
                                         visible_devices)
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
        """A host batch on the mesh's device (one copy) and its mask."""
        vids = torch.from_numpy(np.ascontiguousarray(videos_u8, np.uint8))
        return vids.to(self.device), self.place_mask(valid_clips)

    @torch.inference_mode()
    def run(self, vids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """-> per-video aggregated logits (videos, num_classes), float32
        (:meth:`step`)."""
        return self.step(vids, mask)

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
