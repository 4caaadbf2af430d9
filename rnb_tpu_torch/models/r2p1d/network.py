"""R(2+1)D action-recognition network in PyTorch.

Counterpart of ``rnb_tpu/models/r2p1d/network.py``: the factored
spatiotemporal convolution of Tran et al., CVPR'18 — each 3-D conv is
a 2-D spatial conv + BN + ReLU + 1-D temporal conv, with the middle
width chosen so the pair has the parameter budget of the full 3-D
kernel. Any contiguous layer range [start..end] of the 5-layer
R(2+1)D-18 can be built, with global average pooling when layer 5 is
included and the linear head only when the range reaches it.

Design, mirroring the JAX package so the two agree number for number:

* **NDHWC at the module boundary.** Inputs and partial-range outputs
  are ``(rows, T, H, W, C)``, the JAX layout. Inside, activations are
  NCDHW views in ``channels_last_3d`` memory — the same bytes — which
  is the layout cuDNN's NDHWC convolutions take.
* **The reference's rounding points.** Conv inputs and kernels are
  cast to the compute dtype (bf16 on the serving path) and the conv
  returns it. BatchNorm is computed in float32 from its input as
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` and rounded to the
  compute dtype, as flax does; eps is flax's 1e-5. The mean pool sums
  in float32 and rounds back; the head's matmul and bias add round
  separately; logits are returned as float32.
* **Padding as the reference states it**: explicit ``d//2`` spatial
  and ``t//2`` temporal padding; the 1x1x1 stride-2 shortcut has none
  (flax ``SAME`` pads 0 there).
* **Intra-stage sharding** (``shards > 1``; rnb_tpu_torch.parallel.
  shardplan): every temporal conv kernel and the head's weight and bias
  hold ``shards`` member shards of their rows at rest (``weight_shards``,
  ``bias_shards``), ring-all-gathered to full width right before their
  op — the counterpart of the reference's ``nn.map_variables`` with
  ``_gather_shard_params``. The gathered tensor has the unsharded one's
  dtype, shape and memory format and lives only for its op, which then
  runs at full width. A sharded head returns its float32 logits as
  ``shards`` column blocks, one a member, for the stage's merge.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rnb_tpu_torch.ops.handoff_dma import ring_all_gather_body

NUM_LAYERS = 5
KINETICS_CLASSES = 400
R18_LAYER_SIZES = (2, 2, 2, 2)  # residual blocks in layers 2..5
BN_EPS = 1e-5

#: Per-layer-range input shapes (T, H, W, C) per row, NDHWC.
LAYER_INPUT_SHAPES = {
    1: (8, 112, 112, 3),
    2: (8, 56, 56, 64),
    3: (8, 56, 56, 64),
    4: (4, 28, 28, 128),
    5: (2, 14, 14, 256),
}

LAYER_FEATURES = {2: 64, 3: 128, 4: 256, 5: 512}


def range_output_shape(start: int, end: int,
                       consecutive_frames: int = 8,
                       num_classes: int = KINETICS_CLASSES
                       ) -> Tuple[int, ...]:
    """Per-row output shape of the layer range [start..end]: the stem
    halves H/W, layers 3-5 halve T/H/W (odd extents round up); a range
    reaching layer 5 pools and classifies to ``(num_classes,)``."""
    if not (1 <= start <= end <= NUM_LAYERS):
        raise ValueError("invalid layer range [%s..%s]" % (start, end))
    t, h, w, c = LAYER_INPUT_SHAPES[start]
    if start == 1:
        t = int(consecutive_frames)
    for layer in range(start, end + 1):
        if layer == 1:
            h, w, c = -(-h // 2), -(-w // 2), 64
        else:
            c = LAYER_FEATURES[layer]
            if layer >= 3:
                t, h, w = -(-t // 2), -(-h // 2), -(-w // 2)
    if end == NUM_LAYERS:
        return (int(num_classes),)
    return (t, h, w, c)


def factored_channels(in_features: int, out_features: int,
                      t: int, d: int) -> int:
    """Middle width M_i of the (2+1)D factorization (Tran et al.)."""
    num = t * d * d * in_features * out_features
    den = d * d * in_features + t * out_features
    return max(1, num // den)


def gather_shards(shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """A sharded leaf's full-width tensor: the ring all-gather of its
    member shards along dim 0. Every member's result is bitwise the
    same, and the members share one device, so the stage's one forward
    takes member 0's."""
    shards = list(shards)
    return ring_all_gather_body(len(shards), axis=0)(shards)[0]


def _member_shards(shape: Tuple[int, ...], shards: int) -> nn.ParameterList:
    """``shards`` empty member shards of a leaf of ``shape``, each
    ``1/shards`` of its rows."""
    if shape[0] % shards:
        raise ValueError("shards=%d does not divide the %d output channels"
                         % (shards, shape[0]))
    return nn.ParameterList(
        nn.Parameter(torch.empty((shape[0] // shards,) + tuple(shape[1:])))
        for _ in range(shards))


class Conv3d(nn.Module):
    """Unbiased 3-D convolution that computes in its input's dtype
    policy: input and kernel cast to ``dtype``, output in ``dtype``.
    ``weight`` is ``(out, in, T, H, W)``; with ``shards > 1`` the kernel
    is held as ``weight_shards`` and gathered before the conv."""

    def __init__(self, in_features: int, out_features: int,
                 kernel: Tuple[int, int, int], stride: Tuple[int, int, int],
                 padding: Tuple[int, int, int], dtype: torch.dtype,
                 shards: int = 1):
        super().__init__()
        shape = (out_features, in_features) + tuple(kernel)
        self.shards = int(shards)
        if self.shards > 1:
            self.weight_shards = _member_shards(shape, self.shards)
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.dtype = dtype

    def stored_weights(self) -> List[nn.Parameter]:
        """The kernel as held at rest: the weight, or its member
        shards."""
        return (list(self.weight_shards) if self.shards > 1
                else [self.weight])

    def forward(self, x):
        w = (gather_shards(self.weight_shards) if self.shards > 1
             else self.weight)
        if w.dtype != self.dtype:
            w = w.to(self.dtype)
        return F.conv3d(x.to(self.dtype), w, None, self.stride,
                        self.padding)


class BatchNorm(nn.Module):
    """Inference BatchNorm with flax's arithmetic: float32 statistics
    and affine terms, result rounded to ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.dtype = dtype

    def forward(self, x):
        shape = (1, -1, 1, 1, 1)
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        y = (x.to(torch.float32) - self.running_mean.view(shape)) \
            * mul.view(shape)
        return (y + self.bias.view(shape)).to(self.dtype)


class SpatioTemporalConv(nn.Module):
    """(2+1)D factored convolution: spatial conv, BN, ReLU, temporal
    conv. ``kernel`` is (temporal, spatial) extent, ``stride`` likewise."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int], stride: Tuple[int, int] = (1, 1),
                 dtype: torch.dtype = torch.bfloat16, shards: int = 1):
        super().__init__()
        t, d = kernel
        st, sd = stride
        mid = factored_channels(in_features, features, t, d)
        self.spatial = Conv3d(in_features, mid, (1, d, d), (1, sd, sd),
                              (0, d // 2, d // 2), dtype)
        self.bn = BatchNorm(mid, dtype)
        # the temporal kernel alone is sharded: the ``mid`` widths are
        # not divisible by 2 or 4
        self.temporal = Conv3d(mid, features, (t, 1, 1), (st, 1, 1),
                               (t // 2, 0, 0), dtype, shards)

    def forward(self, x):
        return self.temporal(F.relu(self.bn(self.spatial(x))))


class SpatioTemporalResBlock(nn.Module):
    """Residual block of two (2+1)D convs; a downsampling block adds a
    strided projection shortcut — a plain 1x1x1 conv, or with
    ``factored_shortcut`` the reference's factored (2+1)D pair."""

    def __init__(self, in_features: int, features: int,
                 downsample: bool = False, factored_shortcut: bool = False,
                 dtype: torch.dtype = torch.bfloat16, shards: int = 1):
        super().__init__()
        stride = 2 if downsample else 1
        self.downsample = downsample
        self.conv1 = SpatioTemporalConv(in_features, features, (3, 3),
                                        (stride, stride), dtype, shards)
        self.bn1 = BatchNorm(features, dtype)
        self.conv2 = SpatioTemporalConv(features, features, (3, 3),
                                        dtype=dtype, shards=shards)
        self.bn2 = BatchNorm(features, dtype)
        if downsample:
            if factored_shortcut:
                self.shortcut = SpatioTemporalConv(
                    in_features, features, (1, 1), (2, 2), dtype, shards)
            else:
                self.shortcut = Conv3d(in_features, features, (1, 1, 1),
                                       (2, 2, 2), (0, 0, 0), dtype)
            self.shortcut_bn = BatchNorm(features, dtype)

    def forward(self, x):
        res = F.relu(self.bn1(self.conv1(x)))
        res = self.bn2(self.conv2(res))
        if self.downsample:
            x = self.shortcut_bn(self.shortcut(x))
        return F.relu(x + res)


class SpatioTemporalResLayer(nn.Module):
    """A stack of residual blocks ``block0..``; the first may
    downsample."""

    def __init__(self, in_features: int, features: int, num_blocks: int,
                 downsample: bool = False, factored_shortcut: bool = False,
                 dtype: torch.dtype = torch.bfloat16, shards: int = 1):
        super().__init__()
        self.num_blocks = int(num_blocks)
        self.block0 = SpatioTemporalResBlock(
            in_features, features, downsample, factored_shortcut, dtype,
            shards)
        for i in range(1, self.num_blocks):
            self.add_module("block%d" % i, SpatioTemporalResBlock(
                features, features, dtype=dtype, shards=shards))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, "block%d" % i)(x)
        return x


class R2Plus1DNet(nn.Module):
    """Any contiguous layer range [start..end] of R(2+1)D-18, NDHWC in
    and (for partial ranges) out; a range reaching layer 5 returns the
    pooled ``(rows, 512)`` features."""

    def __init__(self, start: int = 1, end: int = NUM_LAYERS,
                 layer_sizes: Sequence[int] = R18_LAYER_SIZES,
                 factored_shortcut: bool = False,
                 dtype: torch.dtype = torch.bfloat16, shards: int = 1):
        super().__init__()
        if not (1 <= start <= end <= NUM_LAYERS):
            raise ValueError("invalid layer range [%s..%s]" % (start, end))
        self.start, self.end = int(start), int(end)
        channels = LAYER_INPUT_SHAPES[start][-1]
        for layer in range(start, end + 1):
            if layer == 1:
                self.conv1 = SpatioTemporalConv(channels, 64, (3, 7),
                                                (1, 2), dtype, shards)
                self.stem_bn = BatchNorm(64, dtype)
                channels = 64
            else:
                features = LAYER_FEATURES[layer]
                self.add_module("conv%d" % layer, SpatioTemporalResLayer(
                    channels, features, layer_sizes[layer - 2],
                    downsample=layer >= 3,
                    factored_shortcut=factored_shortcut, dtype=dtype,
                    shards=shards))
                channels = features

    def forward(self, x):
        # NDHWC -> an NCDHW view of the same bytes (channels_last_3d)
        x = x.permute(0, 4, 1, 2, 3)
        for layer in range(self.start, self.end + 1):
            if layer == 1:
                x = F.relu(self.stem_bn(self.conv1(x)))
            else:
                x = getattr(self, "conv%d" % layer)(x)
        if self.end == NUM_LAYERS:
            # global spatiotemporal pool: float32 sum, input dtype out
            return x.to(torch.float32).mean(dim=(2, 3, 4)).to(x.dtype)
        return x.permute(0, 2, 3, 4, 1)


class ShardedLinear(nn.Module):
    """The head's weight ``(classes, in)`` and bias ``(classes,)`` held
    as ``shards`` member shards of their rows (``weight_shards``,
    ``bias_shards``)."""

    def __init__(self, in_features: int, out_features: int, shards: int):
        super().__init__()
        self.shards = int(shards)
        self.weight_shards = _member_shards((out_features, in_features),
                                            self.shards)
        self.bias_shards = _member_shards((out_features,), self.shards)

    def gathered(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The full-width weight and bias."""
        return (gather_shards(self.weight_shards),
                gather_shards(self.bias_shards))


class R2Plus1DClassifier(nn.Module):
    """Partial net + linear head when the range reaches the last layer;
    float32 output whatever the compute dtype. With ``shards > 1`` a
    head returns the logits as ``shards`` column blocks."""

    def __init__(self, start: int = 1, end: int = NUM_LAYERS,
                 num_classes: int = KINETICS_CLASSES,
                 layer_sizes: Sequence[int] = R18_LAYER_SIZES,
                 factored_shortcut: bool = False,
                 dtype: torch.dtype = torch.bfloat16, shards: int = 1):
        super().__init__()
        self.dtype = dtype
        self.shards = int(shards)
        self.net = R2Plus1DNet(start, end, layer_sizes, factored_shortcut,
                               dtype, self.shards)
        self.has_head = end == NUM_LAYERS
        if self.has_head:
            if int(num_classes) % self.shards:
                raise ValueError("shards=%d does not divide the %d-class "
                                 "head" % (self.shards, num_classes))
            self.linear = (ShardedLinear(LAYER_FEATURES[NUM_LAYERS],
                                         int(num_classes), self.shards)
                           if self.shards > 1 else
                           nn.Linear(LAYER_FEATURES[NUM_LAYERS],
                                     int(num_classes)))

    def forward(self, x):
        x = self.net(x)
        if not self.has_head:
            return x.to(torch.float32)
        if self.shards > 1:
            w, b = self.linear.gathered()
        else:
            w, b = self.linear.weight, self.linear.bias
        y = torch.matmul(x.to(self.dtype), w.to(self.dtype).t())
        x = (y + b.to(self.dtype)).to(torch.float32)
        if self.shards == 1:
            return x
        # each member keeps its own column block: pure movement, so the
        # merge gather reassembles the logits bit for bit
        local = x.shape[-1] // self.shards
        return [x[:, i * local:(i + 1) * local].contiguous()
                for i in range(self.shards)]


def cast_compute_weights(model: nn.Module) -> nn.Module:
    """Store every conv and head weight in the compute dtype, conv
    kernels in ``channels_last_3d``. The values are exactly what each
    forward would cast to, so outputs do not change; the per-forward
    casts of 33M parameters go away. BatchNorm stays float32."""
    dtype = getattr(model, "dtype", None)
    for module in model.modules():
        if isinstance(module, Conv3d):
            for weight in module.stored_weights():
                weight.data = weight.data.to(module.dtype).contiguous(
                    memory_format=torch.channels_last_3d)
        elif isinstance(module, (nn.Linear, ShardedLinear)) \
                and dtype is not None:
            for param in module.parameters():
                param.data = param.data.to(dtype)
    return model
