"""Analytic FLOP counter for R(2+1)D layer ranges.

Counterpart of ``rnb_tpu/models/r2p1d/flops.py``: the same walk over
the convolution schedule of :mod:`.network` (stem (2+1)D conv, residual
stages with factored pairs, projection shortcuts, classification head),
counting a multiply-accumulate as 2 FLOPs, the MFU convention.
Elementwise work (BatchNorm, ReLU, residual adds, pooling) is excluded:
on a tensor-core device it is bandwidth, not FLOPs.

The counts feed the devobs plane's ``Compute:`` line (per-row FLOPs x
the rows a dispatch carried) and its MFU against
:func:`peak_tflops_for`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from rnb_tpu_torch.models.r2p1d.network import (KINETICS_CLASSES,
                                                LAYER_FEATURES,
                                                LAYER_INPUT_SHAPES,
                                                NUM_LAYERS,
                                                R18_LAYER_SIZES,
                                                factored_channels)

#: Dense bf16 tensor-core peak TFLOP/s per CUDA device, keyed by
#: ``torch.cuda.get_device_name()``, for the MFU denominator. NVIDIA H100
#: Tensor Core GPU data sheet, SXM5 column: 1,979 TFLOP/s bf16 "with
#: sparsity", so 989.4 dense. The rate assumes the card's full 700 W
#: power limit.
GPU_PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4,
}


def peak_tflops_for(device_name: str) -> Optional[float]:
    """Peak lookup for a ``torch.cuda.get_device_name()`` string; None
    when the card is unknown (the MFU is then unreported rather than
    wrong). Exact match only: a prefix rule would hand an H100 PCIe or
    NVL part the SXM5 peak; unknown names belong in the table, not
    guessed."""
    return GPU_PEAK_TFLOPS.get(device_name.strip())


def _conv_out(extent: int, kernel: int, stride: int, pad: int) -> int:
    return (extent + 2 * pad - kernel) // stride + 1


def _st_conv_flops(t_in: int, h: int, w: int, c_in: int, c_out: int,
                   kernel: Tuple[int, int], stride: Tuple[int, int]
                   ) -> Tuple[int, Tuple[int, int, int]]:
    """FLOPs + output dims of one factored SpatioTemporalConv (a spatial
    (1,d,d) conv to the parameter-matched mid width, then a temporal
    (t,1,1) conv)."""
    kt, kd = kernel
    st, sd = stride
    mid = factored_channels(c_in, c_out, kt, kd)
    h_out = _conv_out(h, kd, sd, kd // 2)
    w_out = _conv_out(w, kd, sd, kd // 2)
    spatial = 2 * t_in * h_out * w_out * mid * (kd * kd * c_in)
    t_out = _conv_out(t_in, kt, st, kt // 2)
    temporal = 2 * t_out * h_out * w_out * c_out * (kt * mid)
    return spatial + temporal, (t_out, h_out, w_out)


def range_flops_per_clip(start: int = 1, end: int = NUM_LAYERS,
                         consecutive_frames: int = 8,
                         num_classes: int = KINETICS_CLASSES,
                         layer_sizes: Sequence[int] = R18_LAYER_SIZES,
                         frame_hw: Optional[int] = None,
                         factored_shortcut: bool = False) -> int:
    """Conv+dense FLOPs for ONE clip row through layers [start..end].

    ``frame_hw``/``consecutive_frames`` describe the layer-1 input
    geometry; for ``start > 1`` the walk derives the range's input dims
    from the downsampling schedule (network.range_output_shape's rule).
    """
    if not (1 <= start <= end <= NUM_LAYERS):
        raise ValueError("invalid layer range [%s..%s]" % (start, end))
    t = int(consecutive_frames)
    h = w = int(frame_hw) if frame_hw is not None else \
        LAYER_INPUT_SHAPES[1][1]
    c = 3
    for layer in range(1, start):  # walk dims up to the range's input
        if layer == 1:
            h, w, c = -(-h // 2), -(-w // 2), 64
        else:
            c = LAYER_FEATURES[layer]
            if layer >= 3:
                t, h, w = -(-t // 2), -(-h // 2), -(-w // 2)
    total = 0
    for layer in range(start, end + 1):
        if layer == 1:
            flops, (t, h, w) = _st_conv_flops(t, h, w, c, 64,
                                              kernel=(3, 7), stride=(1, 2))
            total += flops
            c = 64
            continue
        c_out = LAYER_FEATURES[layer]
        downsample = layer >= 3
        for block in range(layer_sizes[layer - 2]):
            block_down = downsample and block == 0
            stride = 2 if block_down else 1
            if block_down:
                if factored_shortcut:
                    flops, _ = _st_conv_flops(t, h, w, c, c_out,
                                              kernel=(1, 1), stride=(2, 2))
                    total += flops
                else:
                    t_s = _conv_out(t, 1, 2, 0)
                    h_s = _conv_out(h, 1, 2, 0)
                    w_s = _conv_out(w, 1, 2, 0)
                    total += 2 * t_s * h_s * w_s * c_out * c
            flops, (t2, h2, w2) = _st_conv_flops(
                t, h, w, c, c_out, kernel=(3, 3), stride=(stride, stride))
            total += flops
            flops, _ = _st_conv_flops(t2, h2, w2, c_out, c_out,
                                      kernel=(3, 3), stride=(1, 1))
            total += flops
            t, h, w, c = t2, h2, w2, c_out
    if end == NUM_LAYERS:
        total += 2 * c * num_classes  # classification head
    return int(total)
