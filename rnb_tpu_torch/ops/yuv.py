"""On-device 4:2:0 ingest: packed YUV planes -> normalized bfloat16.

PyTorch counterpart of ``rnb_tpu/ops/yuv.py``. The host decode stops
at packed output-resolution 4:2:0 planes (1.5 bytes per pixel on the
wire); the card does the colourspace arithmetic:

    nearest 2x chroma upsample -> BT.601 -> clip/truncate to u8 -> normalize

On the TPU, XLA fused the converter into the stage's program. On the
GPU nothing fuses it, so it is a hand-written kernel of its own
(``csrc/ingest.cu``, ``rnb_yuv420_to_rgb_u8``) followed by the
normalize kernel. CPU tensors take the plain PyTorch versions.

Packed layout per frame (geometry must be even): ``Y`` (H*W bytes),
then ``U`` and ``V`` ((H/2)*(W/2) bytes each), flattened on the
trailing axis, so clip batches are ``(N, F, packed)``.

Numerics: the plain version follows the numpy oracle's float32 op
order exactly; the kernel writes the same ops with round-to-nearest
intrinsics. The JAX reference lets XLA contract into FMAs, so the
port agrees with it within one u8 step.
"""

from __future__ import annotations

from typing import Optional

import torch

from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.ops.preprocess import check_kernel_input, normalize_u8


def packed_frame_bytes(height: int, width: int) -> int:
    """Bytes of one packed 4:2:0 frame; geometry must be even."""
    if height % 2 or width % 2:
        raise ValueError("packed 4:2:0 needs even geometry, got %dx%d"
                         % (height, width))
    return height * width * 3 // 2


def yuv420_to_rgb_reference(x: torch.Tensor, height: int,
                            width: int) -> torch.Tensor:
    """The plain version: packed u8 planes ``(..., packed)`` -> RGB u8
    ``(..., H, W, 3)`` in the numpy oracle's op order."""
    hw = height * width
    q = (height // 2) * (width // 2)
    lead = tuple(x.shape[:-1])
    y = x[..., :hw].reshape(lead + (height, width)).to(torch.float32)
    u = x[..., hw:hw + q].reshape(lead + (height // 2, width // 2))
    v = x[..., hw + q:].reshape(lead + (height // 2, width // 2))
    u = u.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    v = v.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    uf = u.to(torch.float32) - 128.0
    vf = v.to(torch.float32) - 128.0
    rgb = torch.stack([
        y + 1.402 * vf,
        y - 0.344136 * uf - 0.714136 * vf,
        y + 1.772 * uf,
    ], dim=-1)
    return rgb.clamp(0.0, 255.0).to(torch.uint8)


def yuv420_to_rgb_u8(x: torch.Tensor, height: int, width: int,
                     rows_valid: Optional[int] = None) -> torch.Tensor:
    """Packed 4:2:0 rows ``(rows, frames, packed)`` -> RGB u8
    ``(rows, frames, H, W, 3)``. Rows at or past ``rows_valid`` (all
    rows by default) are converted as if their bytes were zero.

    A CUDA tensor launches ``rnb_yuv420_to_rgb_u8``; a CPU tensor runs
    the plain version on the masked rows."""
    if x.dim() != 3 or x.shape[-1] != packed_frame_bytes(height, width):
        raise ValueError(
            "yuv420_to_rgb_u8 takes (rows, frames, %d) packed planes, got "
            "shape %s" % (packed_frame_bytes(height, width),
                          tuple(x.shape)))
    rows, frames = int(x.shape[0]), int(x.shape[1])
    rows_valid = rows if rows_valid is None else max(
        0, min(int(rows_valid), rows))
    if x.device.type == "cpu":
        if rows_valid < rows:
            x = x.clone()
            x[rows_valid:] = 0
        return yuv420_to_rgb_reference(x, height, width)
    check_kernel_input(x, "yuv420_to_rgb_u8")
    out = torch.empty((rows, frames, height, width, 3), dtype=torch.uint8,
                      device=x.device)
    if out.numel():
        _kernels.YUV420_TO_RGB_U8.launch(x, out, rows, frames, height,
                                         width, rows_valid)
    return out


def normalize_yuv420(x: torch.Tensor, height: int = 112, width: int = 112,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Packed u8 planes -> ``dtype`` NDHWC frames in [-1, 1].

    The u8 quantization between conversion and normalization is kept,
    as in the reference: the network's input is then identical to what
    a host-side converter would have produced."""
    return normalize_u8(yuv420_to_rgb_u8(x, height, width), dtype=dtype)
