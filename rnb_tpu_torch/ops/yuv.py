"""On-device 4:2:0 ingest: packed YUV planes -> normalized bfloat16.

PyTorch counterpart of ``rnb_tpu/ops/yuv.py``. The host decode stops
at packed output-resolution 4:2:0 planes (1.5 bytes per pixel on the
wire); the card does the colourspace arithmetic:

    nearest 2x chroma upsample -> BT.601 -> clip/truncate to u8 -> normalize

On the TPU, XLA fused the converter into the stage's program, ahead of
the Pallas normalize. On the GPU one hand-written kernel does all of it
(``csrc/ingest.cu``): ``rnb_yuv420_normalize`` converts and normalizes
in one pass, so the RGB u8 bytes never reach device memory, and
``rnb_yuv420_to_rgb_u8``, the same kernel with a u8 epilogue, stops at
the RGB bytes. Both read ``rows_valid`` from device memory. CPU tensors
take the plain PyTorch versions.

Packed layout per frame (geometry must be even): ``Y`` (H*W bytes),
then ``U`` and ``V`` ((H/2)*(W/2) bytes each), flattened on the
trailing axis, so clip batches are ``(N, F, packed)``.

Numerics: the plain version follows the numpy oracle's float32 op
order exactly; the kernel writes the same ops with round-to-nearest
intrinsics. The JAX reference lets XLA contract into FMAs, so the
port agrees with it within one u8 step.
"""

from __future__ import annotations

import torch

from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.ops.preprocess import (RowsValid, check_kernel_input,
                                          normalize_u8_reference,
                                          rows_valid_int,
                                          rows_valid_pointer)

#: output dtypes of the normalizing entry
NORMALIZE_DTYPES = (torch.bfloat16, torch.float32)
#: the kernel's vector path takes 16 luma pixels per thread and line
RUN_PIXELS = 16


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


def _check_packed(x: torch.Tensor, height: int, width: int,
                  what: str) -> None:
    if x.dim() != 3 or x.shape[-1] != packed_frame_bytes(height, width):
        raise ValueError(
            "%s takes (rows, frames, %d) packed planes, got shape %s"
            % (what, packed_frame_bytes(height, width), tuple(x.shape)))


def _masked_rgb(x: torch.Tensor, height: int, width: int,
                rows_valid: RowsValid) -> torch.Tensor:
    """The plain conversion of the pool with rows at or past
    ``rows_valid`` zeroed first (the input is left as it was)."""
    valid = rows_valid_int(rows_valid, int(x.shape[0]), x.device)
    if valid < x.shape[0]:
        x = x.clone()
        x[valid:] = 0
    return yuv420_to_rgb_reference(x, height, width)


def _launch(kernel, x: torch.Tensor, out: torch.Tensor, height: int,
            width: int, rows_valid: RowsValid, *extra) -> torch.Tensor:
    rows, frames = int(x.shape[0]), int(x.shape[1])
    valid = rows_valid_pointer(rows_valid, rows, x.device)
    vector = int(width % RUN_PIXELS == 0 and x.data_ptr() % 16 == 0
                 and out.data_ptr() % 16 == 0)
    if out.numel():
        kernel.launch(x, out, valid, rows, frames, height, width, vector,
                      *extra)
    return out


def yuv420_to_rgb_u8(x: torch.Tensor, height: int, width: int,
                     rows_valid: RowsValid = None) -> torch.Tensor:
    """Packed 4:2:0 rows ``(rows, frames, packed)`` -> RGB u8
    ``(rows, frames, H, W, 3)``. Rows at or past ``rows_valid`` (all
    rows by default; an int or a 1-element int32 tensor on ``x``'s
    device) are converted as if their bytes were zero.

    A CUDA tensor launches ``rnb_yuv420_to_rgb_u8``; a CPU tensor runs
    the plain version on the masked rows."""
    _check_packed(x, height, width, "yuv420_to_rgb_u8")
    if x.device.type == "cpu":
        return _masked_rgb(x, height, width, rows_valid)
    check_kernel_input(x, "yuv420_to_rgb_u8")
    out = torch.empty((int(x.shape[0]), int(x.shape[1]), height, width, 3),
                      dtype=torch.uint8, device=x.device)
    return _launch(_kernels.YUV420_TO_RGB_U8, x, out, height, width,
                   rows_valid)


def yuv420_normalize(x: torch.Tensor, height: int, width: int,
                     rows_valid: RowsValid = None,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Packed 4:2:0 rows -> ``dtype`` NDHWC frames in [-1, 1], the
    normalize of :func:`yuv420_to_rgb_u8`'s result. Rows at or past
    ``rows_valid`` come out as the conversion of zero bytes: RGB (0,
    135, 0), normalized (-1, 0.0588, -1).

    The u8 quantization between conversion and normalization is kept,
    as in the reference: the network's input is then identical to what
    a host-side converter would have produced. A CUDA tensor launches
    ``rnb_yuv420_normalize`` (bf16 or float32 out), one pass that never
    writes the u8 bytes; a CPU tensor runs the plain versions."""
    _check_packed(x, height, width, "yuv420_normalize")
    if x.device.type == "cpu":
        return normalize_u8_reference(
            _masked_rgb(x, height, width, rows_valid), dtype)
    check_kernel_input(x, "yuv420_normalize")
    if dtype not in NORMALIZE_DTYPES:
        raise TypeError("the yuv420 normalize kernel writes %s, got %s"
                        % (NORMALIZE_DTYPES, dtype))
    out = torch.empty((int(x.shape[0]), int(x.shape[1]), height, width, 3),
                      dtype=dtype, device=x.device)
    return _launch(_kernels.YUV420_NORMALIZE, x, out, height, width,
                   rows_valid, int(dtype == torch.bfloat16))


def normalize_yuv420(x: torch.Tensor, height: int = 112, width: int = 112,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Packed u8 planes -> ``dtype`` NDHWC frames in [-1, 1], every row:
    one launch of the fused kernel on the card."""
    return yuv420_normalize(x, height, width, None, dtype)
