"""Ingest normalize: uint8 frames -> normalized bfloat16.

PyTorch counterpart of ``rnb_tpu/ops/preprocess.py``. The op every
video batch crosses on its way into the network:

    y = (2x - 255) * (1/255)        # [0,255] -> [-1,1], rounded once

``normalize_u8_reference`` is the plain PyTorch version and the
numerics contract. ``normalize_u8`` dispatches on where the tensor
lies: a CUDA tensor goes to the hand-written kernel
(``csrc/ingest.cu``, ``rnb_normalize_u8``), a CPU tensor to the plain
version. There is no fallback from one to the other.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rnb_tpu_torch.ops import _kernels

#: float32(1/255), the one rounding constant the kernel also uses
INV_255 = float(np.float32(1.0 / 255.0))

#: the kernel moves 16 bytes per thread: a row's byte count must be a
#: multiple of this (the 8x112x112x3 clip row is 301,056 = 16 x 18,816)
VECTOR_BYTES = 16


def normalize_u8_reference(x: torch.Tensor,
                           dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """The plain formulation: ``(2x - 255) * (1/255)`` in float32,
    rounded to ``dtype`` once. The inner term is exact integer
    arithmetic in float32 (|2x-255| <= 255), leaving one rounding
    multiply that no compiler can contract into an FMA, so it is
    bit-identical to the JAX reference and to the kernel."""
    xf = x.to(torch.float32)
    return ((xf * 2.0 - 255.0) * INV_255).to(dtype)


def check_kernel_input(x: torch.Tensor, what: str) -> None:
    """Raise unless ``x`` is a contiguous uint8 CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError("%s runs its kernel on cuda tensors, got %s"
                         % (what, x.device))
    if x.dtype != torch.uint8:
        raise TypeError("%s takes uint8, got %s" % (what, x.dtype))
    if not x.is_contiguous():
        raise ValueError("%s needs a contiguous tensor" % what)


def normalize_u8_rows(x: torch.Tensor, rows_valid: int,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Normalize rows ``< rows_valid`` of a ``(rows, ...)`` uint8
    tensor; rows at or past ``rows_valid`` come out exactly zero.

    On a CUDA tensor this launches ``rnb_normalize_u8``, whose pad rows
    store zeros and do no arithmetic. On a CPU tensor it runs the plain
    version and zeroes the pad rows."""
    if x.dim() < 1:
        raise ValueError("normalize_u8 needs a (rows, ...) tensor")
    rows = int(x.shape[0])
    rows_valid = max(0, min(int(rows_valid), rows))
    if x.device.type == "cpu":
        out = normalize_u8_reference(x, dtype)
        out[rows_valid:] = 0
        return out
    check_kernel_input(x, "normalize_u8")
    if dtype != torch.bfloat16:
        raise TypeError("the normalize kernel writes bfloat16, got %s"
                        % dtype)
    per_row = math.prod(x.shape[1:])
    if per_row % VECTOR_BYTES or x.data_ptr() % VECTOR_BYTES:
        raise ValueError(
            "normalize_u8 needs rows of a multiple of %d bytes on "
            "%d-byte aligned memory, got shape %s"
            % (VECTOR_BYTES, VECTOR_BYTES, tuple(x.shape)))
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    if out.numel():
        _kernels.NORMALIZE_U8.launch(x, out, rows, per_row, rows_valid)
    return out


def normalize_u8(x: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 [0,255] frames -> ``dtype`` in [-1, 1], every row."""
    if x.device.type == "cpu":
        return normalize_u8_reference(x, dtype)
    return normalize_u8_rows(x, int(x.shape[0]), dtype)
