"""Ragged row-pool dispatch: one pool shape, pad rows computed by nobody.

PyTorch counterpart of ``rnb_tpu/ops/ragged.py``. Stages dispatch a
flat row pool of fixed capacity ``(pool_rows, ...)`` plus a scalar
``rows_valid`` and a per-request ``segment_offsets`` table carried on
:class:`rnb_tpu_torch.stage.RaggedBatch`; the forward primitives mask
or skip rows past ``rows_valid``.

On the card the masking happens inside the kernels, which read
``rows_valid`` from device memory: the ragged normalize kernel
(``csrc/ragged.cu``, ``rnb_ragged_normalize_u8``) stores zeros for pad
rows without reading them or doing arithmetic, and the fused yuv420
kernel (``csrc/ingest.cu``, ``rnb_yuv420_normalize``) converts pad rows
as zero bytes without reading them. On the CPU the plain
versions mask with tensor ops. Either way valid rows are bit-identical
to the bucketed path applied to the same rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.ops.preprocess import (check_kernel_input,
                                          normalize_u8_reference,
                                          rows_valid_tensor)
from rnb_tpu_torch.ops.yuv import yuv420_normalize

#: the kernel's grid carries the pool row on an axis of this extent
MAX_POOL_ROWS = 65535


@dataclasses.dataclass(frozen=True)
class RaggedSettings:
    """Validated, defaulted view of the ``ragged`` root config key.

    ``pool_rows`` is the one dispatch shape's row capacity; ``None``
    defers to each participating stage's declared max rows.
    """

    pool_rows: Optional[int] = None

    @staticmethod
    def from_config(raw: Optional[dict]) -> Optional["RaggedSettings"]:
        """Settings from the config dict, or None when ragged is absent
        or ``enabled`` is false."""
        if not raw or not raw.get("enabled", True):
            return None
        pool_rows = raw.get("pool_rows")
        return RaggedSettings(
            pool_rows=int(pool_rows) if pool_rows is not None else None)


def resolve_pool_rows(pool_rows: Optional[int], declared_max: int,
                      what: str) -> int:
    """An explicit ``ragged.pool_rows`` must EQUAL the stage's declared
    max row axis: the pool is the stage's one dispatch shape."""
    declared_max = int(declared_max)
    if pool_rows is None:
        return declared_max
    pool_rows = int(pool_rows)
    if pool_rows != declared_max:
        raise ValueError(
            "ragged.pool_rows=%d does not match %s=%d — the pool is "
            "the stage's one dispatch shape, so its capacity must "
            "equal the declared max row axis" % (pool_rows, what,
                                                 declared_max))
    return pool_rows


def segment_offsets_of(counts: Sequence[int]) -> Tuple[int, ...]:
    """The cumulative segment table for per-request row ``counts``:
    request i owns rows ``[offsets[i], offsets[i+1])``."""
    offsets = [0]
    for n in counts:
        offsets.append(offsets[-1] + int(n))
    return tuple(offsets)


def check_segment_offsets(offsets: Sequence[int], valid: int) -> None:
    """Assert a segment table partitions ``[0, valid)``: nondecreasing,
    starting at 0 and ending exactly at ``valid``."""
    offsets = tuple(int(o) for o in offsets)
    if len(offsets) < 2:
        raise ValueError("segment_offsets needs >= 2 entries "
                         "(got %r)" % (offsets,))
    if offsets[0] != 0:
        raise ValueError("segment_offsets must start at 0, got %r"
                         % (offsets,))
    if any(b < a for a, b in zip(offsets, offsets[1:])):
        raise ValueError("segment_offsets must be nondecreasing, "
                         "got %r" % (offsets,))
    if offsets[-1] != int(valid):
        raise ValueError(
            "segment_offsets %r end at %d but rows_valid=%d — the "
            "segment table must partition the valid rows"
            % (offsets, offsets[-1], int(valid)))


def ragged_mask_rows(pool: torch.Tensor, rows_valid: int) -> torch.Tensor:
    """A copy of ``pool`` with every row ``>= rows_valid`` zeroed: the
    exact bytes the bucketed path ships for its pad rows."""
    out = pool.clone()
    out[max(0, int(rows_valid)):] = 0
    return out


def ragged_normalize_u8_reference(pool: torch.Tensor,
                                  rows_valid: Union[int, torch.Tensor],
                                  dtype: torch.dtype = torch.bfloat16
                                  ) -> torch.Tensor:
    """The plain version: the normalize of every row, then a ``where``
    on the row mask (the reference's masked-jnp formulation,
    ragged.py:242-244). ``rows_valid`` is an int or a 1-element tensor."""
    rows = int(pool.shape[0])
    if isinstance(rows_valid, torch.Tensor):
        rows_valid = rows_valid.reshape(()).to(pool.device)
    idx = torch.arange(rows, device=pool.device).reshape(
        (rows,) + (1,) * (pool.dim() - 1))
    return torch.where(idx < rows_valid,
                       normalize_u8_reference(pool, dtype),
                       torch.zeros((), dtype=dtype, device=pool.device))


def ragged_normalize_u8(pool: torch.Tensor,
                        rows_valid: Union[int, torch.Tensor],
                        dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """uint8 row pool -> normalized ``dtype`` pool; pad rows exactly
    zero. The ragged twin of ``normalize_u8``.

    ``rows_valid`` is an int or a 1-element int32 tensor on the pool's
    device. On a CUDA pool this launches ``rnb_ragged_normalize_u8``,
    which reads ``rows_valid`` from device memory: the launch arguments
    are the same for every batch composition, and a pad row is stored
    as zeros without being read. On a CPU pool it runs the plain
    version. There is no fallback from one to the other."""
    if pool.dim() < 1:
        raise ValueError("ragged_normalize_u8 needs a (rows, ...) pool")
    if pool.device.type == "cpu":
        return ragged_normalize_u8_reference(pool, rows_valid, dtype)
    check_kernel_input(pool, "ragged_normalize_u8")
    if dtype != torch.bfloat16:
        raise TypeError("the ragged normalize kernel writes bfloat16, got "
                        "%s" % dtype)
    rows = int(pool.shape[0])
    if rows > MAX_POOL_ROWS:
        raise ValueError("ragged_normalize_u8 takes at most %d pool rows, "
                         "got %d" % (MAX_POOL_ROWS, rows))
    valid = rows_valid_tensor(rows_valid, pool.device)
    out = torch.empty(pool.shape, dtype=torch.bfloat16, device=pool.device)
    if out.numel():
        _kernels.RAGGED_NORMALIZE_U8.launch(pool, out, valid, rows,
                                            math.prod(pool.shape[1:]))
    return out


def ragged_normalize_yuv420(pool: torch.Tensor,
                            rows_valid: Union[int, torch.Tensor],
                            height: int, width: int,
                            dtype: torch.dtype = torch.bfloat16
                            ) -> torch.Tensor:
    """Packed 4:2:0 row pool -> normalized NDHWC frames. Rows past
    ``rows_valid`` (an int or a 1-element int32 tensor on the pool's
    device) enter the converter as zero bytes, as in the reference, so
    they come out as the conversion of zero bytes — RGB (0, 135, 0),
    normalized (-1, 0.0588, -1) — not as zeros. On the card one launch
    of ``rnb_yuv420_normalize`` does the mask, the conversion and the
    normalize."""
    return yuv420_normalize(pool, height, width, rows_valid, dtype)
