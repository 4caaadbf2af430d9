"""DCT-domain ingest: packed dequantized coefficients -> normalized frames.

PyTorch counterpart of ``rnb_tpu/ops/dct.py``. The host decode stops
at entropy-decoded, dequantized 8x8 DCT coefficients and ships them in
a sparse packed int16 row format (half the bytes of packed 4:2:0 at the
default budget); the card runs

    unpack  ->  IDCT  ->  2x nearest chroma upsample  ->  BT.601
            ->  u8 quantize  ->  normalize to [-1, 1]

as one hand-written kernel (``csrc/dct.cu``, ``rnb_dct_ingest``): a
warp per 16x16 MCU unpacks its six blocks from the wire into shared
memory and runs a separable IDCT on each. The two halves also stand
alone as entries with kernels of their own, ``unpack_dct_rows``
(``rnb_dct_unpack``: the wire rows scattered into block-tiled dense
coefficient planes) and ``dct_convert`` (``rnb_dct_convert``: planes to
frames); the fused kernel is held bitwise to the two. A CPU tensor
takes the plain PyTorch versions; nothing falls back from one to the
other.

Wire row format (``dct_frame_elems`` int16 elements per frame; one clip
row is ``(consecutive_frames, elems)``), for ``H % 16 == W % 16 == 0``:

    [0 : NB)            per-block nonzero coefficient counts
    [NB : NB+C)         dequantized coefficient values, per block in
                        block order, ascending zigzag order in a block
    [NB+C : NB+2C)      the zigzag index (0..63) of each value

``NB = num_dct_blocks(H, W)`` (Y blocks in raster order, then U, then
V) and ``C`` is the per-frame coefficient budget. The unpack is
garbage-tolerant: counts clamp to [0, 64], entries past
``min(sum(counts), C)`` are dropped, positions clamp to [0, 63], and
two entries that land on one slot resolve as *last entry wins*.

Numerics: the plain convert mirrors the reference's
``_frame_rgb_normalized`` op for op (block-diagonal bases, float32
matmuls); the kernel sums each 8-point pass in its own order, so the
two agree within one u8 step on each quantized plane, where a one-ulp
difference flips ``floor(p + 128.5)`` — the reference's own bound
between its device and host IDCTs. BT.601 carries a one-step U or V
flip into B or R as 1.772 or 1.402 steps, so the RGB output agrees
within two steps. The unpack is bitwise on every input. Pad rows
(``>= rows_valid``) are exact zeros.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.ops.preprocess import (INV_255, RowsValid,
                                          check_kernel_input,
                                          rows_valid_int,
                                          rows_valid_pointer)

#: zigzag scan: position k in the scan -> natural (row-major u*8+v)
#: coefficient index
ZIGZAG_NATURAL = np.array([
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    dtype=np.int32)

#: output dtypes the convert kernel writes
CONVERT_DTYPES = (torch.bfloat16, torch.float32)


def _check_geometry(height: int, width: int) -> None:
    if height % 16 or width % 16:
        raise ValueError(
            "the dct pixel path needs H and W divisible by 16 (one "
            "4:2:0 MCU is 16x16 luma), got %dx%d" % (height, width))


def num_dct_blocks(height: int, width: int) -> int:
    """8x8 blocks per frame at 4:2:0: Y, then U and V at quarter
    resolution."""
    _check_geometry(height, width)
    return (height // 8) * (width // 8) + 2 * (height // 16) * (width // 16)


def default_dct_coeffs(height: int, width: int) -> int:
    """The default per-frame budget: the largest C for which a packed
    int16 frame costs no more than half the packed yuv420 frame."""
    _check_geometry(height, width)
    packed_yuv = height * width * 3 // 2
    max_elems = (packed_yuv // 2) // 2
    coeffs = (max_elems - num_dct_blocks(height, width)) // 2
    if coeffs < 1:
        raise ValueError("geometry %dx%d too small for the dct wire "
                         "format" % (height, width))
    return coeffs


def dct_frame_elems(height: int, width: int,
                    coeffs: Optional[int] = None) -> int:
    """int16 elements of one packed coefficient frame."""
    nb = num_dct_blocks(height, width)
    if coeffs is None:
        coeffs = default_dct_coeffs(height, width)
    coeffs = int(coeffs)
    if coeffs < 1:
        raise ValueError("dct coefficient budget must be >= 1, got %r"
                         % (coeffs,))
    return nb + 2 * coeffs


def coeffs_from_elems(height: int, width: int, elems: int) -> int:
    """The budget C of a wire row's trailing axis (the inverse of
    :func:`dct_frame_elems`)."""
    nb = num_dct_blocks(height, width)
    coeffs, rem = divmod(int(elems) - nb, 2)
    if rem or coeffs < 1:
        raise ValueError(
            "%d is not a valid dct frame length for %dx%d (expected "
            "num_blocks=%d + 2*C)" % (elems, height, width, nb))
    return coeffs


def pack_frame_dct(zz: np.ndarray, height: int, width: int,
                   coeffs: Optional[int] = None) -> np.ndarray:
    """Dense ``(num_blocks, 64)`` zigzag-order coefficients -> one wire
    frame. Raises ValueError when the nonzero count exceeds the
    budget."""
    nb = num_dct_blocks(height, width)
    if coeffs is None:
        coeffs = default_dct_coeffs(height, width)
    coeffs = int(coeffs)
    zz = np.asarray(zz, dtype=np.int16)
    if zz.shape != (nb, 64):
        raise ValueError("expected (%d, 64) zigzag coefficients for "
                         "%dx%d, got %r" % (nb, height, width, zz.shape))
    block_idx, pos_idx = np.nonzero(zz)   # row-major: block-then-zigzag
    total = block_idx.size
    if total > coeffs:
        raise ValueError(
            "frame has %d nonzero DCT coefficients but the wire "
            "budget is %d — raise dct_coeffs_per_frame (or use "
            "pixel_path yuv420 for this content)" % (total, coeffs))
    out = np.zeros(nb + 2 * coeffs, dtype=np.int16)
    out[:nb] = np.bincount(block_idx, minlength=nb).astype(np.int16)
    out[nb:nb + total] = zz[block_idx, pos_idx]
    out[nb + coeffs:nb + coeffs + total] = pos_idx.astype(np.int16)
    return out


def unpack_frame_dct_numpy(wire: np.ndarray, height: int,
                           width: int) -> np.ndarray:
    """Wire frame -> dense ``(num_blocks, 64)`` zigzag coefficients (the
    host-side inverse of :func:`pack_frame_dct`, for tests)."""
    nb = num_dct_blocks(height, width)
    coeffs = coeffs_from_elems(height, width, wire.shape[-1])
    wire = np.asarray(wire, dtype=np.int64)
    counts = np.clip(wire[:nb], 0, 64)
    total = min(int(counts.sum()), coeffs)
    block = np.repeat(np.arange(nb), counts)[:total]
    vals = wire[nb:nb + total]
    poss = np.clip(wire[nb + coeffs:nb + coeffs + total], 0, 63)
    zz = np.zeros((nb, 64), dtype=np.int16)
    zz[block, poss] = vals[: block.size].astype(np.int16)
    return zz


# -- IDCT bases ---------------------------------------------------------

def _idct_basis8() -> np.ndarray:
    """M[y, u] = c(u)/2 * cos((2y+1) u pi / 16): one 1-D 8-point inverse
    DCT pass; the 2-D block IDCT is M @ C @ M^T. ``csrc/dct.cu`` carries
    the same 64 float32 values as literals (a test holds them equal)."""
    y, u = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    m = 0.5 * np.cos((2 * y + 1) * u * np.pi / 16.0)
    m[:, 0] *= 1.0 / np.sqrt(2.0)
    return m.astype(np.float32)


def _plane_bases(height: int, width: int):
    """The reference's four plane bases: block-diagonal ``I ⊗ M8`` for
    luma (``ly (H, H)``, ``lyt (W, W)``) and the same for chroma with
    the 2x nearest upsample folded in by repeating rows (``lcr (H,
    H/2)``, ``lcct (W/2, W)``)."""
    m = _idct_basis8()
    ly = np.kron(np.eye(height // 8, dtype=np.float32), m)
    lyt = np.kron(np.eye(width // 8, dtype=np.float32), m).T
    cb_r = np.kron(np.eye(height // 16, dtype=np.float32), m)
    cb_c = np.kron(np.eye(width // 16, dtype=np.float32), m)
    lcr = np.repeat(cb_r, 2, axis=0)
    lcct = np.repeat(cb_c, 2, axis=0).T
    return (np.ascontiguousarray(ly), np.ascontiguousarray(lyt),
            np.ascontiguousarray(lcr), np.ascontiguousarray(lcct))


# -- plain versions -----------------------------------------------------

def _tiled(blocks: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """(N, bh*bw*64) natural-order blocks -> block-tiled (N, bh*8, bw*8):
    the 8x8 tile at (i, j) holds block ``i*bw + j``."""
    t = blocks.reshape(-1, bh, bw, 8, 8)
    return t.permute(0, 1, 3, 2, 4).reshape(-1, bh * 8, bw * 8)


def unpack_dct_rows_reference(x: torch.Tensor, height: int, width: int
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The plain unpack: wire rows ``(..., elems)`` int16 -> int32
    block-tiled planes ``(..., H, W)``, ``(..., H/2, W/2)`` x2.

    Entry ``e`` belongs to the block whose inclusive count prefix first
    exceeds ``e`` and is kept when ``e < min(total, C)``. Two kept
    entries on one slot resolve as last entry wins, through an ``amax``
    over entry indices (``scatter_`` leaves the order of duplicates
    undefined)."""
    nb = num_dct_blocks(height, width)
    coeffs = coeffs_from_elems(height, width, x.shape[-1])
    lead = tuple(x.shape[:-1])
    flat = x.reshape(-1, x.shape[-1]).to(torch.int64)
    n = flat.shape[0]
    counts = flat[:, :nb].clamp(0, 64)
    cum = counts.cumsum(dim=-1)                       # inclusive
    total = cum[:, -1:].clamp(max=coeffs)
    vals = flat[:, nb:nb + coeffs]
    poss = flat[:, nb + coeffs:nb + 2 * coeffs].clamp(0, 63)
    entry = torch.arange(coeffs, device=x.device).expand(n, coeffs)
    block = torch.searchsorted(cum, entry.contiguous(), right=True)
    natural = torch.from_numpy(ZIGZAG_NATURAL).to(x.device).long()[poss]
    ok = (entry < total) & (block < nb)
    dump = nb * 64      # one extra slot swallows every dropped entry
    target = torch.where(ok, block * 64 + natural, dump)
    winner = torch.full((n, dump + 1), -1, dtype=torch.int64,
                        device=x.device)
    winner.scatter_reduce_(1, target, entry, reduce="amax")
    winner = winner[:, :dump]
    dense = torch.where(winner >= 0, vals.gather(1, winner.clamp(min=0)),
                        0).to(torch.int32)
    ny = (height // 8) * (width // 8)
    nc = (height // 16) * (width // 16)
    ycoef = _tiled(dense[:, :ny * 64], height // 8, width // 8)
    ucoef = _tiled(dense[:, ny * 64:(ny + nc) * 64], height // 16,
                   width // 16)
    vcoef = _tiled(dense[:, (ny + nc) * 64:], height // 16, width // 16)
    return (ycoef.reshape(lead + ycoef.shape[1:]),
            ucoef.reshape(lead + ucoef.shape[1:]),
            vcoef.reshape(lead + vcoef.shape[1:]))


def _frame_rgb_normalized(cy, cu, cv, bases, dtype):
    """Block-tiled planes ``(..., H, W)`` -> normalized ``(..., H, W,
    3)``, op for op as the reference's ``_frame_rgb_normalized``: plane
    IDCT as ``left @ (coef @ right)`` in float32, +128.5 floor and clip
    (the host decoder's round-half-up u8 quantize), BT.601 in the numpy
    op order, clip and truncate, then the one-rounding normalize."""
    ly, lyt, lcr, lcct = bases

    def plane(coef, left, right):
        p = torch.matmul(left, torch.matmul(coef.to(torch.float32), right))
        return torch.floor(p + (128.0 + 0.5)).clamp(0.0, 255.0)

    y = plane(cy, ly, lyt)
    uf = plane(cu, lcr, lcct) - 128.0
    vf = plane(cv, lcr, lcct) - 128.0
    rgb = torch.stack([
        y + 1.402 * vf,
        y - 0.344136 * uf - 0.714136 * vf,
        y + 1.772 * uf,
    ], dim=-1)
    rgbq = torch.floor(rgb.clamp(0.0, 255.0))
    return ((rgbq * 2.0 - 255.0) * INV_255).to(dtype)


def dct_convert_reference(ycoef: torch.Tensor, ucoef: torch.Tensor,
                          vcoef: torch.Tensor, rows_valid: int,
                          height: int, width: int,
                          dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """The plain convert: planes ``(rows, F, ...)`` -> ``(rows, F, H, W,
    3)`` ``dtype``; rows at or past ``rows_valid`` are zeros and are not
    read."""
    rows, frames = int(ycoef.shape[0]), int(ycoef.shape[1])
    rows_valid = max(0, min(int(rows_valid), rows))
    out = torch.zeros((rows, frames, height, width, 3), dtype=dtype,
                      device=ycoef.device)
    if rows_valid:
        bases = tuple(torch.from_numpy(b).to(ycoef.device)
                      for b in _plane_bases(height, width))
        out[:rows_valid] = _frame_rgb_normalized(
            ycoef[:rows_valid], ucoef[:rows_valid], vcoef[:rows_valid],
            bases, dtype)
    return out


def dct_ingest_reference(wire: torch.Tensor, rows_valid: int,
                         height: int, width: int,
                         dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """The plain ingest: wire rows ``(rows, F, elems)`` -> ``(rows, F,
    H, W, 3)`` ``dtype``, the plain unpack followed by the plain
    convert; rows at or past ``rows_valid`` are zeros."""
    planes = unpack_dct_rows_reference(wire, height, width)
    return dct_convert_reference(*planes, rows_valid, height, width, dtype)


# -- entry points -------------------------------------------------------

def _check_out_dtype(dtype: torch.dtype) -> None:
    if dtype not in CONVERT_DTYPES:
        raise TypeError("the convert kernel writes %s, got %s"
                        % (CONVERT_DTYPES, dtype))


def _wire_coeffs(x: torch.Tensor, height: int, width: int) -> int:
    """The budget C of wire rows ``(rows, frames, NB + 2C)``; raises on
    any other shape."""
    if x.dim() != 3:
        raise ValueError("dct wire rows are (rows, frames, elems), got "
                         "shape %s" % (tuple(x.shape),))
    return coeffs_from_elems(height, width, x.shape[-1])


def _clamp_rows(rows_valid: Optional[int], rows: int) -> int:
    return rows if rows_valid is None else max(0, min(int(rows_valid),
                                                       rows))


def unpack_dct_rows(x: torch.Tensor, height: int, width: int,
                    rows_valid: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Wire rows ``(rows, frames, elems)`` int16 -> int32 block-tiled
    planes ``(rows, frames, H, W)`` and ``(rows, frames, H/2, W/2)``
    x2.

    A CUDA tensor launches ``rnb_dct_unpack``, which reads and writes
    rows ``< rows_valid`` (all by default) only: the planes of the rows
    past it are left as allocated, since the convert never reads them.
    A CPU tensor runs the plain version on every row."""
    coeffs = _wire_coeffs(x, height, width)
    if x.device.type == "cpu":
        return unpack_dct_rows_reference(x, height, width)
    check_kernel_input(x, "unpack_dct_rows", torch.int16)
    rows, frames = int(x.shape[0]), int(x.shape[1])
    rows_valid = _clamp_rows(rows_valid, rows)
    planes = (
        torch.empty((rows, frames, height, width), dtype=torch.int32,
                    device=x.device),
        torch.empty((rows, frames, height // 2, width // 2),
                    dtype=torch.int32, device=x.device),
        torch.empty((rows, frames, height // 2, width // 2),
                    dtype=torch.int32, device=x.device))
    if rows_valid and frames:
        _kernels.DCT_UNPACK.launch(x, *planes, rows_valid, frames, height,
                                   width, coeffs)
    return planes


def dct_convert(ycoef: torch.Tensor, ucoef: torch.Tensor,
                vcoef: torch.Tensor, rows_valid: Union[int, torch.Tensor],
                height: int, width: int,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Block-tiled planes -> normalized ``(rows, F, H, W, 3)`` frames,
    rows at or past ``rows_valid`` (an int or a 1-element int32 tensor
    on the planes' device) exactly zero. A CUDA tensor launches
    ``rnb_dct_convert``, which reads ``rows_valid`` from device memory
    (an int below the row count is written there by a fill; every row
    needs none); a CPU tensor runs the plain version."""
    _check_geometry(height, width)
    rows, frames = int(ycoef.shape[0]), int(ycoef.shape[1])
    if ycoef.device.type == "cpu":
        return dct_convert_reference(
            ycoef, ucoef, vcoef, rows_valid_int(rows_valid, rows,
                                                ycoef.device),
            height, width, dtype)
    want = ((rows, frames, height, width),
            (rows, frames, height // 2, width // 2),
            (rows, frames, height // 2, width // 2))
    for plane, shape in zip((ycoef, ucoef, vcoef), want):
        check_kernel_input(plane, "dct_convert", torch.int32)
        if tuple(plane.shape) != shape:
            raise ValueError("dct_convert planes must be %s, got %s"
                             % (want, tuple(plane.shape)))
    _check_out_dtype(dtype)
    valid = rows_valid_pointer(rows_valid, rows, ycoef.device)
    out = torch.empty((rows, frames, height, width, 3), dtype=dtype,
                      device=ycoef.device)
    if out.numel():
        _kernels.DCT_CONVERT.launch(
            ycoef, ucoef, vcoef, out, valid, rows, frames, height, width,
            int(dtype == torch.bfloat16))
    return out


def ragged_normalize_dct(pool: torch.Tensor, rows_valid: RowsValid,
                         height: int, width: int,
                         dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """The ragged ingest of the dct path: wire row pool ``(rows, F,
    elems)`` int16 + ``rows_valid`` (an int or a 1-element int32 tensor
    on the pool's device) -> normalized NDHWC pool whose rows ``>=
    rows_valid`` are exactly zero. A CUDA pool launches
    ``rnb_dct_ingest`` once; it reads ``rows_valid`` from device memory
    (see :func:`dct_convert`) and never reads the pool tail. A CPU pool
    runs :func:`dct_ingest_reference`."""
    coeffs = _wire_coeffs(pool, height, width)
    rows, frames = int(pool.shape[0]), int(pool.shape[1])
    if pool.device.type == "cpu":
        return dct_ingest_reference(
            pool, rows_valid_int(rows_valid, rows, pool.device), height,
            width, dtype)
    check_kernel_input(pool, "ragged_normalize_dct", torch.int16)
    _check_out_dtype(dtype)
    valid = rows_valid_pointer(rows_valid, rows, pool.device)
    out = torch.empty((rows, frames, height, width, 3), dtype=dtype,
                      device=pool.device)
    if out.numel():
        _kernels.DCT_INGEST.launch(pool, out, valid, rows, frames, height,
                                   width, coeffs,
                                   int(dtype == torch.bfloat16))
    return out


def normalize_dct(pool: torch.Tensor, height: int, width: int,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The bucketed ingest: every row converted. Zero wire rows (the
    loader's bucket padding) decode to flat mid-gray, 1/255 after the
    normalize, as in the reference."""
    return ragged_normalize_dct(pool, None, height, width, dtype)


# -- numpy oracle (tests) -----------------------------------------------

def dct_rows_to_rgb_numpy(wire: np.ndarray, height: int,
                          width: int) -> np.ndarray:
    """Wire rows ``(..., elems)`` -> u8 RGB ``(..., H, W, 3)`` in
    float64: the reference's numpy oracle, minus the normalize."""
    ly, lyt, lcr, lcct = _plane_bases(height, width)
    nb = num_dct_blocks(height, width)
    lead = wire.shape[:-1]
    flat = wire.reshape((-1, wire.shape[-1]))
    out = np.empty((flat.shape[0], height, width, 3), np.uint8)
    ny = (height // 8) * (width // 8)
    nc = (height // 16) * (width // 16)
    nat = ZIGZAG_NATURAL.astype(np.int64)

    def tiled(blocks, bh, bw):
        return blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3) \
            .reshape(bh * 8, bw * 8)

    def plane(c, left, right):
        p = left.astype(np.float64) @ c.astype(np.float64) \
            @ right.astype(np.float64)
        return np.clip(np.floor(p + 128.5), 0, 255)

    for i in range(flat.shape[0]):
        zz = unpack_frame_dct_numpy(flat[i], height, width)
        dense = np.zeros((nb, 64), np.float32)
        dense[np.arange(nb)[:, None], nat[None, :]] = zz
        y = plane(tiled(dense[:ny], height // 8, width // 8), ly, lyt)
        u = plane(tiled(dense[ny:ny + nc], height // 16, width // 16),
                  lcr, lcct)
        v = plane(tiled(dense[ny + nc:], height // 16, width // 16),
                  lcr, lcct)
        rgb = np.stack([
            y + 1.402 * (v - 128.0),
            y - 0.344136 * (u - 128.0) - 0.714136 * (v - 128.0),
            y + 1.772 * (u - 128.0),
        ], axis=-1)
        out[i] = np.floor(np.clip(rgb, 0, 255)).astype(np.uint8)
    return out.reshape(lead + (height, width, 3))
