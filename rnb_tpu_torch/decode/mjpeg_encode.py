"""Baseline-JPEG encoder in numpy: the port's ``write_mjpeg``.

The reference writes its MJPEG files through PIL
(``rnb_tpu/decode/__init__.py`` ``write_mjpeg``: quality ``q``,
``subsampling=2``). The port writes the same stream shape itself, with
no PIL, following libjpeg's defaults step by step so that its files are
what PIL's libjpeg writes for the same frames:

* the fixed-point RGB -> YCbCr of ``jccolor.c`` (16 fraction bits);
* 4:2:0 chroma by ``jcsample.c``'s h2v2 box with its alternating 1/2
  rounding bias, the right edge replicated first;
* edge replication down to whole iMCU rows (``jcprepct.c``) and, past a
  component's last whole block, the dummy blocks of ``jccoefct.c``
  (zero AC, DC copied from the block to the left, or above-right);
* the slow integer forward DCT (``jfdctint.c``) and libjpeg's rounding
  quantizer, against the IJG base tables scaled by
  ``jpeg_quality_scaling``;
* the Annex K.3 Huffman tables, one interleaved scan: DC coded as a
  difference per component, runs of 16 zeros as ZRL (0xF0), 0xFF bytes
  stuffed with 0x00, the last byte padded with 1-bits.

Each frame is SOI, a JFIF APP0, two DQT, SOF0 (Y 2x2, Cb and Cr 1x1),
four DHT, SOS, the entropy-coded data and EOI; an MJPEG file is such
frames back to back. The work is vectorised over every block of every
frame of a call: the symbols of a block come from ``np.nonzero`` over
its zig-zag coefficients, and the bit strings of all symbols are packed
in one ``np.packbits``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from rnb_tpu_torch.ops.dct import ZIGZAG_NATURAL

#: the IJG base quantization tables (ITU T.81 Annex K.1), natural order
LUMA_BASE = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103,
    99], dtype=np.int64)
CHROMA_BASE = np.full(64, 99, dtype=np.int64)
CHROMA_BASE[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

#: the Annex K.3 Huffman tables: (code counts by length 1..16, values)
DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
           tuple(range(12)))
DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             tuple(range(12)))
AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), (
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
    0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
    0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
    0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
    0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
    0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
    0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
    0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA))
AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), (
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
    0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
    0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15,
    0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17,
    0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A,
    0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65,
    0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A,
    0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5,
    0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9,
    0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA))

#: frames encoded per vectorised batch (bounds the bit array's size)
BATCH_FRAMES = 32


def quality_scaling(quality: int) -> int:
    """libjpeg's ``jpeg_quality_scaling``: quality 1..100 -> a
    percentage of the base tables."""
    quality = min(max(int(quality), 1), 100)
    return 5000 // quality if quality < 50 else 200 - 2 * quality


def quant_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(luma, chroma)`` quantization tables in natural order, as
    ``jpeg_set_quality(quality, force_baseline=TRUE)`` builds them."""
    scale = quality_scaling(quality)
    return tuple(np.clip((base * scale + 50) // 100, 1, 255)
                 for base in (LUMA_BASE, CHROMA_BASE))


def _huffman_codes(table) -> Tuple[np.ndarray, np.ndarray]:
    """A DHT table -> ``(code, length)`` indexed by symbol (Annex C)."""
    counts, values = table
    codes = np.zeros(256, dtype=np.int64)
    lengths = np.zeros(256, dtype=np.int64)
    code = k = 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            codes[values[k]] = code
            lengths[values[k]] = length
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


_CODES = {name: _huffman_codes(table) for name, table in (
    ("dc0", DC_LUMA), ("ac0", AC_LUMA), ("dc1", DC_CHROMA),
    ("ac1", AC_CHROMA))}


# -- colour conversion and downsampling ---------------------------------

def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


def rgb_to_ycbcr(frames: np.ndarray) -> Tuple[np.ndarray, ...]:
    """``(N, H, W, 3)`` uint8 RGB -> Y, Cb, Cr ``(N, H, W)`` int64, by
    ``jccolor.c``'s ``rgb_ycc_convert``."""
    r, g, b = (frames[..., c].astype(np.int64) for c in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b
          + offset + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + offset + half - 1) >> 16
    return y, cb, cr


def _pad_edges(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Replicate the last row and column of ``(N, h, w)`` out to
    ``(N, rows, cols)``."""
    n, h, w = plane.shape
    return np.pad(plane, ((0, 0), (0, rows - h), (0, cols - w)),
                  mode="edge")


def downsample_h2v2(plane: np.ndarray, out_cols: int) -> np.ndarray:
    """``jcsample.c``'s ``h2v2_downsample``: the right edge replicated
    to ``2 * out_cols``, then each 2x2 box summed with a bias that
    alternates 1, 2, 1, ... along a row, shifted right by 2."""
    n, h, w = plane.shape
    plane = _pad_edges(plane, h, 2 * out_cols)
    box = (plane[:, 0::2, 0::2] + plane[:, 0::2, 1::2]
           + plane[:, 1::2, 0::2] + plane[:, 1::2, 1::2])
    bias = np.where(np.arange(out_cols) % 2 == 0, 1, 2)
    return (box + bias) >> 2


# -- forward DCT and quantization ---------------------------------------

_CONST_BITS = 13
_PASS1_BITS = 2
(_F0298, _F0390, _F0541, _F0765, _F0899, _F1175, _F1501, _F1847,
 _F1961, _F2053, _F2562, _F3072) = (2446, 3196, 4433, 6270, 7373, 9633,
                                    12299, 15137, 16069, 16819, 20995,
                                    25172)


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _fdct_pass(d: np.ndarray, first: bool) -> np.ndarray:
    """One 1-D pass of ``jfdctint.c``'s ``jpeg_fdct_islow`` along the
    last axis."""
    d0, d1, d2, d3, d4, d5, d6, d7 = (d[..., i] for i in range(8))
    tmp0, tmp7 = d0 + d7, d0 - d7
    tmp1, tmp6 = d1 + d6, d1 - d6
    tmp2, tmp5 = d2 + d5, d2 - d5
    tmp3, tmp4 = d3 + d4, d3 - d4
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = np.empty_like(d)
    odd_shift = _CONST_BITS - _PASS1_BITS if first \
        else _CONST_BITS + _PASS1_BITS
    if first:
        out[..., 0] = (tmp10 + tmp11) << _PASS1_BITS
        out[..., 4] = (tmp10 - tmp11) << _PASS1_BITS
    else:
        out[..., 0] = _descale(tmp10 + tmp11, _PASS1_BITS)
        out[..., 4] = _descale(tmp10 - tmp11, _PASS1_BITS)
    z1 = (tmp12 + tmp13) * _F0541
    out[..., 2] = _descale(z1 + tmp13 * _F0765, odd_shift)
    out[..., 6] = _descale(z1 - tmp12 * _F1847, odd_shift)
    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4 = tmp4 * _F0298
    tmp5 = tmp5 * _F2053
    tmp6 = tmp6 * _F3072
    tmp7 = tmp7 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    out[..., 7] = _descale(tmp4 + z1 + z3, odd_shift)
    out[..., 5] = _descale(tmp5 + z2 + z4, odd_shift)
    out[..., 3] = _descale(tmp6 + z2 + z3, odd_shift)
    out[..., 1] = _descale(tmp7 + z1 + z4, odd_shift)
    return out


def forward_dct_quantize(blocks: np.ndarray, table: np.ndarray
                         ) -> np.ndarray:
    """``(..., 8, 8)`` samples -> ``(..., 64)`` quantized coefficients
    in zig-zag order: the level shift, ``jpeg_fdct_islow`` (rows, then
    columns; the result is scaled up by 8) and ``jcdctmgr.c``'s
    quantizer (round half away from zero, by the table times 8)."""
    data = blocks.astype(np.int64) - 128
    data = _fdct_pass(data, first=True)
    data = _fdct_pass(np.swapaxes(data, -1, -2), first=False)
    data = np.swapaxes(data, -1, -2).reshape(data.shape[:-2] + (64,))
    divisor = table.astype(np.int64) << 3
    mag = (np.abs(data) + (divisor >> 1)) // divisor
    quant = np.where(data < 0, -mag, mag)
    return quant[..., ZIGZAG_NATURAL]


def _blocks(plane: np.ndarray) -> np.ndarray:
    """``(N, 8*by, 8*bx)`` -> ``(N, by, bx, 8, 8)``."""
    n, h, w = plane.shape
    return plane.reshape(n, h // 8, 8, w // 8, 8).swapaxes(2, 3)


def _component(plane: np.ndarray, blocks_y: int, blocks_x: int,
               grid_y: int, grid_x: int, table: np.ndarray) -> np.ndarray:
    """One component's quantized zig-zag blocks over the MCU grid
    ``(N, grid_y, grid_x, 64)``: its ``blocks_y x blocks_x`` real blocks
    from the edge-replicated samples, and ``jccoefct.c``'s dummy blocks
    past them (zero AC; DC copied from the block to the left, and on a
    dummy row from the last block of the row above)."""
    n = plane.shape[0]
    samples = _pad_edges(plane, 8 * blocks_y, 8 * blocks_x)
    real = forward_dct_quantize(_blocks(samples), table)
    if (blocks_y, blocks_x) == (grid_y, grid_x):
        return real
    out = np.zeros((n, grid_y, grid_x, 64), dtype=np.int64)
    out[:, :blocks_y, :blocks_x] = real
    # an MCU is two blocks wide and tall here: at most one dummy column
    # and one dummy row
    if grid_x > blocks_x:
        out[:, :blocks_y, blocks_x, 0] = real[:, :, -1, 0]
    if grid_y > blocks_y:
        # each block of the dummy row copies the DC of the block above
        # and right of it in its MCU (the upper row's last block)
        upper = out[:, blocks_y - 1, 1::2, 0]
        out[:, blocks_y, 0::2, 0] = upper
        out[:, blocks_y, 1::2, 0] = upper
    return out


def frame_coefficients(frames: np.ndarray, quality: int) -> tuple:
    """``(N, H, W, 3)`` uint8 RGB -> ``(y, cb, cr)`` quantized zig-zag
    coefficients ``(N, by, bx, 64)`` over the MCU-aligned block grids
    (Y ``2 * mcus``, chroma ``mcus``), as libjpeg quantizes them."""
    n, h, w, _ = frames.shape
    if h % 2 or w % 2:
        raise ValueError("4:2:0 JPEG needs even geometry, got %dx%d"
                         % (h, w))
    luma_q, chroma_q = quant_tables(quality)
    mcus_y, mcus_x = -(-h // 16), -(-w // 16)
    y, cb, cr = rgb_to_ycbcr(frames)
    cw_blocks, ch_blocks = -(-(w // 2) // 8), -(-(h // 2) // 8)
    coeffs = [_component(y, -(-h // 8), -(-w // 8), 2 * mcus_y,
                         2 * mcus_x, luma_q)]
    for plane in (cb, cr):
        sub = downsample_h2v2(plane, 8 * cw_blocks)
        coeffs.append(_component(sub, ch_blocks, cw_blocks, mcus_y,
                                 mcus_x, chroma_q))
    return tuple(coeffs)


def plane_major(coeffs: tuple) -> np.ndarray:
    """``(y, cb, cr)`` block grids -> ``(N, blocks, 64)`` int16: Y blocks
    in raster order, then Cb, then Cr (the order ``jpeg_frame_dct``
    returns, there dequantized)."""
    n = coeffs[0].shape[0]
    return np.concatenate([c.reshape(n, -1, 64) for c in coeffs],
                          axis=1).astype(np.int16)


# -- entropy coding -----------------------------------------------------

def _bit_length(v: np.ndarray) -> np.ndarray:
    """Bits of ``|v|`` (the JPEG magnitude category), for ``|v| < 2**16``."""
    mag = np.abs(v)
    out = np.zeros(mag.shape, dtype=np.int64)
    for bit in range(16):
        out += mag >= (1 << bit)
    return out


def _mcu_order(coeffs: tuple) -> Tuple[np.ndarray, np.ndarray]:
    """Blocks in scan order ``(N, mcus * 6, 64)`` and each one's
    component (0 Y, 1 Cb, 2 Cr): per MCU its four Y blocks in raster
    order, then Cb, then Cr."""
    y, cb, cr = coeffs
    n, gy, gx, _ = y.shape
    my, mx = gy // 2, gx // 2
    y = y.reshape(n, my, 2, mx, 2, 64).transpose(0, 1, 3, 2, 4, 5)
    y = y.reshape(n, my, mx, 4, 64)
    mcu = np.concatenate([y, cb[:, :, :, None], cr[:, :, :, None]],
                         axis=3)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
    return mcu.reshape(n, my * mx * 6, 64), comp


def _scan_tokens(coeffs: tuple):
    """Every frame's entropy-coded symbols as ``(frame, value, length)``
    bit strings in stream order: a Huffman code with its magnitude bits
    appended (at most 16 + 11 bits each)."""
    blocks, comp = _mcu_order(coeffs)
    n, nb, _ = blocks.shape
    table = np.where(comp == 0, 0, 1)
    # DC: the difference from the previous block of the same component
    dc = blocks[:, :, 0]
    diff = np.empty_like(dc)
    for c in range(3):
        cols = np.nonzero(comp == c)[0]
        d = dc[:, cols]
        diff[:, cols] = np.diff(d, axis=1, prepend=0)
    # per-symbol arrays, keyed for the stream order: block, then zig-zag
    # position (DC 0, EOB 64), then the ZRLs before an AC symbol
    keys, frames, runsize, amp, tabs = [], [], [], [], []
    fidx = np.repeat(np.arange(n), nb)
    bidx = np.tile(np.arange(nb), n)
    flat = blocks.reshape(n * nb, 64)
    block_tab = np.tile(table, n)
    # DC symbols
    cat = _bit_length(diff.ravel())
    keys.append((bidx * 65) * 4)
    frames.append(fidx)
    runsize.append(cat)
    amp.append(diff.ravel())
    tabs.append(block_tab * 2)
    # AC symbols
    rows, ks = np.nonzero(flat[:, 1:])
    ks = ks + 1
    first = np.ones(rows.size, dtype=bool)
    first[1:] = rows[1:] != rows[:-1]
    prev = np.where(first, 0, np.concatenate(([0], ks[:-1])))
    run = ks - prev - 1
    zrl = run // 16
    vals = flat[rows, ks]
    size = _bit_length(vals)
    base = (bidx[rows] * 65 + ks) * 4
    keys.append(base + zrl)
    frames.append(fidx[rows])
    runsize.append(((run % 16) << 4) | size)
    amp.append(vals)
    tabs.append(block_tab[rows] * 2 + 1)
    # ZRLs: up to three before an AC symbol
    zrows = np.repeat(np.arange(rows.size), zrl)
    zsub = np.arange(zrows.size) - np.repeat(np.cumsum(zrl) - zrl, zrl)
    keys.append(base[zrows] + zsub)
    frames.append(fidx[rows][zrows])
    runsize.append(np.full(zrows.size, 0xF0, dtype=np.int64))
    amp.append(np.zeros(zrows.size, dtype=np.int64))
    tabs.append(block_tab[rows][zrows] * 2 + 1)
    # EOB where the block's last coefficient is zero
    eob = np.nonzero(flat[:, 63] == 0)[0]
    keys.append((bidx[eob] * 65 + 64) * 4)
    frames.append(fidx[eob])
    runsize.append(np.zeros(eob.size, dtype=np.int64))
    amp.append(np.zeros(eob.size, dtype=np.int64))
    tabs.append(block_tab[eob] * 2 + 1)

    keys = np.concatenate(keys)
    frames = np.concatenate(frames)
    order = np.lexsort((keys, frames))
    runsize = np.concatenate(runsize)[order]
    amp = np.concatenate(amp)[order]
    tabs = np.concatenate(tabs)[order]
    frames = frames[order]
    code = np.empty(order.size, dtype=np.int64)
    code_len = np.empty(order.size, dtype=np.int64)
    for t, name in enumerate(("dc0", "ac0", "dc1", "ac1")):
        sel = tabs == t
        codes, lengths = _CODES[name]
        code[sel] = codes[runsize[sel]]
        code_len[sel] = lengths[runsize[sel]]
    nbits = runsize & 15
    # a negative amplitude is sent as its ones' complement (v - 1)
    extra = np.where(amp < 0, amp - 1, amp) & ((1 << nbits) - 1)
    value = (code << nbits) | extra
    return frames, value, code_len + nbits


def _pack(frames: np.ndarray, value: np.ndarray, length: np.ndarray,
          n: int) -> List[bytes]:
    """Bit strings -> each frame's entropy-coded bytes: MSB first, the
    last byte padded with 1-bits, every 0xFF followed by a stuffed
    0x00."""
    bits_per_frame = np.bincount(frames, weights=length,
                                 minlength=n).astype(np.int64)
    pad = (-bits_per_frame) % 8
    # one padding token of 1-bits after each frame's last symbol
    last = np.searchsorted(frames, np.arange(n), side="right")
    value = np.insert(value, last, (1 << pad) - 1)
    length = np.insert(length, last, pad)
    total = int(length.sum())
    token = np.repeat(np.arange(length.size), length)
    starts = np.cumsum(length) - length
    shift = length[token] - 1 - (np.arange(total) - starts[token])
    bits = ((value[token] >> shift) & 1).astype(np.uint8)
    data = np.packbits(bits)
    frame_bytes = (bits_per_frame + pad) // 8
    bounds = np.concatenate(([0], np.cumsum(frame_bytes)))
    ff = np.nonzero(data == 0xFF)[0]
    stuffed = np.insert(data, ff + 1, 0)
    # each stuffed byte moves the later frames' bounds by one
    bounds = bounds + np.searchsorted(ff, bounds, side="left")
    return [stuffed[bounds[i]:bounds[i + 1]].tobytes() for i in range(n)]


# -- headers --------------------------------------------------------------

def _segment(marker: int, payload: bytes) -> bytes:
    return bytes((0xFF, marker)) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def _dht(table_class: int, table_id: int, table) -> bytes:
    counts, values = table
    return _segment(0xC4, bytes([(table_class << 4) | table_id])
                    + bytes(counts) + bytes(values))


def frame_header(height: int, width: int, quality: int) -> bytes:
    """Every marker segment of a frame up to and including SOS, as
    libjpeg writes them under PIL's defaults (JFIF 1.01, no density
    units)."""
    luma_q, chroma_q = quant_tables(quality)
    return b"".join([
        b"\xff\xd8",
        _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
        _segment(0xDB, bytes([0]) + bytes(
            luma_q[ZIGZAG_NATURAL].astype(np.uint8))),
        _segment(0xDB, bytes([1]) + bytes(
            chroma_q[ZIGZAG_NATURAL].astype(np.uint8))),
        _segment(0xC0, bytes([8]) + height.to_bytes(2, "big")
                 + width.to_bytes(2, "big")
                 + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])),
        _dht(0, 0, DC_LUMA), _dht(1, 0, AC_LUMA),
        _dht(0, 1, DC_CHROMA), _dht(1, 1, AC_CHROMA),
        _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])),
    ])


def encode_frames(frames: np.ndarray, quality: int = 90
                  ) -> Tuple[List[bytes], np.ndarray]:
    """``(N, H, W, 3)`` uint8 RGB -> ``(jpegs, zz)``: each frame's
    baseline JPEG bytes, and its quantized zig-zag coefficients
    ``(N, blocks, 64)`` int16 in plane-major order over the MCU-aligned
    block grids (Y, then Cb, then Cr) — the encoder's own truth, which a
    coefficient decoder returns dequantized."""
    frames = np.asarray(frames)
    if frames.ndim != 4 or frames.shape[-1] != 3 \
            or frames.dtype != np.uint8:
        raise ValueError("expected (N, H, W, 3) uint8 RGB frames, got %s "
                         "%s" % (frames.shape, frames.dtype))
    n, h, w, _ = frames.shape
    header = frame_header(h, w, quality)
    jpegs, zz = [], []
    for lo in range(0, n, BATCH_FRAMES):
        coeffs = frame_coefficients(frames[lo:lo + BATCH_FRAMES], quality)
        scans = _pack(*_scan_tokens(coeffs), n=coeffs[0].shape[0])
        jpegs.extend(header + scan + b"\xff\xd9" for scan in scans)
        zz.append(plane_major(coeffs))
    return jpegs, (np.concatenate(zz) if zz
                   else np.zeros((0, 0, 64), np.int16))


def write_mjpeg(path: str, frames: np.ndarray, quality: int = 90) -> None:
    """Write ``(N, H, W, 3)`` uint8 RGB frames (even geometry) as an
    MJPEG file: baseline 4:2:0 JPEG frames back to back, as the JAX
    package's ``write_mjpeg`` writes them through PIL."""
    jpegs, _ = encode_frames(frames, quality)
    with open(path, "wb") as f:
        for jpeg in jpegs:
            f.write(jpeg)
