"""Pure-Python baseline-JPEG coefficient decoder for the dct path.

A copy of ``rnb_tpu/decode/jpeg_dct.py``: a from-the-spec (ITU T.81
sequential DCT, 8-bit, Huffman) entropy decoder that stops the MJPEG
decode at dequantized 8x8 DCT coefficients (libjpeg never exposes
them). It is correct but slow: a native decode pool is the performance
path, not yet ported.

Scope matches the dct wire format (``rnb_tpu_torch/ops/dct.py``):
3-component 4:2:0 (2x2, 1x1, 1x1) sampling, geometry divisible by 16
(whole MCUs), restart markers supported. Anything else — progressive,
4:4:4, 12-bit, partial-MCU geometry — raises
:class:`~rnb_tpu_torch.decode.CorruptVideoError`.

Output block order is plane-major (Y blocks in raster order, then U,
then V), zigzag scan order within each block — what
``rnb_tpu_torch.ops.dct.pack_frame_dct`` packs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from rnb_tpu_torch.decode import CorruptVideoError


class _Huff:
    """Canonical Huffman decode tables per ITU T.81 F.2.2.3."""

    __slots__ = ("mincode", "maxcode", "valptr", "values")

    def __init__(self, counts, values):
        self.mincode = [0] * 17
        self.maxcode = [-1] * 17
        self.valptr = [0] * 17
        self.values = values
        code = 0
        k = 0
        for length in range(1, 17):
            self.valptr[length] = k
            self.mincode[length] = code
            n = counts[length - 1]
            code += n
            k += n
            self.maxcode[length] = code - 1 if n else -1
            code <<= 1


class _BitReader:
    """MSB-first bit reader over entropy-coded data with 0xFF00
    stuffing; a real marker ends the stream (zero bits synthesize past
    it)."""

    __slots__ = ("d", "n", "pos", "acc", "count")

    def __init__(self, data: bytes, pos: int):
        self.d = data
        self.n = len(data)
        self.pos = pos
        self.acc = 0
        self.count = 0

    def _fill(self) -> None:
        while self.count <= 24:
            b = 0
            if self.pos < self.n:
                b = self.d[self.pos]
                if b == 0xFF:
                    if self.pos + 1 < self.n \
                            and self.d[self.pos + 1] == 0x00:
                        self.pos += 2
                    else:
                        b = 0  # real marker: stop consuming
                else:
                    self.pos += 1
            self.acc = ((self.acc << 8) | b) & 0xFFFFFFFFFF
            self.count += 8

    def get(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        if self.count < nbits:
            self._fill()
        self.count -= nbits
        return (self.acc >> self.count) & ((1 << nbits) - 1)

    def consume_restart(self) -> bool:
        self.count = 0
        self.acc = 0
        if self.pos + 1 >= self.n or self.d[self.pos] != 0xFF:
            return False
        m = self.d[self.pos + 1]
        if m < 0xD0 or m > 0xD7:
            return False
        self.pos += 2
        return True

    def decode(self, table: _Huff) -> int:
        code = self.get(1)
        for length in range(1, 17):
            if table.maxcode[length] >= 0 \
                    and table.mincode[length] <= code \
                    <= table.maxcode[length]:
                return table.values[table.valptr[length]
                                    + code - table.mincode[length]]
            code = (code << 1) | self.get(1)
        raise CorruptVideoError("invalid Huffman code in scan data")


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def jpeg_frame_dct(data: bytes) -> Tuple[np.ndarray, int, int]:
    """One baseline JPEG -> ``(zz, width, height)`` where ``zz`` is
    ``(num_blocks, 64)`` int16 dequantized coefficients, plane-major
    block order, zigzag within a block (see module docstring for the
    supported stream shape)."""
    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise CorruptVideoError("not a JPEG stream (no SOI)")
    qt: Dict[int, np.ndarray] = {}
    hdc: Dict[int, _Huff] = {}
    hac: Dict[int, _Huff] = {}
    comps = []  # (id, h, v, tq); td/ta filled at SOS
    w = h = 0
    restart_interval = 0
    p = 2
    scan_start = None
    while scan_start is None:
        while p < n and data[p] != 0xFF:
            p += 1
        while p < n and data[p] == 0xFF:
            p += 1
        if p >= n:
            raise CorruptVideoError("truncated JPEG (no SOS)")
        m = data[p]
        p += 1
        if m == 0xD9:
            raise CorruptVideoError("EOI before SOS")
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if p + 2 > n:
            raise CorruptVideoError("truncated JPEG segment")
        seg_len = (data[p] << 8) | data[p + 1]
        if seg_len < 2 or p + seg_len > n:
            raise CorruptVideoError("bad JPEG segment length")
        seg = data[p + 2:p + seg_len]
        if m == 0xDB:  # DQT
            q = 0
            while q < len(seg):
                pq, tq = seg[q] >> 4, seg[q] & 15
                q += 1
                need = 128 if pq else 64
                if q + need > len(seg):
                    raise CorruptVideoError("truncated DQT")
                if pq:
                    table = np.frombuffer(
                        seg[q:q + 128], ">u2").astype(np.int32)
                else:
                    table = np.frombuffer(
                        seg[q:q + 64], np.uint8).astype(np.int32)
                qt[tq] = table
                q += need
        elif m == 0xC4:  # DHT
            q = 0
            while q + 17 <= len(seg):
                tc, th = seg[q] >> 4, seg[q] & 15
                counts = list(seg[q + 1:q + 17])
                nvals = sum(counts)
                if q + 17 + nvals > len(seg):
                    raise CorruptVideoError("truncated DHT")
                values = list(seg[q + 17:q + 17 + nvals])
                (hac if tc else hdc)[th] = _Huff(counts, values)
                q += 17 + nvals
        elif m in (0xC0, 0xC1):  # baseline / extended sequential SOF
            if len(seg) < 6 or seg[0] != 8:
                raise CorruptVideoError("only 8-bit baseline JPEG is "
                                        "supported on the dct path")
            h = (seg[1] << 8) | seg[2]
            w = (seg[3] << 8) | seg[4]
            ncomp = seg[5]
            if ncomp != 3 or len(seg) < 6 + 3 * ncomp:
                raise CorruptVideoError("dct path needs 3-component "
                                        "YCbCr JPEG")
            for c in range(ncomp):
                comps.append({
                    "id": seg[6 + c * 3],
                    "h": seg[7 + c * 3] >> 4,
                    "v": seg[7 + c * 3] & 15,
                    "tq": seg[8 + c * 3],
                })
        elif m == 0xC2:
            raise CorruptVideoError("progressive JPEG unsupported on "
                                    "the dct path")
        elif m == 0xDD:  # DRI
            if len(seg) < 2:
                raise CorruptVideoError("truncated DRI")
            restart_interval = (seg[0] << 8) | seg[1]
        elif m == 0xDA:  # SOS
            if not comps:
                raise CorruptVideoError("SOS before SOF")
            ns = seg[0] if seg else 0
            if ns != len(comps) or len(seg) < 1 + 2 * ns + 3:
                raise CorruptVideoError("bad SOS header")
            for s in range(ns):
                cs = seg[1 + s * 2]
                for comp in comps:
                    if comp["id"] == cs:
                        comp["td"] = seg[2 + s * 2] >> 4
                        comp["ta"] = seg[2 + s * 2] & 15
            scan_start = p + seg_len
        p += seg_len
    if (comps[0]["h"], comps[0]["v"]) != (2, 2) or any(
            (c["h"], c["v"]) != (1, 1) for c in comps[1:]):
        raise CorruptVideoError(
            "dct path supports 4:2:0 (2x2,1x1,1x1) sampling only")
    if w % 16 or h % 16:
        raise CorruptVideoError(
            "dct path needs geometry divisible by 16 (whole MCUs), "
            "got %dx%d" % (w, h))
    for comp in comps:
        if comp["tq"] not in qt or comp.get("td") not in hdc \
                or comp.get("ta") not in hac:
            raise CorruptVideoError("missing quant/Huffman table")

    mcus_x, mcus_y = w // 16, h // 16
    yw = w // 8
    ny = (h // 8) * yw
    nc = mcus_x * mcus_y
    zz = np.zeros((ny + 2 * nc, 64), dtype=np.int16)
    plane_base = [0, ny, ny + nc]

    br = _BitReader(data, scan_start)
    dc_pred = [0, 0, 0]
    mcus_until_restart = restart_interval
    for my in range(mcus_y):
        for mx in range(mcus_x):
            if restart_interval and mcus_until_restart == 0:
                if not br.consume_restart():
                    raise CorruptVideoError("missing restart marker")
                dc_pred = [0, 0, 0]
                mcus_until_restart = restart_interval
            if restart_interval:
                mcus_until_restart -= 1
            for ci, comp in enumerate(comps):
                q = qt[comp["tq"]]
                dc_t = hdc[comp["td"]]
                ac_t = hac[comp["ta"]]
                for by in range(comp["v"]):
                    for bx in range(comp["h"]):
                        if ci == 0:
                            bidx = (my * 2 + by) * yw + mx * 2 + bx
                        else:
                            bidx = plane_base[ci] + my * mcus_x + mx
                        t = br.decode(dc_t)
                        if t > 11:
                            raise CorruptVideoError("bad DC category")
                        dc_pred[ci] += _extend(br.get(t), t)
                        row = zz[bidx]
                        row[0] = np.clip(dc_pred[ci] * int(q[0]),
                                         -32768, 32767)
                        k = 1
                        while k < 64:
                            rs = br.decode(ac_t)
                            s = rs & 15
                            if s:
                                k += rs >> 4
                                if k > 63:
                                    raise CorruptVideoError(
                                        "AC index overrun")
                                row[k] = np.clip(
                                    _extend(br.get(s), s) * int(q[k]),
                                    -32768, 32767)
                                k += 1
                            elif (rs >> 4) == 15:
                                k += 16  # ZRL
                            else:
                                break  # EOB
    return zz, w, h
