"""Host-side video decode: videos -> packed clip rows for the card.

Counterpart of ``rnb_tpu/decode/__init__.py``. ``decode_clips`` returns
RGB uint8 frames ``(clips, frames, H, W, 3)`` (rgb path, normalized on
the card by ``rnb_tpu_torch/ops/preprocess.py`` or ``ops/ragged.py``);
``decode_clips_yuv`` returns packed 4:2:0 planes (yuv420 path,
converted on the card by ``rnb_tpu_torch/ops/yuv.py``);
``decode_clips_dct`` returns packed int16 dequantized DCT coefficient
rows (dct path, ``rnb_tpu_torch/ops/dct.py``). numpy only; every
backend's output is byte-equal to the JAX package's for the same input.

Backends, picked by :func:`get_decoder`:

* :class:`SyntheticDecoder` for ``synth://`` ids: procedural clips,
  deterministic per (id, clip start) — the dataset-free arm;
* :class:`Y4MDecoder` for uncompressed ``.y4m`` (rgb and yuv420: such
  a file holds no DCT coefficients);
* :class:`MjpegDecoder` for ``.mjpg``/``.mjpeg`` (dct only), through
  the pure-Python coefficient decoder ``jpeg_dct``; its RGB decode is
  not ported (the reference's needs PIL).

A video that cannot be decoded raises (:class:`CorruptVideoError`, a
``ValueError``); the serving path lets that fail the run loudly.
"""

from __future__ import annotations

import os
import threading
import zlib
from typing import List, Optional

import numpy as np

DEFAULT_WIDTH = 112
DEFAULT_HEIGHT = 112
SYNTH_PREFIX = "synth://"


class CorruptVideoError(ValueError):
    """A video that can never decode on the asked path: a bad or
    truncated stream, an unsupported format, an over-budget spectrum."""


class SyntheticDecoder:
    """Procedural clips, deterministic per (video id, clip start), with
    the JAX package's seeds: the frame count comes from the id's CRC32,
    each clip's bytes from a PRNG seeded by a CRC32 of the id, the
    start and the pixel path."""

    BACKEND = "synth"

    def __init__(self, min_frames: int = 128, max_frames: int = 360):
        self.min_frames = min_frames
        self.max_frames = max_frames

    def num_frames(self, video: str) -> int:
        h = zlib.crc32(("len:" + video).encode())
        return self.min_frames + h % (self.max_frames - self.min_frames + 1)

    def decode_clips(self, video: str, clip_starts: List[int],
                     consecutive_frames: int = 8,
                     width: int = DEFAULT_WIDTH,
                     height: int = DEFAULT_HEIGHT) -> np.ndarray:
        """uint8 ``(num_clips, consecutive_frames, H, W, 3)`` RGB frames
        of PRNG noise."""
        out = np.empty((len(clip_starts), consecutive_frames, height, width,
                        3), dtype=np.uint8)
        for i, start in enumerate(clip_starts):
            seed = zlib.crc32(("%s@%d" % (video, start)).encode())
            rng = np.random.default_rng(seed)
            out[i] = rng.integers(0, 256,
                                  (consecutive_frames, height, width, 3),
                                  dtype=np.uint8)
        return out

    def decode_clips_yuv(self, video: str, clip_starts: List[int],
                         consecutive_frames: int = 8,
                         width: int = DEFAULT_WIDTH,
                         height: int = DEFAULT_HEIGHT) -> np.ndarray:
        """uint8 ``(num_clips, consecutive_frames, H*W*3//2)`` of PRNG
        noise (a stream of its own, apart from the rgb path's)."""
        if width % 2 or height % 2:
            raise ValueError("packed 4:2:0 needs even geometry")
        packed = height * width * 3 // 2
        out = np.empty((len(clip_starts), consecutive_frames, packed),
                       dtype=np.uint8)
        for i, start in enumerate(clip_starts):
            seed = zlib.crc32(("yuv:%s@%d" % (video, start)).encode())
            rng = np.random.default_rng(seed)
            out[i] = rng.integers(0, 256, (consecutive_frames, packed),
                                  dtype=np.uint8)
        return out

    def decode_clips_dct(self, video: str, clip_starts: List[int],
                         consecutive_frames: int = 8,
                         width: int = DEFAULT_WIDTH,
                         height: int = DEFAULT_HEIGHT,
                         coeffs: Optional[int] = None) -> np.ndarray:
        """int16 ``(num_clips, consecutive_frames, elems)`` wire rows: a
        short zigzag-prefix spectrum per block (1..6 coefficients of
        magnitude 1..479), like quantized video and always within the
        budget, so the dataset-free arm runs the real unpack and IDCT."""
        from rnb_tpu_torch.ops.dct import dct_frame_elems, num_dct_blocks
        nb = num_dct_blocks(height, width)
        elems = dct_frame_elems(height, width, coeffs)
        budget = (elems - nb) // 2
        if budget < nb:
            raise ValueError(
                "dct coefficient budget %d below one coefficient per "
                "block (%d)" % (budget, nb))
        kmax = min(6, budget // nb)
        out = np.zeros((len(clip_starts), consecutive_frames, elems),
                       dtype=np.int16)
        for i, start in enumerate(clip_starts):
            seed = zlib.crc32(("dct:%s@%d" % (video, start)).encode())
            rng = np.random.default_rng(seed)
            for fi in range(consecutive_frames):
                counts = rng.integers(1, kmax + 1, nb)
                total = int(counts.sum())
                mags = rng.integers(1, 480, total)
                signs = rng.integers(0, 2, total) * 2 - 1
                # zigzag-prefix positions: 0..counts[b]-1 per block
                cum = np.concatenate(([0], np.cumsum(counts)[:-1]))
                poss = np.arange(total) - np.repeat(cum, counts)
                row = out[i, fi]
                row[:nb] = counts.astype(np.int16)
                row[nb:nb + total] = (mags * signs).astype(np.int16)
                row[nb + budget:nb + budget + total] = \
                    poss.astype(np.int16)
        return out


class Y4MDecoder:
    """Uncompressed YUV4MPEG2 (.y4m) decode, 4:2:0 or 4:4:4 sources: to
    RGB frames (chroma upsample, full-range BT.601 in float32, clip,
    truncate, nearest resize), or to packed output-resolution 4:2:0
    planes."""

    BACKEND = "y4m"

    def __init__(self):
        self._meta = {}
        self._lock = threading.Lock()

    def _parse_header(self, video: str) -> dict:
        with self._lock:
            meta = self._meta.get(video)
        if meta is not None:
            return meta
        with open(video, "rb") as f:
            header = f.readline()
            marker = f.readline()
        if not header.startswith(b"YUV4MPEG2"):
            raise ValueError("%s is not a y4m file" % video)
        width = height = None
        cs = "420"
        for token in header.split()[1:]:
            tag, val = token[:1], token[1:]
            if tag == b"W":
                width = int(val)
            elif tag == b"H":
                height = int(val)
            elif tag == b"C":
                cs = val.decode()
        if not width or not height:
            raise ValueError("y4m header of %s lacks geometry" % video)
        if cs.startswith("420"):
            frame_bytes, subsample = width * height * 3 // 2, 2
        elif cs.startswith("444"):
            frame_bytes, subsample = width * height * 3, 1
        else:
            raise ValueError("unsupported y4m colourspace %s" % cs)
        if not marker.startswith(b"FRAME"):
            raise ValueError("missing FRAME marker in %s" % video)
        data_start = len(header)
        stride = len(marker) + frame_bytes
        count = (os.path.getsize(video) - data_start) // stride
        meta = dict(width=width, height=height, subsample=subsample,
                    frame_bytes=frame_bytes, data_start=data_start,
                    marker_len=len(marker), stride=stride, count=count)
        with self._lock:
            self._meta[video] = meta
        return meta

    def num_frames(self, video: str) -> int:
        return self._parse_header(video)["count"]

    @staticmethod
    def _read_frame(f, meta: dict) -> np.ndarray:
        """The frame at ``f``'s position -> ``(h, w, 3)`` RGB uint8 at
        the source geometry: nearest chroma upsample, full-range BT.601
        in float32, clipped to [0, 255] and truncated."""
        w, h, sub = meta["width"], meta["height"], meta["subsample"]
        payload = f.read(meta["frame_bytes"])
        if len(payload) < meta["frame_bytes"]:
            raise CorruptVideoError(
                "truncated y4m frame payload (%d of %d bytes)"
                % (len(payload), meta["frame_bytes"]))
        y = np.frombuffer(payload, np.uint8, w * h).reshape(h, w)
        cw, ch = w // sub, h // sub
        u = np.frombuffer(payload, np.uint8, cw * ch,
                          offset=w * h).reshape(ch, cw)
        v = np.frombuffer(payload, np.uint8, cw * ch,
                          offset=w * h + cw * ch).reshape(ch, cw)
        if sub > 1:
            u = u.repeat(sub, axis=0).repeat(sub, axis=1)
            v = v.repeat(sub, axis=0).repeat(sub, axis=1)
        yf = y.astype(np.float32)
        uf = u.astype(np.float32) - 128.0
        vf = v.astype(np.float32) - 128.0
        rgb = np.stack([
            yf + 1.402 * vf,
            yf - 0.344136 * uf - 0.714136 * vf,
            yf + 1.772 * uf,
        ], axis=-1)
        return np.clip(rgb, 0.0, 255.0).astype(np.uint8)

    @staticmethod
    def _box_resize(frame: np.ndarray, width: int, height: int
                    ) -> np.ndarray:
        """Nearest-index resize to ``(height, width)``."""
        h, w = frame.shape[:2]
        if (h, w) == (height, width):
            return frame
        rows = np.arange(height) * h // height
        cols = np.arange(width) * w // width
        return frame[rows][:, cols]

    def decode_clips(self, video: str, clip_starts: List[int],
                     consecutive_frames: int = 8,
                     width: int = DEFAULT_WIDTH,
                     height: int = DEFAULT_HEIGHT) -> np.ndarray:
        """-> uint8 ``(num_clips, consecutive_frames, H, W, 3)`` RGB
        frames. Frames past the end repeat the last one."""
        meta = self._parse_header(video)
        if any(s < 0 for s in clip_starts):
            raise ValueError("negative clip start in %r" % (clip_starts,))
        out = np.empty((len(clip_starts), consecutive_frames, height, width,
                        3), dtype=np.uint8)
        with open(video, "rb") as f:
            for ci, start in enumerate(clip_starts):
                for fi in range(consecutive_frames):
                    idx = min(start + fi, meta["count"] - 1)
                    f.seek(meta["data_start"] + idx * meta["stride"]
                           + meta["marker_len"])
                    out[ci, fi] = self._box_resize(
                        self._read_frame(f, meta), width, height)
        return out

    @staticmethod
    def _gather_frame_yuv(payload: bytes, meta: dict, maps,
                          out: np.ndarray) -> None:
        """One frame payload -> packed output-res 4:2:0 planes in
        ``out``. Luma takes the nearest index map at full output
        resolution; chroma keeps its own nearest map at half output
        resolution."""
        w, h, sub = meta["width"], meta["height"], meta["subsample"]
        cw, ch = w // sub, h // sub
        rows, cols, crows, ccols = maps
        if len(payload) < meta["frame_bytes"]:
            raise ValueError("truncated y4m frame payload (%d of %d bytes)"
                             % (len(payload), meta["frame_bytes"]))
        y = np.frombuffer(payload, np.uint8, w * h).reshape(h, w)
        u = np.frombuffer(payload, np.uint8, cw * ch,
                          offset=w * h).reshape(ch, cw)
        v = np.frombuffer(payload, np.uint8, cw * ch,
                          offset=w * h + cw * ch).reshape(ch, cw)
        luma = len(rows) * len(cols)
        chroma = len(crows) * len(ccols)
        out[:luma] = y[rows][:, cols].ravel()
        out[luma:luma + chroma] = u[crows][:, ccols].ravel()
        out[luma + chroma:] = v[crows][:, ccols].ravel()

    def decode_clips_yuv(self, video: str, clip_starts: List[int],
                         consecutive_frames: int = 8,
                         width: int = DEFAULT_WIDTH,
                         height: int = DEFAULT_HEIGHT,
                         out: Optional[np.ndarray] = None) -> np.ndarray:
        """-> uint8 ``(num_clips, consecutive_frames, H*W*3//2)``: packed
        4:2:0 planes (Y, then U, then V per frame). Frames past the end
        repeat the last one. ``out``, when given, is filled in place
        (a row range of a staging slot)."""
        if width % 2 or height % 2:
            raise ValueError("packed 4:2:0 needs even geometry")
        meta = self._parse_header(video)
        if any(s < 0 for s in clip_starts):
            raise ValueError("negative clip start in %r" % (clip_starts,))
        packed = height * width * 3 // 2
        shape = (len(clip_starts), consecutive_frames, packed)
        if out is None:
            out = np.empty(shape, dtype=np.uint8)
        elif out.shape != shape or out.dtype != np.uint8:
            raise ValueError("decode target has shape %s %s, want %s uint8"
                             % (out.shape, out.dtype, shape))
        w, h, sub = meta["width"], meta["height"], meta["subsample"]
        maps = (np.arange(height) * h // height,
                np.arange(width) * w // width,
                np.arange(height // 2) * (h // sub) // (height // 2),
                np.arange(width // 2) * (w // sub) // (width // 2))
        with open(video, "rb") as f:
            for ci, start in enumerate(clip_starts):
                for fi in range(consecutive_frames):
                    idx = min(start + fi, meta["count"] - 1)
                    f.seek(meta["data_start"] + idx * meta["stride"]
                           + meta["marker_len"])
                    self._gather_frame_yuv(f.read(meta["frame_bytes"]),
                                           meta, maps, out[ci, fi])
        return out

    def decode_clips_dct(self, video, clip_starts, consecutive_frames=8,
                         width=DEFAULT_WIDTH, height=DEFAULT_HEIGHT,
                         coeffs=None):
        raise CorruptVideoError(
            "the dct pixel path needs an MJPEG container; %s is "
            "uncompressed y4m (no DCT coefficients to ship)" % video)


def _jpeg_frame_end(data: bytes, p: int) -> int:
    """Offset one past the frame's EOI, or 0 on a corrupt or truncated
    structure. ``data[p:]`` must start at an SOI."""
    n = len(data)
    p += 2  # SOI
    while p + 1 < n:
        if data[p] != 0xFF:
            return 0
        while p < n and data[p] == 0xFF:
            p += 1  # fill bytes
        if p >= n:
            return 0
        m = data[p]
        p += 1
        if m == 0xD9:
            return p  # EOI
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            continue  # TEM / RSTn: no length field
        if p + 2 > n:
            return 0
        length = (data[p] << 8) | data[p + 1]
        if length < 2 or p + length > n:
            return 0
        is_sos = m == 0xDA
        p += length
        if is_sos:
            # entropy-coded data: only here is FFD9 unambiguous
            while True:
                q = data.find(b"\xff", p)
                if q < 0 or q + 1 >= n:
                    return 0
                nm = data[q + 1]
                if nm == 0x00 or 0xD0 <= nm <= 0xD7:
                    p = q + 2  # stuffing / restart
                elif nm == 0xFF:
                    p = q + 1  # fill byte
                else:
                    p = q
                    break  # real marker: handled by the loop top
    return 0


def scan_mjpeg_frames(data: bytes):
    """``[(offset, length)]`` of the JPEG frames of an MJPEG byte
    stream. Walks the marker structure and skips length-prefixed
    segments whole (an APPn payload may embed a thumbnail's FFD9); a
    truncated trailing frame is dropped."""
    frames = []
    p = 0
    n = len(data)
    while p + 2 < n:
        if data[p] == 0xFF and data[p + 1] == 0xD8 and data[p + 2] == 0xFF:
            end = _jpeg_frame_end(data, p)
            if not end:
                break
            frames.append((p, end - p))
            p = end
        else:
            p += 1
    return frames


class MjpegDecoder:
    """MJPEG (.mjpg/.mjpeg: baseline JPEG frames back to back) to
    packed dequantized DCT coefficient rows, through the pure-Python
    entropy decoder — no pixel decode, so no PIL. Frames past the end
    repeat the last one, as on the pixel paths."""

    def decode_clips(self, video, clip_starts, consecutive_frames=8,
                     width=DEFAULT_WIDTH, height=DEFAULT_HEIGHT):
        raise CorruptVideoError(
            "the rgb pixel path of MJPEG files is not yet ported to "
            "rnb_tpu_torch (%s): serve them on the dct path" % video)

    decode_clips_yuv = decode_clips

    BACKEND = "mjpeg"

    def __init__(self):
        # the frame index only: bytes are re-read per call, so a long
        # many-video run does not hold every file in memory
        self._index = {}
        self._lock = threading.Lock()

    def _frames(self, video: str):
        with open(video, "rb") as f:
            data = f.read()
        with self._lock:
            frames = self._index.get(video)
        if frames is None:
            frames = scan_mjpeg_frames(data)
            if not frames:
                raise CorruptVideoError("%s contains no JPEG frames" % video)
            with self._lock:
                self._index[video] = frames
        return data, frames

    def num_frames(self, video: str) -> int:
        return len(self._frames(video)[1])

    def decode_clips_dct(self, video: str, clip_starts: List[int],
                         consecutive_frames: int = 8,
                         width: int = DEFAULT_WIDTH,
                         height: int = DEFAULT_HEIGHT,
                         coeffs: Optional[int] = None) -> np.ndarray:
        """int16 ``(num_clips, consecutive_frames, elems)`` wire rows.
        The source geometry must be the asked one (coefficients cannot
        be resized); a spectrum over the budget raises."""
        from rnb_tpu_torch.decode.jpeg_dct import jpeg_frame_dct
        from rnb_tpu_torch.ops.dct import dct_frame_elems, pack_frame_dct
        elems = dct_frame_elems(height, width, coeffs)
        data, frames = self._frames(video)
        count = len(frames)
        if any(s < 0 for s in clip_starts):
            raise ValueError("negative clip start in %r" % (clip_starts,))
        out = np.zeros((len(clip_starts), consecutive_frames, elems),
                       dtype=np.int16)
        last_idx = last_row = None
        for ci, start in enumerate(clip_starts):
            for fi in range(consecutive_frames):
                idx = min(start + fi, count - 1)
                if idx != last_idx:
                    off, length = frames[idx]
                    zz, w, h = jpeg_frame_dct(data[off:off + length])
                    if (w, h) != (width, height):
                        raise CorruptVideoError(
                            "%s is %dx%d but the dct path was asked "
                            "for %dx%d — coefficients cannot be "
                            "resized on the host" % (video, w, h,
                                                     width, height))
                    try:
                        last_row = pack_frame_dct(zz, height, width,
                                                  coeffs)
                    except ValueError as e:
                        raise CorruptVideoError(
                            "%s frame %d: %s" % (video, idx, e)) from e
                    last_idx = idx
                out[ci, fi] = last_row
        return out


def write_y4m(path: str, frames: np.ndarray,
              colorspace: str = "444") -> None:
    """Write ``(N, H, W, 3)`` uint8 RGB frames as a y4m file (RGB stored
    via inverse BT.601). ``colorspace="420"`` downsamples chroma with a
    2x2 box mean (geometry must be even)."""
    n, h, w, _ = frames.shape
    rgb = frames.astype(np.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = (b - y) / 1.772 + 128.0
    v = (r - y) / 1.402 + 128.0
    if colorspace == "420":
        if h % 2 or w % 2:
            raise ValueError("4:2:0 needs even geometry, got %dx%d"
                             % (h, w))
        u = u.reshape(n, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
        v = v.reshape(n, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
    elif colorspace != "444":
        raise ValueError("colorspace must be '444' or '420', got %r"
                         % (colorspace,))
    with open(path, "wb") as f:
        f.write(b"YUV4MPEG2 W%d H%d F25:1 Ip A1:1 C%s\n"
                % (w, h, colorspace.encode()))
        for i in range(n):
            f.write(b"FRAME\n")
            for plane in (y[i], u[i], v[i]):
                f.write(np.clip(plane, 0, 255).astype(np.uint8).tobytes())


#: one shared instance per backend, so per-video header and frame-index
#: caches survive across requests
_DECODERS = {"synth": SyntheticDecoder(), "y4m": Y4MDecoder(),
             "mjpeg": MjpegDecoder()}


def get_decoder(video: str):
    """The process-wide decoder for one video: ``synth://`` ids, ``.y4m``
    and ``.mjpg``/``.mjpeg`` files. Anything else raises."""
    if video.startswith(SYNTH_PREFIX):
        return _DECODERS["synth"]
    if video.endswith(".y4m"):
        return _DECODERS["y4m"]
    if video.endswith((".mjpg", ".mjpeg")):
        return _DECODERS["mjpeg"]
    raise CorruptVideoError(
        "no decode backend for %r: the port decodes synth:// ids, .y4m "
        "and .mjpg/.mjpeg files" % video)
