"""Host-side video decode: y4m files -> packed 4:2:0 clip planes.

Counterpart of ``rnb_tpu/decode/__init__.py`` for the yuv420 pixel
path: :class:`Y4MDecoder` parses an uncompressed YUV4MPEG2 header and
gathers each requested frame's planes at the output geometry — pure
byte gathers, no colourspace arithmetic (that runs on the card,
``rnb_tpu_torch/ops/yuv.py``). numpy only; the output is byte-equal to
the JAX package's numpy decoder on the same file.

A file that cannot be decoded raises; the serving path lets that fail
the run loudly.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

import numpy as np

DEFAULT_WIDTH = 112
DEFAULT_HEIGHT = 112


class Y4MDecoder:
    """Uncompressed YUV4MPEG2 (.y4m) decode, 4:2:0 or 4:4:4 sources, to
    packed output-resolution 4:2:0 planes."""

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


_DECODER = Y4MDecoder()


def get_decoder(video: str) -> Y4MDecoder:
    """The process-wide decoder for one video path (one shared
    instance, so its per-video header cache survives across
    requests). Only ``.y4m`` files decode in this port so far."""
    if not video.endswith(".y4m"):
        raise ValueError("no decode backend for %r: the port decodes "
                         ".y4m files only" % video)
    return _DECODER
