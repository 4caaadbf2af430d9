"""ctypes binding of the native C++ decoder (``native/decode.cpp``).

Counterpart of ``rnb_tpu/decode/native.py``: a fused probe, decode,
convert and resize in C++ with its own worker pool, for ``.y4m`` and
baseline-JPEG ``.mjpg`` files (the library tells the containers apart
by their magic bytes). :class:`DecodePool` decodes into buffers the
caller owns (``submit_into``): the loaders plan each request's rows in
a pinned staging slot at submit time, and the pool decodes straight
into them. :class:`NativeY4MDecoder` is the synchronous decoder of the
same library behind :func:`rnb_tpu_torch.decode.get_decoder`.

The port builds the library itself from the repo's source
(:mod:`rnb_tpu_torch.ops._native`) at first use; a failed build raises
with the compiler's output. Every native decode releases the
interpreter lock for its whole length (ctypes), so decode threads never
hold up the runner thread.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional

import numpy as np

from rnb_tpu_torch.decode import (DEFAULT_HEIGHT, DEFAULT_WIDTH,
                                  CorruptVideoError, TransientDecodeError)
from rnb_tpu_torch.ops import _native
from rnb_tpu_torch.ops.dct import coeffs_from_elems, dct_frame_elems

_ERR_MSGS = {
    -1: "I/O error",
    -2: "not a y4m/mjpeg file / malformed stream (the dct path also "
        "needs an MJPEG container)",
    -3: "unsupported colourspace/sampling/geometry for this pixel "
        "format",
    -4: "bad argument",
    -5: "DCT spectrum exceeds the wire coefficient budget — raise "
        "dct_coeffs_per_frame or use pixel_path yuv420",
}

#: pixel formats of the native decoder (native/decode.cpp kPix*)
PIX_RGB = 0       # fused convert+resize -> (n, F, H, W, 3) u8
PIX_YUV420 = 1    # gather-only packed planes -> (n, F, H*W*3//2) u8
PIX_DCT = 2       # dequantized coefficients -> (n, F, elems) int16

_lib = None
_lib_lock = threading.Lock()

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_STARTS = ctypes.POINTER(ctypes.c_longlong)
#: symbol -> (restype, argtypes)
_SIGNATURES = {
    "rnb_video_probe": (_I, [ctypes.c_char_p, ctypes.POINTER(_I),
                             ctypes.POINTER(_I), ctypes.POINTER(_LL)]),
    "rnb_y4m_decode_clips_fmt": (_I, [ctypes.c_char_p, _STARTS, _I, _I, _I,
                                      _I, _I, _P]),
    "rnb_y4m_decode_clips_dct": (_I, [ctypes.c_char_p, _STARTS, _I, _I, _I,
                                      _I, _I, _P]),
    "rnb_pool_create": (_P, [_I]),
    "rnb_pool_destroy": (None, [_P]),
    "rnb_pool_submit_fmt": (_LL, [_P, ctypes.c_char_p, _STARTS, _I, _I,
                                  _I, _I, _I, _P]),
    "rnb_pool_submit_dct": (_LL, [_P, ctypes.c_char_p, _STARTS, _I, _I,
                                  _I, _I, _I, _P]),
    "rnb_pool_wait": (_I, [_P, _LL]),
    "rnb_pool_peek": (_I, [_P, _LL]),
}


def load_native() -> ctypes.CDLL:
    """The loaded library, built first if it is not there."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _native.build()
            lib = ctypes.CDLL(_native.library_path())
            for symbol, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, symbol)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def native_enabled() -> bool:
    """The reference's switch: ``RNB_DISABLE_NATIVE`` set sends ``.y4m``
    files to the numpy decoder (tests compare the two)."""
    return not os.environ.get("RNB_DISABLE_NATIVE")


def default_decode_threads() -> int:
    """The one decode-pool sizing rule: ``RNB_DECODE_THREADS``, else
    min(8, cores). The loaders' numpy decode threads use it too."""
    return int(os.environ.get("RNB_DECODE_THREADS",
                              min(8, os.cpu_count() or 1)))


def _check(rc: int, path: str) -> None:
    """Raise a native error code as a classified exception: -1 (a read
    failed) is transient, -2/-3/-5 (a malformed or unsupported stream, a
    spectrum over the budget) are permanent, -4 (a bad argument, a
    caller bug) a plain ValueError."""
    if rc == 0:
        return
    msg = ("native decode of %r failed: %s"
           % (path, _ERR_MSGS.get(rc, "error %d" % rc)))
    if rc == -1:
        raise TransientDecodeError(msg)
    if rc in (-2, -3, -5):
        raise CorruptVideoError(msg)
    raise ValueError(msg)


def _target_geometry(out: np.ndarray, clips: int, frames: int, pixfmt: int,
                     width: int, height: int) -> tuple:
    """Check a decode target for ``pixfmt`` -> (out_w, out_h, dct
    coefficient budget or 0)."""
    want_dtype = np.int16 if pixfmt == PIX_DCT else np.uint8
    if out.dtype != want_dtype or not out.flags["C_CONTIGUOUS"] \
            or out.shape[:2] != (clips, frames):
        raise ValueError("bad output buffer %r/%s for %d clips x %d "
                         "frames" % (out.shape, out.dtype, clips, frames))
    if pixfmt == PIX_RGB:
        if out.ndim != 5 or out.shape[4] != 3:
            raise ValueError("PIX_RGB wants (clips, frames, H, W, 3), got "
                             "%r" % (out.shape,))
        return out.shape[3], out.shape[2], 0
    if pixfmt == PIX_YUV420:
        if out.ndim != 3 or out.shape[2] != height * width * 3 // 2:
            raise ValueError("PIX_YUV420 wants (clips, frames, %d) for "
                             "%dx%d, got %r" % (height * width * 3 // 2,
                                                height, width, out.shape))
        return width, height, 0
    if pixfmt == PIX_DCT:
        if out.ndim != 3:
            raise ValueError("PIX_DCT wants (clips, frames, elems) int16, "
                             "got %r" % (out.shape,))
        return width, height, coeffs_from_elems(height, width, out.shape[2])
    raise ValueError("unknown pixfmt %r" % (pixfmt,))


class DecodePool:
    """The native worker pool: ``submit_into`` queues one decode into a
    caller's buffer and returns a ticket; ``peek`` asks whether it is
    done, ``wait`` retires it. One pool serves the process
    (:meth:`shared`)."""

    _shared = None
    _shared_lock = threading.Lock()

    def __init__(self, num_threads: Optional[int] = None):
        self._lib = load_native()
        if num_threads is None:
            num_threads = default_decode_threads()
        self.num_threads = int(num_threads)
        self._pool = self._lib.rnb_pool_create(self.num_threads)
        # ticket -> (out, starts): the buffers a worker writes into stay
        # alive until wait() retires the ticket
        self._pending = {}
        self._pending_lock = threading.Lock()

    @classmethod
    def shared(cls) -> "DecodePool":
        with cls._shared_lock:
            if cls._shared is None:
                cls._shared = cls()
            return cls._shared

    def submit(self, path: str, clip_starts: List[int],
               consecutive_frames: int, width: int, height: int):
        """-> (ticket, RGB out array); pass the ticket to :meth:`wait`."""
        out = np.empty((len(clip_starts), consecutive_frames, height,
                        width, 3), dtype=np.uint8)
        return self.submit_into(path, clip_starts, consecutive_frames,
                                out), out

    def submit_into(self, path: str, clip_starts: List[int],
                    consecutive_frames: int, out: np.ndarray,
                    pixfmt: int = PIX_RGB, width: int = DEFAULT_WIDTH,
                    height: int = DEFAULT_HEIGHT) -> int:
        """Decode into a caller's C-contiguous view: uint8 (clips,
        frames, H, W, 3) for PIX_RGB, uint8 (clips, frames, H*W*3//2)
        for PIX_YUV420, int16 (clips, frames, blocks + 2*C) for PIX_DCT
        (the budget C is read off the trailing axis). The caller must
        not read or free ``out`` before :meth:`wait` returns."""
        out_w, out_h, coeffs = _target_geometry(
            out, len(clip_starts), consecutive_frames, pixfmt, width,
            height)
        starts = (ctypes.c_longlong * len(clip_starts))(*clip_starts)
        if pixfmt == PIX_DCT:
            ticket = self._lib.rnb_pool_submit_dct(
                self._pool, path.encode(), starts, len(clip_starts),
                consecutive_frames, out_w, out_h, coeffs, out.ctypes.data)
        else:
            ticket = self._lib.rnb_pool_submit_fmt(
                self._pool, path.encode(), starts, len(clip_starts),
                consecutive_frames, out_w, out_h, pixfmt, out.ctypes.data)
        if ticket <= 0:
            raise RuntimeError("native pool rejected submit for %r" % path)
        with self._pending_lock:
            self._pending[ticket] = (out, starts)
        return ticket

    def peek(self, ticket: int) -> bool:
        """True when the ticket's decode has finished; does not retire
        it (pair with :meth:`wait`)."""
        with self._pending_lock:
            if ticket not in self._pending:
                raise ValueError("unknown or already-waited ticket %r"
                                 % (ticket,))
        return bool(self._lib.rnb_pool_peek(self._pool, ticket))

    def wait(self, ticket: int, path: str = "<submitted>") -> None:
        """Block until the ticket's decode is done and retire it; a
        decode error raises here. The ticket is claimed under the lock
        first: the native wait blocks forever on a retired ticket."""
        with self._pending_lock:
            buffers = self._pending.pop(ticket, None)
        if buffers is None:
            raise ValueError("unknown or already-waited ticket %r"
                             % (ticket,))
        _check(self._lib.rnb_pool_wait(self._pool, ticket), path)
        del buffers

    def close(self) -> None:
        if self._pool:
            self._lib.rnb_pool_destroy(self._pool)
            self._pool = None


#: one request fans out over the shared pool only past this many clips
POOL_SPLIT_MIN_CLIPS = 4


class NativeY4MDecoder:
    """The synchronous decoder of the native library, for ``.y4m`` and
    ``.mjpg`` files: one clip decodes on the calling thread, larger
    requests fan their clips out over the shared :class:`DecodePool`,
    each chunk into its own slice of the one output."""

    BACKEND = "native"

    def __init__(self):
        self._lib = load_native()
        self._count_cache = {}
        self._count_lock = threading.Lock()

    def num_frames(self, video: str) -> int:
        with self._count_lock:
            count = self._count_cache.get(video)
        if count is None:
            n = ctypes.c_longlong()
            _check(self._lib.rnb_video_probe(video.encode(), None, None,
                                             ctypes.byref(n)), video)
            count = int(n.value)
            with self._count_lock:
                self._count_cache[video] = count
        return count

    def _decode(self, video: str, clip_starts: List[int],
                consecutive_frames: int, out: np.ndarray, pixfmt: int,
                width: int, height: int) -> np.ndarray:
        if len(clip_starts) >= POOL_SPLIT_MIN_CLIPS:
            # every submitted ticket is waited, even after a failure:
            # an unwaited ticket would pin ``out`` in the pool
            pool = DecodePool.shared()
            chunk = max(1, -(-len(clip_starts) // pool.num_threads))
            tickets, first_error = [], None
            try:
                for lo in range(0, len(clip_starts), chunk):
                    hi = min(lo + chunk, len(clip_starts))
                    tickets.append(pool.submit_into(
                        video, clip_starts[lo:hi], consecutive_frames,
                        out[lo:hi], pixfmt, width, height))
            finally:
                for ticket in tickets:
                    try:
                        pool.wait(ticket, video)
                    except ValueError as e:
                        first_error = first_error or e
            if first_error is not None:
                raise first_error
            return out
        out_w, out_h, coeffs = _target_geometry(
            out, len(clip_starts), consecutive_frames, pixfmt, width,
            height)
        starts = (ctypes.c_longlong * len(clip_starts))(*clip_starts)
        if pixfmt == PIX_DCT:
            rc = self._lib.rnb_y4m_decode_clips_dct(
                video.encode(), starts, len(clip_starts),
                consecutive_frames, out_w, out_h, coeffs, out.ctypes.data)
        else:
            rc = self._lib.rnb_y4m_decode_clips_fmt(
                video.encode(), starts, len(clip_starts),
                consecutive_frames, out_w, out_h, pixfmt, out.ctypes.data)
        _check(rc, video)
        return out

    def decode_clips(self, video: str, clip_starts: List[int],
                     consecutive_frames: int = 8,
                     width: int = DEFAULT_WIDTH,
                     height: int = DEFAULT_HEIGHT) -> np.ndarray:
        """uint8 ``(clips, frames, H, W, 3)`` RGB frames."""
        out = np.empty((len(clip_starts), consecutive_frames, height,
                        width, 3), dtype=np.uint8)
        return self._decode(video, clip_starts, consecutive_frames, out,
                            PIX_RGB, width, height)

    def decode_clips_yuv(self, video: str, clip_starts: List[int],
                         consecutive_frames: int = 8,
                         width: int = DEFAULT_WIDTH,
                         height: int = DEFAULT_HEIGHT,
                         out: Optional[np.ndarray] = None) -> np.ndarray:
        """uint8 ``(clips, frames, H*W*3//2)`` packed 4:2:0 planes, into
        ``out`` when given (as the numpy decoder's)."""
        if width % 2 or height % 2:
            raise ValueError("packed 4:2:0 needs even geometry")
        if out is None:
            out = np.empty((len(clip_starts), consecutive_frames,
                            height * width * 3 // 2), dtype=np.uint8)
        return self._decode(video, clip_starts, consecutive_frames, out,
                            PIX_YUV420, width, height)

    def decode_clips_dct(self, video: str, clip_starts: List[int],
                         consecutive_frames: int = 8,
                         width: int = DEFAULT_WIDTH,
                         height: int = DEFAULT_HEIGHT,
                         coeffs=None) -> np.ndarray:
        """int16 ``(clips, frames, elems)`` packed dequantized
        coefficient rows (``rnb_tpu_torch/ops/dct.py``'s wire)."""
        out = np.empty((len(clip_starts), consecutive_frames,
                        dct_frame_elems(height, width, coeffs)),
                       dtype=np.int16)
        return self._decode(video, clip_starts, consecutive_frames, out,
                            PIX_DCT, width, height)
