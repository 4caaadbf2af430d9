"""Build and bind the port's hand-written CUDA kernels.

Each source under ``rnb_tpu_torch/csrc/`` is compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface and
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
Libraries land in ``rnb_tpu_torch/_build/``, named by a hash of the
source and the flags, and are built at first use; nothing is built
when this module is imported.

Every kernel is a :class:`Kernel`: its C symbol, argument types and a
plain integer ``launches`` count that goes up by one exactly where the
kernel is launched. Pointers and the stream are passed as
``c_void_p``; a non-zero CUDA error code from the launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence, Tuple

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
SOURCES = ("ingest.cu", "dct.cu", "pages.cu", "ragged.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}
#: source -> (seconds, compiler output) of the build this process ran
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default location, else whatever ``PATH`` finds."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit (set CUDA_HOME)")
    return found


def library_path(source: str) -> str:
    """Where the library built from ``source`` lives: keyed by the
    source's bytes and the flags, so an edit rebuilds."""
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, "lib%s-%s.so"
                        % (stem, digest.hexdigest()[:16]))


def build(sources: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all
    started together. Returns ``{source: seconds}`` for the builds run
    (an already-built source is absent). Raises with the compiler's
    output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs: List[tuple] = []
    for source in sources:
        target = library_path(source)
        if os.path.exists(target):
            continue
        tmp = "%s.%d.tmp" % (target, os.getpid())
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, source)]
        procs.append((source, target, tmp, time.monotonic(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT,
                                       text=True)))
    seconds = {}
    failures = []
    for source, target, tmp, t0, proc in procs:
        output, _ = proc.communicate()
        seconds[source] = time.monotonic() - t0
        BUILD_LOG[source] = (seconds[source], output)
        if proc.returncode != 0:
            failures.append("%s (exit %d):\n%s"
                            % (source, proc.returncode, output))
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


def _library(source: str) -> ctypes.CDLL:
    with _lock:
        lib = _libraries.get(source)
        if lib is None:
            build((source,))
            lib = ctypes.CDLL(library_path(source))
            lib.rnb_error_string.restype = ctypes.c_char_p
            lib.rnb_error_string.argtypes = [ctypes.c_int]
            _libraries[source] = lib
        return lib


class Kernel:
    """One CUDA kernel behind a C entry point of a csrc library."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        #: ctypes types of the arguments before (device, stream)
        self.argtypes = list(argtypes)
        #: the TPU kernel or op this kernel takes the place of
        self.replaces = replaces
        #: every ``file:line`` that ``replaces`` names
        self.replaced = tuple(re.findall(r"rnb_tpu/[\w/]+\.py:\d+",
                                         replaces))
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            fn = getattr(_library(self.source), self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes + [ctypes.c_int, ctypes.c_void_p]
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Launch on the current stream of the first tensor's device:
        tensors pass as their data pointers, everything else as is."""
        import torch
        fn = self._bind()
        device = next(a.device for a in args if isinstance(a, torch.Tensor))
        c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args]
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*c_args, device.index or 0, stream)
        if code != 0:
            message = _library(self.source).rnb_error_string(code)
            raise RuntimeError("kernel %s was not launched: CUDA error %d "
                               "(%s)" % (self.name, code,
                                         message.decode()))
        self.launches += 1


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

NORMALIZE_U8 = Kernel(
    "normalize_u8", "ingest.cu", "rnb_normalize_u8", [_P, _P, _L, _L, _L],
    "rnb_tpu/ops/preprocess.py:48 (_normalize_kernel via "
    "_normalize_u8_pallas)")
YUV420_TO_RGB_U8 = Kernel(
    "yuv420_to_rgb_u8", "ingest.cu", "rnb_yuv420_to_rgb_u8",
    [_P, _P, _P, _I, _I, _I, _I, _I],
    "rnb_tpu/ops/yuv.py:48 (yuv420_to_rgb_u8, jnp fused by XLA)")
YUV420_NORMALIZE = Kernel(
    "yuv420_normalize", "ingest.cu", "rnb_yuv420_normalize",
    [_P, _P, _P, _I, _I, _I, _I, _I, _I],
    "rnb_tpu/ops/yuv.py:48 (yuv420_to_rgb_u8, jnp fused by XLA) followed "
    "by rnb_tpu/ops/preprocess.py:48 (_normalize_kernel); ragged, "
    "rnb_tpu/ops/ragged.py:157 (_ragged_normalize_kernel)")
DCT_UNPACK = Kernel(
    "dct_unpack", "dct.cu", "rnb_dct_unpack",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I],
    "rnb_tpu/ops/dct.py:213 (unpack_dct_rows, jnp scatter fused by XLA)")
DCT_CONVERT = Kernel(
    "dct_convert", "dct.cu", "rnb_dct_convert",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I],
    "rnb_tpu/ops/dct.py:312 (_dct_kernel via _dct_convert_pallas)")
GATHER_ROWS = Kernel(
    "gather_rows", "pages.cu", "rnb_gather_rows",
    [_P, _P, _P, _P, _L, _L, _L],
    "rnb_tpu/ops/pages.py:92 (_gather_rows_kernel via _gather_rows_pallas)")

RAGGED_NORMALIZE_U8 = Kernel(
    "ragged_normalize_u8", "ragged.cu", "rnb_ragged_normalize_u8",
    [_P, _P, _P, _L, _L],
    "rnb_tpu/ops/ragged.py:157 (_ragged_normalize_kernel via "
    "_ragged_normalize_pallas)")

KERNELS = (NORMALIZE_U8, YUV420_TO_RGB_U8, YUV420_NORMALIZE, DCT_UNPACK,
           DCT_CONVERT, GATHER_ROWS, RAGGED_NORMALIZE_U8)


def reset_launches() -> None:
    for kernel in KERNELS:
        kernel.launches = 0


def launch_counts() -> Dict[str, int]:
    return {kernel.name: kernel.launches for kernel in KERNELS}
