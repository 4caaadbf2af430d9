"""Build the native C++ decoder (``native/decode.cpp``) for the port.

The source is the repo's, compiled unchanged with the flags of
``native/Makefile`` into a shared library with a plain C interface,
loaded with ``ctypes`` by :mod:`rnb_tpu_torch.decode.native`. Like the
CUDA libraries of :mod:`rnb_tpu_torch.ops._kernels`, it lands in
``rnb_tpu_torch/_build/``, named by a hash of the source and the flags,
and is built at first use; nothing is built when this module is
imported. The compiler writes to a temporary file that is renamed into
place, so processes that build at once never load a half-written
library.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional, Tuple

from rnb_tpu_torch.ops._kernels import BUILD_DIR, PACKAGE_DIR

SOURCE = os.path.join(os.path.dirname(PACKAGE_DIR), "native", "decode.cpp")
#: ``native/Makefile``'s flags for ``librnb_decode.so``; -ffp-contract=off
#: keeps the colourspace arithmetic bitwise the numpy decoder's
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-ffp-contract=off",
             "-march=native", "-D_FILE_OFFSET_BITS=64", "-shared")

_lock = threading.Lock()
#: (seconds, compiler output) of the build this process ran, if any
BUILD_LOG: Optional[Tuple[float, str]] = None


def compiler() -> str:
    """``$CXX``, else ``g++`` on ``PATH``."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler: the native decoder is built "
                           "with g++ (or set CXX)")
    return cxx


def library_path() -> str:
    """Where the library lives: keyed by the source's bytes and the
    flags, so an edit rebuilds."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, "librnb_decode-%s.so"
                        % digest.hexdigest()[:16])


def build() -> Optional[float]:
    """Compile the library unless it is there. Returns the build's
    seconds, or None when nothing was built. Raises with the
    compiler's output when the build fails."""
    global BUILD_LOG
    with _lock:
        target = library_path()
        if os.path.exists(target):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "%s.%d.tmp" % (target, os.getpid())
        t0 = time.monotonic()
        proc = subprocess.run([compiler(), *CXX_FLAGS, SOURCE, "-o", tmp],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        seconds = time.monotonic() - t0
        BUILD_LOG = (seconds, proc.stdout)
        if proc.returncode != 0:
            raise RuntimeError("building the native decoder failed (exit "
                               "%d):\n%s" % (proc.returncode, proc.stdout))
        os.replace(tmp, target)
        return seconds
