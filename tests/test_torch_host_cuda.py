"""The port's CUDA kernels, compiled for the host and run on the CPU.

``tests/host_cuda/`` emulates the CUDA subset the kernels use (threads,
barriers, warp votes, shared memory, the rounding intrinsics), so a
host C++ compiler builds ``rnb_tpu_torch/csrc/ingest.cu`` and
``dct.cu`` unchanged but for the launch syntax. The kernels then run on
CPU tensors through their C entry points and are held to the plain
versions: this checks their indexing, masking, vector and scalar paths
and arithmetic on the CPU. Speed, and races that only the card's
scheduling would expose, are the card's to show (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rnb_tpu_torch.decode import SyntheticDecoder
from rnb_tpu_torch.ops import _kernels, dct
from rnb_tpu_torch.ops.preprocess import normalize_u8_reference
from rnb_tpu_torch.ops.yuv import packed_frame_bytes, yuv420_to_rgb_reference

HERE = os.path.dirname(os.path.abspath(__file__))
_P, _I = ctypes.c_void_p, ctypes.c_int


def _build(source, out_dir):
    """Compile a csrc source with the host emulation: each launch
    ``k<<<g, b, s, st>>>(args);`` becomes ``host_launch(g, b, s, st,
    [&]{ k(args); });`` and a block's dynamic shared array a static."""
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("needs a host C++ compiler (g++)")
    with open(os.path.join(_kernels.CSRC_DIR, source)) as f:
        code = f.read()
    code = re.sub(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\((.*?)\);",
                  r"host_launch(\2, [&]{ \1(\3); });", code, flags=re.S)
    code = code.replace("extern __shared__ int smem[];",
                        "__shared__ int smem[1 << 16];")
    cpp = os.path.join(out_dir, source + ".cpp")
    with open(cpp, "w") as f:
        f.write(code)
    lib = os.path.join(out_dir, "lib%s.so" % source)
    subprocess.run([compiler, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-fPIC", "-shared", "-I", os.path.join(HERE, "host_cuda"),
                    "-o", lib, cpp, "-lpthread"], check=True,
                   capture_output=True)
    return ctypes.CDLL(lib)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("host_cuda"))
    built = {source: _build(source, out) for source in ("ingest.cu",
                                                         "dct.cu")}
    fns = {}
    for kernel in _kernels.KERNELS:
        if kernel.source in built:
            fn = getattr(built[kernel.source], kernel.symbol)
            fn.argtypes = kernel.argtypes + [_I, _P]  # device, stream
            fns[kernel.name] = fn
    return fns


def _ptr(t):
    return None if t is None else t.data_ptr()


def _scalar(valid):
    return None if valid is None else torch.tensor([valid],
                                                   dtype=torch.int32)


@pytest.mark.parametrize("valid", [None, 1, 0])
@pytest.mark.parametrize("rows,frames,h,w", [(3, 2, 16, 32), (2, 1, 112, 112),
                                             (3, 1, 10, 18), (2, 2, 6, 44)])
def test_yuv420_kernel_entries_equal_the_plain_versions(libs, rows, frames,
                                                        h, w, valid):
    # tolerance: none here (the host rounds as the plain version does);
    # widths 18 and 44 take the scalar path, 32 and 112 the vector path
    # with its warp-staged stores; rows_valid from the scalar, or null
    x = torch.from_numpy(np.random.default_rng(h * w + rows).integers(
        0, 256, (rows, frames, packed_frame_bytes(h, w)), dtype=np.uint8))
    masked = x.clone()
    masked[rows if valid is None else valid:] = 0
    want = yuv420_to_rgb_reference(masked, h, w)
    vector = int(w % 16 == 0)
    scalar = _scalar(valid)
    got = torch.empty_like(want)
    assert libs["yuv420_to_rgb_u8"](
        _ptr(x), _ptr(got), _ptr(scalar), rows, frames, h, w, vector, 0,
        None) == 0
    assert torch.equal(got, want)
    for dtype in (torch.bfloat16, torch.float32):
        out = torch.empty(want.shape, dtype=dtype)
        assert libs["yuv420_normalize"](
            _ptr(x), _ptr(out), _ptr(scalar), rows, frames, h, w, vector,
            int(dtype == torch.bfloat16), 0, None) == 0
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(out.view(bits),
                           normalize_u8_reference(want, dtype).view(bits))


def _wire(rows, frames, h, w, seed):
    """Synthetic spectra, random rows over all 64 positions, and a
    garbage row, as the card's tests use."""
    rng = np.random.default_rng(seed)
    nb = dct.num_dct_blocks(h, w)
    pool = np.empty((rows, frames, dct.dct_frame_elems(h, w)), np.int16)
    pool[0] = SyntheticDecoder().decode_clips_dct("synth://host", [0],
                                                  frames, h, w)[0]
    for r in range(1, rows - 1):
        for f in range(frames):
            zz = np.where(rng.random((nb, 64)) < 0.05,
                          rng.integers(-900, 900, (nb, 64)), 0)
            pool[r, f] = dct.pack_frame_dct(zz, h, w)
    pool[rows - 1] = rng.integers(-32768, 32768, pool[rows - 1].shape)
    return torch.from_numpy(pool)


@pytest.mark.parametrize("valid", [None, 2])
@pytest.mark.parametrize("h,w", [(32, 32), (48, 80), (16, 144)])
def test_dct_kernels_equal_the_plain_versions(libs, h, w, valid):
    # the unpack bitwise on the rows it writes; the convert within two
    # RGB steps with at least 99% exact (exact here), pad rows zero; 144
    # is not a multiple of the four MCUs a CTA takes
    rows, frames = 4, 2
    wire = _wire(rows, frames, h, w, seed=h + w)
    coeffs = dct.coeffs_from_elems(h, w, wire.shape[-1])
    n = rows if valid is None else valid
    want = dct.unpack_dct_rows_reference(wire, h, w)
    planes = [torch.zeros_like(p) for p in want]
    assert libs["dct_unpack"](
        _ptr(wire), *(_ptr(p) for p in planes), n, frames, h, w, coeffs, 0,
        None) == 0
    for got, ref in zip(planes, want):
        assert torch.equal(got[:n], ref[:n])
    for dtype in (torch.bfloat16, torch.float32):
        ref = dct.dct_convert_reference(*want, n, h, w, dtype)
        out = torch.full(ref.shape, 7.0, dtype=dtype)
        assert libs["dct_convert"](
            *(_ptr(p) for p in planes), _ptr(out), _ptr(_scalar(valid)),
            rows, frames, h, w, int(dtype == torch.bfloat16), 0, None) == 0
        steps = (torch.round((out.float() * 255 + 255) / 2)
                 - torch.round((ref.float() * 255 + 255) / 2)).abs()
        assert float(steps.max()) <= 2
        assert float((out == ref).double().mean()) >= 0.99
        assert not out[n:].float().any()
