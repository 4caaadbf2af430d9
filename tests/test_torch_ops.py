"""The port's ingest ops against the JAX package, on the CPU.

The same uint8 inputs, made from a seed with numpy, go through the
JAX functions (the Pallas kernels in interpret mode, as tests/test_ops.py
and tests/test_ragged.py run them, and the jnp references) and through
``rnb_tpu_torch``'s plain versions, which the CUDA kernels are held to
on the card. Tolerances, with their reasons, are stated per test.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rnb_tpu.decode import Y4MDecoder as JaxY4MDecoder
from rnb_tpu.decode import write_y4m as jax_write_y4m
from rnb_tpu.ops.preprocess import LANES, _normalize_kernel
from rnb_tpu.ops.preprocess import \
    normalize_u8_reference as jax_normalize_u8_reference
from rnb_tpu.ops.ragged import ragged_normalize_u8 as jax_ragged_normalize_u8
from rnb_tpu.ops.ragged import \
    ragged_normalize_yuv420 as jax_ragged_normalize_yuv420
from rnb_tpu.ops.yuv import normalize_yuv420 as jax_normalize_yuv420
from rnb_tpu.ops.yuv import yuv420_to_rgb_numpy
from rnb_tpu.ops.yuv import yuv420_to_rgb_u8 as jax_yuv420_to_rgb_u8
from rnb_tpu_torch.decode import Y4MDecoder, get_decoder, write_y4m
from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.ops.preprocess import (normalize_u8,
                                          normalize_u8_reference,
                                          normalize_u8_rows)
from rnb_tpu_torch.ops.ragged import (check_segment_offsets,
                                      ragged_mask_rows, ragged_normalize_u8,
                                      ragged_normalize_yuv420,
                                      resolve_pool_rows, segment_offsets_of)
from rnb_tpu_torch.ops.yuv import (normalize_yuv420, packed_frame_bytes,
                                   yuv420_to_rgb_u8)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(x) -> np.ndarray:
    """The raw bf16 bit patterns of a torch or jax array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _pallas_normalize(x, dtype, block_rows=8):
    """Pallas kernel 1 itself, in interpret mode (tests/test_ops.py)."""
    flat = jnp.asarray(x).reshape(-1, LANES)
    rows = flat.shape[0]
    out = pl.pallas_call(
        _normalize_kernel,
        out_shape=jax.ShapeDtypeStruct((rows, LANES), dtype),
        grid=(pl.cdiv(rows, block_rows),),
        in_specs=[pl.BlockSpec((block_rows, LANES), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((block_rows, LANES), lambda i: (i, 0)),
        interpret=True,
    )(flat)
    return out.reshape(x.shape)


# -- normalize (Pallas kernel 1) ---------------------------------------

@pytest.mark.parametrize("shape", [(2, 2, 16, 16, 3), (3, 8, 112, 8, 2),
                                   (1, 256)])
def test_normalize_u8_bitwise_equals_jax_reference(shape):
    # tolerance: none — one rounding from the same exact f32 term
    x = _u8(shape, seed=len(shape))
    ours = normalize_u8(torch.from_numpy(x))
    ref = jax_normalize_u8_reference(jnp.asarray(x), jnp.bfloat16)
    assert ours.dtype == torch.bfloat16 and ours.shape == x.shape
    np.testing.assert_array_equal(_bits(ours), _bits(ref))
    ours32 = normalize_u8_reference(torch.from_numpy(x), torch.float32)
    ref32 = jax_normalize_u8_reference(jnp.asarray(x), jnp.float32)
    np.testing.assert_array_equal(ours32.numpy(), np.asarray(ref32))


def test_normalize_u8_bitwise_equals_pallas_interpret():
    # tolerance: none at bf16 — the kernel body and the port both round
    # the same f32 value to bf16 once
    x = _u8((4, 8, 16, 16, 3), seed=3)
    got = _pallas_normalize(x, jnp.bfloat16)
    ours = normalize_u8(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(ours), _bits(got))
    every = np.arange(256, dtype=np.uint8).reshape(2, LANES)
    np.testing.assert_array_equal(
        _bits(normalize_u8(torch.from_numpy(every))),
        _bits(_pallas_normalize(every, jnp.bfloat16)))


def test_normalize_u8_endpoints_and_empty():
    x = torch.tensor([[0, 255]], dtype=torch.uint8)
    y = normalize_u8(x).float()
    assert y.tolist() == [[-1.0, 1.0]]
    empty = normalize_u8(torch.zeros((0, 8, LANES), dtype=torch.uint8))
    assert empty.shape == (0, 8, LANES) and empty.dtype == torch.bfloat16


@pytest.mark.parametrize("valid", [0, 1, 3, 5])
def test_ragged_normalize_u8_bitwise_and_pads_zero(valid):
    # tolerance: none — valid rows are the bucketed normalize; pad rows
    # are exactly zero in the reference's jnp path and its Pallas kernel
    pool = _u8((5, 2, 8, 8, 3), seed=11)
    ours = ragged_normalize_u8(torch.from_numpy(pool), valid)
    for interpret in (False, True):
        ref = jax_ragged_normalize_u8(jnp.asarray(pool), valid,
                                      interpret=interpret)
        np.testing.assert_array_equal(_bits(ours), _bits(ref))
    assert not ours[valid:].float().any()
    np.testing.assert_array_equal(
        _bits(ours[:valid]),
        _bits(normalize_u8(torch.from_numpy(pool[:valid]))))


def test_normalize_rows_clamps_rows_valid():
    pool = torch.from_numpy(_u8((3, 32), seed=2))
    assert torch.equal(normalize_u8_rows(pool, 7), normalize_u8(pool))
    assert not normalize_u8_rows(pool, -1).float().any()


# -- yuv420 colourspace (XLA-fused jnp on the TPU) ---------------------

def _packed(rows, frames, h, w, seed):
    return _u8((rows, frames, packed_frame_bytes(h, w)), seed=seed)


@pytest.mark.parametrize("h,w", [(112, 112), (16, 24)])
def test_yuv420_to_rgb_matches_numpy_oracle_and_jax(h, w):
    # tolerance: the port's plain version follows the numpy oracle's
    # float32 op order -> exact; the JAX converter lets XLA contract
    # into FMAs -> within one u8 step (yuv.py:23-29)
    x = _packed(2, 3, h, w, seed=h)
    ours = yuv420_to_rgb_u8(torch.from_numpy(x), h, w).numpy()
    assert ours.shape == (2, 3, h, w, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, yuv420_to_rgb_numpy(x, h, w))
    ref = np.asarray(jax_yuv420_to_rgb_u8(jnp.asarray(x), h, w))
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def test_normalize_yuv420_within_one_step_of_jax():
    # tolerance: one u8 step of the converter is 2/255 after the
    # normalize, plus one bf16 rounding at |y| <= 1 (2^-8)
    x = _packed(2, 2, 112, 112, seed=5)
    ours = normalize_yuv420(torch.from_numpy(x)).float().numpy()
    ref = np.asarray(jax_normalize_yuv420(jnp.asarray(x)), np.float32)
    assert ours.shape == ref.shape == (2, 2, 112, 112, 3)
    assert np.abs(ours - ref).max() <= 2.0 / 255.0 + 2.0 ** -8


@pytest.mark.parametrize("valid", [0, 2, 3])
def test_ragged_normalize_yuv420_pads_are_converted_zero_bytes(valid):
    # pad rows are NOT zero: the reference zeroes the u8 pool tail and
    # then converts it, giving RGB (0, 135, 0) -> (-1, 0.0588, -1);
    # tolerance on valid rows as in the bucketed test above, pad rows
    # exact
    h = w = 16
    pool = _packed(3, 2, h, w, seed=9)
    ours = ragged_normalize_yuv420(torch.from_numpy(pool), valid, h, w)
    ref = np.asarray(jax_ragged_normalize_yuv420(jnp.asarray(pool), valid,
                                                 h, w), np.float32)
    got = ours.float().numpy()
    assert np.abs(got - ref).max() <= 2.0 / 255.0 + 2.0 ** -8
    np.testing.assert_array_equal(got[valid:], ref[valid:])
    zero_rgb = normalize_yuv420(torch.zeros((1, 2, pool.shape[-1]),
                                            dtype=torch.uint8), h, w)
    for row in range(valid, 3):
        assert torch.equal(ours[row], zero_rgb[0])
    if valid < 3:
        pixel = got[valid, 0, 0, 0]
        np.testing.assert_allclose(pixel, [-1.0, 0.0588, -1.0], atol=2e-3)


def test_yuv_converter_masks_rows_past_rows_valid():
    pool = torch.from_numpy(_packed(3, 1, 8, 8, seed=1))
    masked = ragged_mask_rows(pool, 1)
    assert torch.equal(masked[:1], pool[:1]) and not masked[1:].any()
    assert torch.equal(yuv420_to_rgb_u8(pool, 8, 8, rows_valid=1),
                       yuv420_to_rgb_u8(masked, 8, 8))
    assert torch.equal(pool, torch.from_numpy(
        _packed(3, 1, 8, 8, seed=1)))  # the input is left as it was


def test_packed_frame_bytes_and_shape_checks():
    assert packed_frame_bytes(112, 112) == 18816
    with pytest.raises(ValueError):
        packed_frame_bytes(111, 112)
    with pytest.raises(ValueError):
        yuv420_to_rgb_u8(torch.zeros((1, 2, 100), dtype=torch.uint8), 8, 8)


# -- ragged bookkeeping (copied from the JAX package) ------------------

def test_ragged_bookkeeping_matches_reference():
    from rnb_tpu.ops import ragged as ref
    for counts in ([1], [3, 1, 2], [0, 4]):
        assert segment_offsets_of(counts) == ref.segment_offsets_of(counts)
        check_segment_offsets(segment_offsets_of(counts), sum(counts))
    for bad in ((1, 2), (0,), (0, 3, 2)):
        with pytest.raises(ValueError):
            check_segment_offsets(bad, 2)
    assert resolve_pool_rows(None, 15, "max_rows") == 15
    with pytest.raises(ValueError):
        resolve_pool_rows(12, 15, "max_rows")


# -- the kernel wrappers off the card ----------------------------------

def test_wrappers_never_fall_back_for_non_cpu_tensors():
    # a tensor that is neither on the CPU nor on a card gets an error,
    # never the plain version
    meta = torch.empty((2, 8, 18816), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        yuv420_to_rgb_u8(meta, 112, 112)
    with pytest.raises(ValueError):
        normalize_u8(meta)
    with pytest.raises(ValueError):
        ragged_normalize_u8(meta, 1)


def test_cpu_paths_launch_no_kernel_and_build_nothing():
    _kernels.reset_launches()
    x = torch.from_numpy(_packed(2, 2, 16, 16, seed=4))
    ragged_normalize_yuv420(x, 1, 16, 16)
    normalize_yuv420(x, 16, 16)
    ragged_normalize_u8(torch.from_numpy(_u8((3, 32), seed=5)), 2)
    assert _kernels.launch_counts() == {"normalize_u8": 0,
                                        "yuv420_to_rgb_u8": 0,
                                        "yuv420_normalize": 0,
                                        "dct_unpack": 0, "dct_convert": 0,
                                        "dct_ingest": 0,
                                        "gather_rows": 0,
                                        "ragged_normalize_u8": 0,
                                        "ring_shift": 0}
    assert _kernels._libraries == {}
    assert os.path.basename(_kernels.library_path("ingest.cu")).startswith(
        "libingest-")
    names = {k.name for k in _kernels.KERNELS}
    assert names == {"normalize_u8", "yuv420_to_rgb_u8", "yuv420_normalize",
                     "dct_unpack", "dct_convert", "dct_ingest",
                     "gather_rows",
                     "ragged_normalize_u8", "ring_shift"}
    assert {k.source for k in _kernels.KERNELS} == set(_kernels.SOURCES)


def test_kernel_source_exports_the_bound_symbols():
    for kernel in _kernels.KERNELS:
        with open(os.path.join(_kernels.CSRC_DIR, kernel.source)) as f:
            source = f.read()
        assert "int %s(" % kernel.symbol in source
        assert kernel.replaced[0] == kernel.replaces.split(" ")[0]
        for ref in kernel.replaced:
            path, line = ref.split(":")
            with open(os.path.join(REPO, path)) as f:
                assert f.read().splitlines()[int(line) - 1].startswith(
                    "def ")


# -- the decoder -------------------------------------------------------

@pytest.mark.parametrize("geom,cs", [((112, 112), "420"),
                                     ((48, 64), "420"),
                                     ((30, 40), "444")])
def test_decode_clips_yuv_byte_equal_to_jax_decoder(tmp_path, geom, cs):
    h, w = geom
    frames = _u8((12, h, w, 3), seed=h + w)
    path = str(tmp_path / "v.y4m")
    write_y4m(path, frames, colorspace=cs)
    ref_path = str(tmp_path / "ref.y4m")
    jax_write_y4m(ref_path, frames, colorspace=cs)
    with open(path, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()
    starts = [0, 3, 9]  # the last clip runs past the end: repeats
    ours = Y4MDecoder().decode_clips_yuv(path, starts, 8, 112, 112)
    ref = JaxY4MDecoder().decode_clips_yuv(path, starts, 8, 112, 112)
    np.testing.assert_array_equal(ours, ref)
    assert Y4MDecoder().num_frames(path) == 12
    target = np.empty_like(ours)
    get_decoder(path).decode_clips_yuv(path, starts, 8, 112, 112,
                                       out=target)
    np.testing.assert_array_equal(target, ref)


def test_decoder_rejects_bad_inputs(tmp_path):
    bad = tmp_path / "bad.y4m"
    bad.write_bytes(b"NOT A Y4M\n")
    with pytest.raises(ValueError):
        Y4MDecoder().num_frames(str(bad))
    with pytest.raises(ValueError):
        get_decoder(str(tmp_path / "clip.mp4"))


# -- the package stands alone ------------------------------------------

def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_flax_or_rnb_tpu():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "bench_cuda.py")]
    for dirpath, _dirs, names in os.walk(os.path.join(REPO,
                                                      "rnb_tpu_torch")):
        files.extend(os.path.join(dirpath, n) for n in names
                     if n.endswith(".py"))
    assert len(files) > 20
    for path in files:
        for module in _imported_modules(path):
            top = module.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "rnb_tpu"), (
                "%s imports %s" % (os.path.relpath(path, REPO), module))
