"""The redesigned ingest entries against the JAX package, on the CPU.

The fused yuv420 entry (``yuv420_normalize``: convert and normalize in
one kernel on the card) and the u8 entry of the same kernel, and the
dct convert, whose kernels now read ``rows_valid`` from device memory.
The same inputs, made from a seed with numpy, go through the JAX
functions (jnp, and the Pallas kernels in interpret mode, as the JAX
package's own tests run them) and through ``rnb_tpu_torch``'s CPU
paths, which are the plain versions the CUDA kernels are held to on
the card. Tolerances, with their reasons, are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rnb_tpu.ops import dct as jax_dct
from rnb_tpu.ops.preprocess import LANES, _normalize_kernel
from rnb_tpu.ops.ragged import \
    ragged_normalize_yuv420 as jax_ragged_normalize_yuv420
from rnb_tpu.ops.yuv import normalize_yuv420 as jax_normalize_yuv420
from rnb_tpu.ops.yuv import yuv420_to_rgb_u8 as jax_yuv420_to_rgb_u8
from rnb_tpu_torch.ops import _kernels, dct
from rnb_tpu_torch.ops.preprocess import (rows_valid_int,
                                          rows_valid_pointer)
from rnb_tpu_torch.ops.ragged import ragged_mask_rows, ragged_normalize_yuv420
from rnb_tpu_torch.ops.yuv import (normalize_yuv420, packed_frame_bytes,
                                   yuv420_normalize, yuv420_to_rgb_u8)

torch.set_num_threads(2)

#: a small geometry whose width is a multiple of 16 (the kernel's
#: vector path on the card)
GEOMETRY = (16, 48)
#: one u8 step of the converter is 2/255 after the normalize, plus one
#: bf16 rounding at |y| <= 1 (2^-8); float32 out has no second rounding
#: beyond 2^-23
STEP_ATOL = {torch.bfloat16: 2.0 / 255.0 + 2.0 ** -8,
             torch.float32: 2.0 / 255.0 + 2.0 ** -20}
JNP_DTYPE = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
#: the dct convert: two float32 IDCT summation orders agree within one
#: u8 step per quantized plane, which BT.601 carries into two RGB steps
#: (tests/test_torch_dct.py), with at least 99% of outputs exact
RGB_STEPS = 2
EXACT_SHARE = 0.99


def _packed(rows, frames, h, w, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (rows, frames, packed_frame_bytes(h, w)), dtype=np.uint8)


def _pallas_normalize(x, dtype):
    """The Pallas normalize kernel itself, in interpret mode (as
    tests/test_ops.py runs it), over a few large blocks."""
    flat = jnp.asarray(x).reshape(-1, LANES)
    rows = flat.shape[0]
    block = pl.cdiv(rows, 4)
    out = pl.pallas_call(
        _normalize_kernel,
        out_shape=jax.ShapeDtypeStruct((rows, LANES), dtype),
        grid=(pl.cdiv(rows, block),),
        in_specs=[pl.BlockSpec((block, LANES), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((block, LANES), lambda i: (i, 0)),
        interpret=True,
    )(flat)
    return out.reshape(x.shape)


def _as_float(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _form(valid, form):
    """``valid`` as the wrappers take it: a host int or a 1-element
    int32 tensor on the pool's device (here the CPU)."""
    if form == "int":
        return valid
    return torch.tensor([valid], dtype=torch.int32)


# -- the fused yuv420 entry --------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,valid", [(48, 48), (48, 5), (48, 0),
                                        (15, 15), (15, 5), (15, 0)])
def test_fused_entry_matches_jax_convert_then_pallas_normalize(rows, valid,
                                                               dtype):
    # the JAX route on the CPU: the pool masked at the u8 level (as
    # ragged_normalize_yuv420 does), the jnp converter, then the Pallas
    # normalize in interpret mode. Tolerance: the u8 converter within
    # one step (XLA contracts into FMAs), so STEP_ATOL after the
    # normalize; pad rows exact
    h, w = GEOMETRY
    pool = _packed(rows, 2, h, w, seed=rows + valid)
    ours = yuv420_normalize(torch.from_numpy(pool), h, w, valid, dtype)
    assert ours.dtype == dtype and ours.shape == (rows, 2, h, w, 3)
    masked = jnp.asarray(ragged_mask_rows(torch.from_numpy(pool), valid)
                         .numpy())
    rgb = jax_yuv420_to_rgb_u8(masked, h, w)
    ref = _as_float(_pallas_normalize(rgb, JNP_DTYPE[dtype]))
    got = _as_float(ours)
    assert np.abs(got - ref).max() <= STEP_ATOL[dtype]
    np.testing.assert_array_equal(got[valid:], ref[valid:])
    # and the u8 entry against the JAX converter itself
    u8 = yuv420_to_rgb_u8(torch.from_numpy(pool), h, w, valid).numpy()
    assert np.abs(u8.astype(int) - np.asarray(rgb).astype(int)).max() <= 1
    np.testing.assert_array_equal(u8[valid:], np.asarray(rgb)[valid:])


@pytest.mark.parametrize("form", ["int", "device scalar"])
@pytest.mark.parametrize("rows,valid", [(48, 48), (48, 5), (48, 0),
                                        (15, 15), (15, 5), (15, 0)])
def test_ragged_entry_matches_jax_ragged_normalize_yuv420(rows, valid,
                                                          form):
    # tolerance as above; pad rows are the conversion of zero bytes —
    # (-1, 0.0588, -1) — exactly as the JAX function makes them
    h, w = GEOMETRY
    pool = _packed(rows, 1, h, w, seed=3 * rows + valid)
    ours = ragged_normalize_yuv420(torch.from_numpy(pool),
                                   _form(valid, form), h, w)
    ref = _as_float(jax_ragged_normalize_yuv420(jnp.asarray(pool), valid,
                                                h, w))
    got = _as_float(ours)
    assert np.abs(got - ref).max() <= STEP_ATOL[torch.bfloat16]
    np.testing.assert_array_equal(got[valid:], ref[valid:])
    if valid < rows:
        np.testing.assert_allclose(got[valid:, 0, 0, 0], np.tile(
            [-1.0, 0.0588, -1.0], (rows - valid, 1)), atol=2e-3)


@pytest.mark.parametrize("h,w", [(112, 112), (16, 48), (66, 90), (10, 18)])
def test_bucketed_entry_matches_jax_normalize_yuv420(h, w):
    # every row converted (the bucketed path); widths 90 and 18 are not
    # multiples of 16 and take the kernel's scalar path on the card;
    # tolerance as above
    x = _packed(2, 2, h, w, seed=h * w)
    ours = normalize_yuv420(torch.from_numpy(x), h, w)
    ref = _as_float(jax_normalize_yuv420(jnp.asarray(x), h, w))
    assert ours.shape == (2, 2, h, w, 3)
    assert np.abs(_as_float(ours) - ref).max() <= STEP_ATOL[torch.bfloat16]
    assert torch.equal(ours, yuv420_normalize(torch.from_numpy(x), h, w))


@pytest.mark.parametrize("h,w", [(112, 112), (66, 90)])
@pytest.mark.parametrize("valid", [3, 1])
def test_u8_entry_within_one_step_of_jax_converter(h, w, valid):
    # tolerance: the port follows the numpy op order, the JAX converter
    # lets XLA contract into FMAs: within one u8 step; pad rows exact
    pool = _packed(3, 1, h, w, seed=valid)
    ours = yuv420_to_rgb_u8(torch.from_numpy(pool), h, w, valid).numpy()
    masked = pool.copy()
    masked[valid:] = 0
    ref = np.asarray(jax_yuv420_to_rgb_u8(jnp.asarray(masked), h, w))
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    np.testing.assert_array_equal(ours[valid:], ref[valid:])


# -- rows_valid: an int or a device scalar ------------------------------

@pytest.mark.parametrize("rows_valid,expect", [
    (None, 4), (7, 4), (4, 4), (2, 2), (-1, 0),
    (torch.tensor([2], dtype=torch.int32), 2),
    (torch.tensor([9], dtype=torch.int32), 4)])
def test_rows_valid_forms_agree(rows_valid, expect):
    # None, an int (clamped to [0, rows]) and a device int32 scalar all
    # mean the same rows; the kernels get a null pointer (no fill) for
    # every row given as None or an int
    h, w = GEOMETRY
    pool = torch.from_numpy(_packed(4, 1, h, w, seed=11))
    assert rows_valid_int(rows_valid, 4, pool.device) == expect
    want = normalize_yuv420(ragged_mask_rows(pool, expect), h, w)
    assert torch.equal(yuv420_normalize(pool, h, w, rows_valid), want)
    assert torch.equal(yuv420_to_rgb_u8(pool, h, w, rows_valid),
                       yuv420_to_rgb_u8(ragged_mask_rows(pool, expect),
                                        h, w))
    pointer = rows_valid_pointer(rows_valid, 4, pool.device)
    if isinstance(rows_valid, torch.Tensor):
        assert pointer is rows_valid
    elif rows_valid is None or rows_valid >= 4:
        assert pointer is None
    else:
        assert pointer.dtype == torch.int32 and pointer.numel() == 1
        assert int(pointer) == max(0, rows_valid)


BAD_SCALARS = {
    "int64": torch.tensor([1], dtype=torch.int64),
    "float32": torch.tensor([1.0]),
    "int16": torch.tensor([1], dtype=torch.int16),
    "two elements": torch.tensor([1, 2], dtype=torch.int32),
    "empty": torch.zeros((0,), dtype=torch.int32),
}


def _yuv_call(entry):
    h, w = GEOMETRY
    pool = torch.from_numpy(_packed(3, 1, h, w, seed=2))
    if entry == "yuv420_to_rgb_u8":
        return lambda rv: yuv420_to_rgb_u8(pool, h, w, rv)
    if entry == "yuv420_normalize":
        return lambda rv: yuv420_normalize(pool, h, w, rv)
    if entry == "ragged_normalize_yuv420":
        return lambda rv: ragged_normalize_yuv420(pool, rv, h, w)
    wire = torch.from_numpy(_well_formed(3, 1, 32, 2))
    if entry == "ragged_normalize_dct":
        return lambda rv: dct.ragged_normalize_dct(wire, rv, 32, 32)
    planes = dct.unpack_dct_rows(wire, 32, 32)
    return lambda rv: dct.dct_convert(*planes, rv, 32, 32)


@pytest.mark.parametrize("entry", ["yuv420_to_rgb_u8", "yuv420_normalize",
                                   "ragged_normalize_yuv420", "dct_convert",
                                   "ragged_normalize_dct"])
@pytest.mark.parametrize("bad", sorted(BAD_SCALARS))
def test_wrappers_reject_a_rows_valid_of_wrong_dtype_or_shape(entry, bad):
    call = _yuv_call(entry)
    call(1)
    call(torch.tensor([1], dtype=torch.int32))
    with pytest.raises(ValueError):
        call(BAD_SCALARS[bad])


@pytest.mark.parametrize("entry", ["yuv420_to_rgb_u8", "yuv420_normalize"])
def test_yuv420_entries_never_fall_back_off_the_cpu(entry):
    # a tensor that is neither on the CPU nor on a card gets an error,
    # never the plain version; a bad plane size is refused first
    meta = torch.empty((2, 8, 18816), dtype=torch.uint8, device="meta")
    fn = yuv420_to_rgb_u8 if entry == "yuv420_to_rgb_u8" else \
        yuv420_normalize
    with pytest.raises(ValueError):
        fn(meta, 112, 112)
    with pytest.raises(ValueError):
        fn(meta, 112, 112, torch.tensor([1], dtype=torch.int32))
    with pytest.raises(ValueError):
        fn(torch.zeros((1, 2, 100), dtype=torch.uint8), 8, 8)


# -- the dct convert ---------------------------------------------------

def _well_formed(rows, frames, hw, seed, density=0.05):
    rng = np.random.default_rng(seed)
    h, w = (hw, hw) if isinstance(hw, int) else hw
    nb = dct.num_dct_blocks(h, w)
    pool = np.empty((rows, frames, dct.dct_frame_elems(h, w)), np.int16)
    for r in range(rows):
        for f in range(frames):
            zz = np.where(rng.random((nb, 64)) < density,
                          rng.integers(-900, 900, (nb, 64)), 0)
            pool[r, f] = dct.pack_frame_dct(zz, h, w)
    return pool


def _u8_steps(x) -> np.ndarray:
    return np.round((np.asarray(x, np.float32) * 255.0 + 255.0) / 2.0)


@pytest.mark.parametrize("form", ["int", "device scalar"])
@pytest.mark.parametrize("h,w", [(32, 32), (16, 48)])
@pytest.mark.parametrize("valid", [3, 2, 0])
def test_dct_convert_matches_jax_pallas_interpret(h, w, valid, form):
    # the convert's CPU path against the JAX package's
    # _dct_convert_pallas in interpret mode on the JAX unpack of the
    # same wire rows: RGB_STEPS with at least EXACT_SHARE exact; pad
    # rows exact zeros
    pool = _well_formed(3, 2, (h, w), seed=h + w + valid)
    planes = dct.unpack_dct_rows(torch.from_numpy(pool), h, w)
    ours = dct.dct_convert(*planes, _form(valid, form), h, w,
                           torch.float32).numpy()
    jplanes = jax_dct.unpack_dct_rows(jnp.asarray(pool), h, w)
    for got, want in zip(planes, jplanes):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref = np.asarray(jax_dct._dct_convert_pallas(
        *jplanes, valid, h, w, jnp.float32, interpret=True))
    assert ours.shape == ref.shape == (3, 2, h, w, 3)
    assert np.abs(_u8_steps(ours) - _u8_steps(ref)).max() <= RGB_STEPS
    assert (ours == ref).mean() >= EXACT_SHARE
    np.testing.assert_array_equal(ours[valid:], ref[valid:])
    assert not ours[valid:].any()


# -- the registry ------------------------------------------------------

def test_fused_entry_is_registered_with_its_own_counter():
    kernel = _kernels.YUV420_NORMALIZE
    assert kernel in _kernels.KERNELS and kernel.source == "ingest.cu"
    assert kernel.symbol == "rnb_yuv420_normalize"
    assert kernel.replaced == ("rnb_tpu/ops/yuv.py:48",
                               "rnb_tpu/ops/preprocess.py:48",
                               "rnb_tpu/ops/ragged.py:157")
    _kernels.reset_launches()
    h, w = GEOMETRY
    yuv420_normalize(torch.from_numpy(_packed(2, 1, h, w, seed=0)), h, w, 1)
    assert not any(_kernels.launch_counts().values())
    assert "yuv420_normalize" in _kernels.launch_counts()
