"""The port's dct pixel path against the JAX package, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX
functions (the jnp twin and the Pallas kernel in interpret mode, as
tests/test_dct.py runs them) and through ``rnb_tpu_torch``'s plain
versions, which the CUDA kernels are held to on the card:

* the wire helpers and the unpack, bitwise (well-formed and garbage
  rows);
* the fused convert, within one u8 step with at least 99% exact; pad
  rows exact;
* the synthetic and MJPEG coefficient decoders, byte for byte;
* ``R2P1DRunner(pixel_path="dct")`` against the JAX ``_shared_apply``
  on bridged weights.

Tolerances, with their reasons, are stated per test.
"""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnb_tpu.decode import MjpegPILDecoder as JaxMjpegDecoder
from rnb_tpu.decode import SyntheticDecoder as JaxSyntheticDecoder
from rnb_tpu.decode import scan_mjpeg_frames as jax_scan_mjpeg_frames
from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.models.r2p1d.model import _shared_apply
from rnb_tpu.ops import dct as jax_dct
from rnb_tpu_torch.config import load_config
from rnb_tpu_torch.decode import (CorruptVideoError, MjpegDecoder,
                                  SyntheticDecoder, Y4MDecoder, get_decoder,
                                  scan_mjpeg_frames, write_y4m)
from rnb_tpu_torch.devices import DeviceSpec
from rnb_tpu_torch.models.r2p1d.checkpoint import from_jax_variables
from rnb_tpu_torch.models.r2p1d.model import (R2P1DFusingLoader,
                                              R2P1DRunner,
                                              R2P1DVideoPathIterator)
from rnb_tpu_torch.models.r2p1d.network import (R2Plus1DClassifier,
                                                cast_compute_weights)
from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.ops import dct
from rnb_tpu_torch.parse_utils import read_meta
from rnb_tpu_torch.stage import PaddedBatch, RaggedBatch
from rnb_tpu_torch.telemetry import TimeCard
from test_torch_slice import _assert_logits_close, _randomize_bn

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = DeviceSpec(0, "cpu")
LS = (1, 1, 1, 1)
CLASSES = 10


#: Two float32 IDCTs that sum in different orders agree within one u8
#: step on each quantized plane (the reference's bound, rnb_tpu/ops/
#: dct.py:46-52): a one-ulp difference can flip floor(p + 128.5). BT.601
#: carries a one-step U or V flip into B or R as 1.772 or 1.402 steps,
#: so after the conversion the bound is two u8 steps. The reference's
#: own jnp twin and its Pallas kernel (interpret) differ by two steps on
#: 112x112 frames.
RGB_STEPS = 2
EXACT_SHARE = 0.99


def _u8(x) -> np.ndarray:
    """Normalized frames back to u8 steps: (x*255 + 255) / 2."""
    return np.round((np.asarray(x, np.float32) * 255.0 + 255.0) / 2.0)


def _well_formed(rows, frames, hw, seed, density=0.1):
    """Random well-formed wire rows: each block keeps a random subset of
    its 64 positions (any position, not only a zigzag prefix)."""
    rng = np.random.default_rng(seed)
    nb = dct.num_dct_blocks(hw, hw)
    pool = np.empty((rows, frames, dct.dct_frame_elems(hw, hw)), np.int16)
    for r in range(rows):
        for f in range(frames):
            zz = np.where(rng.random((nb, 64)) < density,
                          rng.integers(-900, 900, (nb, 64)), 0)
            pool[r, f] = dct.pack_frame_dct(zz, hw, hw)
    return pool


def _garbage(rows, frames, hw, seed):
    """Uninitialized-pool stand-in: any int16 anywhere, plus a second
    half whose counts and positions stay small enough that many kept
    entries land on one slot."""
    rng = np.random.default_rng(seed)
    nb = dct.num_dct_blocks(hw, hw)
    elems = dct.dct_frame_elems(hw, hw)
    coeffs = (elems - nb) // 2
    pool = rng.integers(-32768, 32768, (rows, frames, elems)).astype(np.int16)
    half = rows // 2
    pool[half:, :, :nb] = rng.integers(-3, 70, (rows - half, frames, nb))
    pool[half:, :, nb + coeffs:] = rng.integers(-9, 75,
                                                (rows - half, frames, coeffs))
    return pool


# -- wire helpers (own copies of the JAX package's) ---------------------

@pytest.mark.parametrize("h,w", [(112, 112), (32, 32), (48, 64)])
def test_wire_helpers_equal_the_reference(h, w):
    # tolerance: none — integer bookkeeping and float32 constants
    for name in ("num_dct_blocks", "default_dct_coeffs", "dct_frame_elems"):
        assert getattr(dct, name)(h, w) == getattr(jax_dct, name)(h, w)
    elems = dct.dct_frame_elems(h, w, coeffs=40)
    assert elems == jax_dct.dct_frame_elems(h, w, coeffs=40)
    assert dct.coeffs_from_elems(h, w, elems) == 40
    np.testing.assert_array_equal(dct.ZIGZAG_NATURAL, jax_dct.ZIGZAG_NATURAL)
    np.testing.assert_array_equal(dct._idct_basis8().view(np.int32),
                                  jax_dct._idct_basis8().view(np.int32))
    for ours, ref in zip(dct._plane_bases(h, w), jax_dct._plane_bases(h, w)):
        np.testing.assert_array_equal(ours.view(np.int32),
                                      ref.view(np.int32))
    rng = np.random.default_rng(h + w)
    nb = dct.num_dct_blocks(h, w)
    zz = np.where(rng.random((nb, 64)) < 0.05,
                  rng.integers(-2000, 2000, (nb, 64)), 0).astype(np.int16)
    wire = dct.pack_frame_dct(zz, h, w)
    np.testing.assert_array_equal(wire, jax_dct.pack_frame_dct(zz, h, w))
    np.testing.assert_array_equal(dct.unpack_frame_dct_numpy(wire, h, w), zz)
    for bad in (lambda m: m.pack_frame_dct(zz, h, w, coeffs=1),
                lambda m: m.coeffs_from_elems(h, w, nb + 1),
                lambda m: m.num_dct_blocks(h + 8, w)):
        with pytest.raises(ValueError):
            bad(dct)
        with pytest.raises(ValueError):
            bad(jax_dct)


def test_kernel_source_carries_the_basis_and_zigzag_bit_for_bit():
    # the CUDA kernel's constant tables are literals: they must be the
    # plain version's float32 basis and zigzag map exactly
    with open(os.path.join(_kernels.CSRC_DIR, "dct.cu")) as f:
        source = f.read()

    def table(name):
        body = re.search(r"%s\[64\] = \{(.*?)\};" % name, source, re.S)
        return [t.strip().rstrip("f") for t in body.group(1).split(",")
                if t.strip()]

    basis = np.array([np.float32(t) for t in table("kIdct8")], np.float32)
    np.testing.assert_array_equal(basis.view(np.int32),
                                  dct._idct_basis8().ravel().view(np.int32))
    np.testing.assert_array_equal(
        np.array([int(t) for t in table("kZigzagNatural")]),
        dct.ZIGZAG_NATURAL)
    # the MCU slab's slot of each zigzag position: line pitch 9
    np.testing.assert_array_equal(
        np.array([int(t) for t in table("kZigzagSlot")]),
        dct.ZIGZAG_NATURAL // 8 * 9 + dct.ZIGZAG_NATURAL % 8)


def test_bf16_normalize_in_one_fma_is_exact_for_every_level():
    # the kernels' bf16 epilogue computes (2q - 255) / 255 as one fused
    # multiply-add, fl(q * fl(2/255) - 1), where the plain version rounds
    # fl(2q - 255) * fl(1/255): the float32 values may differ, their bf16
    # roundings must not, for every quantized level q
    q = np.arange(256, dtype=np.float64)
    fused = (q * np.float64(np.float32(2.0 / 255.0)) - 1.0).astype(
        np.float32)  # exact in float64, then one rounding, as the FMA
    plain = (np.float32(2 * q - 255) * np.float32(1.0 / 255.0)).astype(
        np.float32)
    assert torch.equal(
        torch.from_numpy(fused).to(torch.bfloat16).view(torch.int16),
        torch.from_numpy(plain).to(torch.bfloat16).view(torch.int16))


# -- the unpack (jnp scatter fused by XLA on the TPU) -------------------

@pytest.mark.parametrize("hw", [32, 112])
@pytest.mark.parametrize("kind", ["well_formed", "garbage"])
def test_unpack_bitwise_equals_jax(hw, kind):
    # tolerance: none. Duplicate slots (garbage rows) resolve as last
    # entry wins in the port; XLA's CPU scatter gives the same answer
    make = _well_formed if kind == "well_formed" else _garbage
    pool = make(4, 2, hw, seed=hw)
    ours = dct.unpack_dct_rows(torch.from_numpy(pool), hw, hw)
    ref = jax_dct.unpack_dct_rows(jnp.asarray(pool), hw, hw)
    for o, r in zip(ours, ref):
        assert o.dtype == torch.int32
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_unpack_last_entry_wins_and_clamps():
    # one block, three entries on natural slot 0 (positions -5, 0, 0)
    # and one past the budget: the last kept entry wins
    hw = 16
    nb = dct.num_dct_blocks(hw, hw)
    coeffs = 4
    wire = np.zeros((1, 1, nb + 2 * coeffs), np.int16)
    wire[0, 0, 0] = 99          # count clamps to 64
    wire[0, 0, 1] = -7          # clamps to 0
    wire[0, 0, nb:nb + coeffs] = [11, 22, 33, 44]
    wire[0, 0, nb + coeffs:] = [-5, 0, 0, 200]
    y, u, v = dct.unpack_dct_rows_reference(torch.from_numpy(wire), hw, hw)
    assert y[0, 0, 0, 0] == 33 and y[0, 0, 7, 7] == 44   # pos 63 -> (7,7)
    assert int((y != 0).sum()) == 2 and not u.any() and not v.any()
    ref = jax_dct.unpack_dct_rows(jnp.asarray(wire), hw, hw)
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref[0]))


# -- the fused convert (Pallas kernel 3) --------------------------------

@pytest.mark.parametrize("hw", [32, 112])
@pytest.mark.parametrize("valid", [0, 2, 4])
def test_ragged_normalize_dct_within_idct_rounding_of_jax(hw, valid):
    # tolerance: RGB_STEPS with at least 99% exact. The port's plain
    # version computes op for op as the jnp twin does (bitwise here in
    # practice); the Pallas body (interpret) sums its matmuls in another
    # order. Pad rows exact zeros in all three
    pool = _well_formed(4, 2, hw, seed=valid)
    ours = dct.ragged_normalize_dct(torch.from_numpy(pool), valid, hw, hw,
                                    torch.float32).numpy()
    assert ours.shape == (4, 2, hw, hw, 3) and ours.dtype == np.float32
    for interpret in (False, True):
        ref = np.asarray(jax_dct.ragged_normalize_dct(
            jnp.asarray(pool), valid, hw, hw, dtype=jnp.float32,
            interpret=interpret))
        assert np.abs(_u8(ours) - _u8(ref)).max() <= RGB_STEPS
        assert (ours == ref).mean() >= EXACT_SHARE
        np.testing.assert_array_equal(ours[valid:], ref[valid:])
    assert not ours[valid:].any()


@pytest.mark.parametrize("hw", [32, 112])
@pytest.mark.parametrize("valid", [0, 2, 4])
def test_dct_ingest_reference_with_garbage_tail_within_idct_rounding_of_jax(
        hw, valid):
    # the port's CPU ragged ingest is dct_ingest_reference (bitwise),
    # held to the JAX ragged_normalize_dct -- the jnp twin and the Pallas
    # body in interpret mode -- within RGB_STEPS with at least 99% exact,
    # on a pool whose two tail rows are garbage (random int16, then small
    # counts and positions that put many entries on one slot): pad rows
    # exact zeros in all three
    pool = np.concatenate([_well_formed(4, 2, hw, seed=valid),
                           _garbage(2, 2, hw, seed=30 + valid)])
    ours = dct.ragged_normalize_dct(torch.from_numpy(pool), valid, hw, hw,
                                    torch.float32)
    assert torch.equal(ours, dct.dct_ingest_reference(
        torch.from_numpy(pool), valid, hw, hw, torch.float32))
    ours = ours.numpy()
    for interpret in (False, True):
        ref = np.asarray(jax_dct.ragged_normalize_dct(
            jnp.asarray(pool), valid, hw, hw, dtype=jnp.float32,
            interpret=interpret))
        assert np.abs(_u8(ours) - _u8(ref)).max() <= RGB_STEPS
        assert (ours == ref).mean() >= EXACT_SHARE
        np.testing.assert_array_equal(ours[valid:], ref[valid:])
    assert not ours[valid:].any()


def _c_parameters(kernel):
    """(C type, name) of each parameter of a kernel's C entry before
    (device, stream), read from its source."""
    with open(os.path.join(_kernels.CSRC_DIR, kernel.source)) as f:
        source = f.read()
    params = re.search(r"int %s\((.*?)\)\s*\{" % kernel.symbol, source,
                       re.S).group(1)
    out = [re.match(r"(.*?)\s*(\w+)$", " ".join(p.split())).groups()
           for p in params.split(",")]
    assert [name for _, name in out[-2:]] == ["device", "stream"]
    return out[:-2]


def test_dct_ingest_takes_rows_valid_as_a_device_pointer():
    params = _c_parameters(_kernels.DCT_INGEST)
    assert len(params) == len(_kernels.DCT_INGEST.argtypes)
    i = [name for _, name in params].index("rows_valid")
    assert params[i][0] == "const void*"
    assert _kernels.DCT_INGEST.argtypes[i] is ctypes.c_void_p


def test_no_kernel_takes_an_emission_rows_valid_by_value():
    # every kernel whose caller hands it the emission's rows_valid reads
    # it from device memory, so the launch arguments depend on the pool
    # shape alone. Two take it by value: rnb_dct_unpack, which no serving
    # path launches now (the tests' yardstick of rnb_dct_ingest), and
    # rnb_normalize_u8, whose serving entry normalize_u8 passes the row
    # count (ops/preprocess.py); the ragged rgb path has its own kernel
    by_value = []
    for kernel in _kernels.KERNELS:
        params = _c_parameters(kernel)
        assert len(params) == len(kernel.argtypes), kernel.name
        for (ctype, name), argtype in zip(params, kernel.argtypes):
            if name == "rows_valid" and (ctype != "const void*"
                                         or argtype is not ctypes.c_void_p):
                by_value.append(kernel.name)
    assert sorted(by_value) == ["dct_unpack", "normalize_u8"]


def test_normalize_dct_bucketed_pads_are_mid_gray():
    # the loader zeroes bucketed pad rows; zero coefficients decode to
    # planes of 128 -> RGB 128 -> 1/255 after the normalize, in both
    # packages; valid rows as in the ragged test
    hw = 32
    pool = _well_formed(3, 2, hw, seed=7)
    pool[2] = 0
    ours = dct.normalize_dct(torch.from_numpy(pool), hw, hw,
                             torch.float32).numpy()
    for interpret in (False, True):
        ref = np.asarray(jax_dct.normalize_dct(
            jnp.asarray(pool), hw, hw, dtype=jnp.float32,
            interpret=interpret))
        assert np.abs(_u8(ours) - _u8(ref)).max() <= RGB_STEPS
        assert (ours == ref).mean() >= EXACT_SHARE
    np.testing.assert_array_equal(ours[2], np.float32(1.0 / 255.0))
    bf16 = dct.normalize_dct(torch.from_numpy(pool), hw, hw)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, torch.from_numpy(ours).to(torch.bfloat16))


def test_garbage_pool_tail_never_reaches_valid_rows():
    hw = 32
    pool = _well_formed(3, 1, hw, seed=2)
    garbage = pool.copy()
    garbage[1:] = _garbage(2, 1, hw, seed=3)
    a = dct.ragged_normalize_dct(torch.from_numpy(pool), 1, hw, hw)
    b = dct.ragged_normalize_dct(torch.from_numpy(garbage), 1, hw, hw)
    assert torch.equal(a, b) and not b[1:].float().any()
    full = dct.normalize_dct(torch.from_numpy(garbage), hw, hw,
                             torch.float32)
    assert torch.isfinite(full).all() and full.abs().max() <= 1.0


# -- decoders -----------------------------------------------------------

def test_synthetic_decoder_byte_equal_to_jax():
    ours, ref = SyntheticDecoder(), JaxSyntheticDecoder()
    for video in ("synth://kinetics/video-0007", "synth://v1"):
        assert ours.num_frames(video) == ref.num_frames(video)
        starts = [0, 10, 57]
        a = ours.decode_clips_dct(video, starts, 4, 112, 112)
        assert a.dtype == np.int16
        np.testing.assert_array_equal(
            a, ref.decode_clips_dct(video, starts, 4, 112, 112))
        np.testing.assert_array_equal(
            ours.decode_clips_dct(video, [3], 2, 32, 32, coeffs=80),
            ref.decode_clips_dct(video, [3], 2, 32, 32, coeffs=80))
        np.testing.assert_array_equal(
            ours.decode_clips_yuv(video, starts, 2, 112, 112),
            ref.decode_clips_yuv(video, starts, 2, 112, 112))
    with pytest.raises(ValueError):
        ours.decode_clips_dct("synth://v", [0], 1, 112, 112, coeffs=10)


def _smooth_frames(n, hw=112, seed=5):
    """Moving gradients: a sparse, JPEG-friendly spectrum."""
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    t = np.arange(n, dtype=np.float32)[:, None, None]
    frames = np.empty((n, hw, hw, 3), np.uint8)
    for c in range(3):
        frames[..., c] = (127.5 * (1 + np.sin(
            2 * np.pi * (yy / hw + xx / hw) + phase[c] + 0.1 * t))
        ).astype(np.uint8)
    return frames


@pytest.fixture(scope="module")
def mjpeg_file(tmp_path_factory):
    """A 6-frame 112x112 MJPEG written by the JAX package (PIL)."""
    pytest.importorskip("PIL")
    from rnb_tpu.decode import write_mjpeg
    path = str(tmp_path_factory.mktemp("mjpeg") / "v.mjpg")
    write_mjpeg(path, _smooth_frames(6), quality=85)
    return path


def test_mjpeg_coefficients_bitwise_equal_to_jax(mjpeg_file):
    # tolerance: none — the same integer entropy decode
    ours, ref = MjpegDecoder(), JaxMjpegDecoder()
    assert ours.num_frames(mjpeg_file) == ref.num_frames(mjpeg_file) == 6
    with open(mjpeg_file, "rb") as f:
        data = f.read()
    assert scan_mjpeg_frames(data) == jax_scan_mjpeg_frames(data)
    assert scan_mjpeg_frames(data[:-10]) == jax_scan_mjpeg_frames(
        data[:-10])
    starts = [0, 3]  # the last clip runs past the end: repeats
    got = ours.decode_clips_dct(mjpeg_file, starts, 4, 112, 112)
    assert got.dtype == np.int16 and got.shape == (2, 4, 4704)
    np.testing.assert_array_equal(
        got, ref.decode_clips_dct(mjpeg_file, starts, 4, 112, 112))
    assert isinstance(get_decoder(mjpeg_file), MjpegDecoder)


def test_mjpeg_convert_within_one_step_of_numpy_oracle(mjpeg_file):
    # the reference's own bound between its float32 jnp twin and the
    # float64 numpy oracle on real JPEG content (tests/test_dct.py)
    wire = MjpegDecoder().decode_clips_dct(mjpeg_file, [0], 4, 112, 112)
    out = dct.normalize_dct(torch.from_numpy(wire[0][None]), 112, 112,
                            torch.float32).numpy()
    oracle = dct.dct_rows_to_rgb_numpy(wire, 112, 112)
    np.testing.assert_array_equal(
        oracle, jax_dct.dct_rows_to_rgb_numpy(wire, 112, 112))
    assert np.abs(_u8(out[0]) - oracle[0]).max() <= 1


def test_mjpeg_rejections(mjpeg_file, tmp_path):
    dec = MjpegDecoder()
    with pytest.raises(CorruptVideoError):
        dec.decode_clips_dct(mjpeg_file, [0], 1, 96, 96)   # no resize
    with pytest.raises(CorruptVideoError):
        dec.decode_clips_dct(mjpeg_file, [0], 1, 112, 112, coeffs=50)
    bad = tmp_path / "bad.mjpg"
    bad.write_bytes(b"\x00" * 64)
    with pytest.raises(CorruptVideoError):
        dec.num_frames(str(bad))
    y4m = str(tmp_path / "v.y4m")
    write_y4m(y4m, _smooth_frames(2), colorspace="420")
    with pytest.raises(CorruptVideoError):
        Y4MDecoder().decode_clips_dct(y4m, [0], 1, 112, 112)
    assert issubclass(CorruptVideoError, ValueError)
    assert isinstance(get_decoder("synth://x"), SyntheticDecoder)
    with pytest.raises(CorruptVideoError):
        get_decoder(str(tmp_path / "clip.mp4"))


def test_path_iterator_scans_mjpeg_and_falls_back_to_synth(tmp_path,
                                                           monkeypatch):
    monkeypatch.delenv("RNB_TPU_DATA_ROOT", raising=False)
    it = iter(R2P1DVideoPathIterator())
    first = [next(it) for _ in range(201)]
    assert first[0] == "synth://kinetics/video-0000"
    assert first[199] == "synth://kinetics/video-0199"
    assert first[200] == first[0]
    (tmp_path / "a").mkdir()
    for name in ("x.mjpg", "y.mjpeg", "z.y4m", "skip.txt"):
        (tmp_path / "a" / name).write_bytes(b"")
    it = iter(R2P1DVideoPathIterator(str(tmp_path)))
    assert sorted(os.path.basename(next(it)) for _ in range(3)) == [
        "x.mjpg", "y.mjpeg", "z.y4m"]


# -- stages -------------------------------------------------------------

@pytest.fixture(scope="module")
def bridged():
    """(JAX variables, the port's bf16 network on the same weights)."""
    variables = jax_ckpt.init_variables(seed=0, num_classes=CLASSES,
                                        layer_sizes=LS)
    variables = {k: _randomize_bn(dict(v), np.random.default_rng(1))
                 for k, v in variables.items()}
    net = R2Plus1DClassifier(1, 5, CLASSES, LS, dtype=torch.bfloat16)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    return variables, cast_compute_weights(net).eval()


def _synth_pool(rows):
    return SyntheticDecoder().decode_clips_dct(
        "synth://kinetics/video-0003", list(range(0, 9 * rows, 9)), 8,
        112, 112)


def test_runner_dct_bucketed_matches_jax_shared_apply(bridged):
    # logits bound as on the yuv420 path (tests/test_torch_slice.py)
    variables, net = bridged
    wire = _synth_pool(2)
    want = np.asarray(_shared_apply(1, 5, CLASSES, LS, pixel_path="dct")(
        variables, wire))
    runner = R2P1DRunner(CPU, num_classes=CLASSES, layer_sizes=LS,
                         max_rows=2, pixel_path="dct", num_warmups=1,
                         network=net)
    (out,), _, _ = runner((PaddedBatch(torch.from_numpy(wire), 2),),
                          None, None)
    assert isinstance(out, PaddedBatch) and out.valid == 2
    _assert_logits_close(out.data.numpy(), want)


def test_runner_dct_ragged_one_row_tiles_match_jax_shared_apply(bridged):
    variables, net = bridged
    pool = _synth_pool(3)
    pool[2] = np.random.default_rng(4).integers(
        -32768, 32768, pool[2].shape).astype(np.int16)  # garbage tail
    want = np.asarray(_shared_apply(1, 5, CLASSES, LS, pixel_path="dct",
                                    ragged=True, ragged_chunk=1)(
        variables, pool, np.int32(2)))
    runner = R2P1DRunner(CPU, num_classes=CLASSES, layer_sizes=LS,
                         max_rows=3, pixel_path="dct", num_warmups=0,
                         ragged=True, ragged_pool_rows=3,
                         ragged_chunk_rows=1, network=net)
    (out,), _, _ = runner((RaggedBatch(torch.from_numpy(pool), 2,
                                       (0, 1, 2)),), None, None)
    got = out.data.numpy()
    _assert_logits_close(got[:2], want[:2])
    assert not got[2].any() and not want[2].any()


def test_dct_coeffs_key_is_checked():
    with pytest.raises(ValueError, match="only applies"):
        R2P1DRunner(CPU, pixel_path="yuv420", dct_coeffs_per_frame=100,
                    num_warmups=0, layer_sizes=LS, num_classes=CLASSES)
    with pytest.raises(ValueError, match=">= 1"):
        R2P1DFusingLoader(CPU, pixel_path="dct", dct_coeffs_per_frame=0)
    shape = R2P1DFusingLoader.output_shape_for(
        max_clips=4, pixel_path="dct", dct_coeffs_per_frame=300)
    assert shape == ((4, 8, 294 + 600),)
    assert R2P1DFusingLoader.output_shape_for(
        max_clips=4, pixel_path="dct") == ((4, 8, 4704),)


@pytest.mark.parametrize("ragged", [False, True])
def test_fusing_loader_ships_int16_coefficient_rows(ragged):
    loader = R2P1DFusingLoader(CPU, fuse=2, max_clips=3, num_warmups=1,
                               row_buckets=[1, 3], pixel_path="dct",
                               ragged=ragged, ragged_pool_rows=3)
    cards = []
    for i in range(4):
        cards.append(TimeCard(i))
        cards[-1].video = "synth://kinetics/video-%04d" % i
    emissions = []
    for tc in cards:
        out = loader(None, tc.video, tc)
        if out[2] is not None:
            emissions.append(out)
    while True:
        out = loader.flush()
        if out is None:
            break
        emissions.append(out)
    seen = []
    for (batch,), _nt, tcs in emissions:
        assert batch.data.dtype == torch.int16
        assert batch.data.shape[1:] == (8, 4704)
        rows = batch.valid
        if not ragged:
            assert not batch.data[rows:].any()
        row = 0
        for tc in tcs.time_cards:
            want = SyntheticDecoder().decode_clips_dct(
                tc.video, loader._starts_cache[tc.video], 8, 112, 112)
            np.testing.assert_array_equal(
                batch.data[row:row + tc.num_clips].numpy(), want)
            row += tc.num_clips
            seen.append(tc.id)
    assert sorted(seen) == list(range(4))
    assert loader.ingest_stats == {"pixel_path": "dct",
                                   "backends": {"synth"}}
    snap = loader.staging.snapshot()
    assert snap["slot_bytes"] == 3 * 3 * 8 * 4704 * 2
    loader.discard_pending()


def test_dct_config_reads_and_log_meta_names_the_ingest(tmp_path):
    cfg = load_config(os.path.join(REPO, "configs/rnb-fused-dct-ragged.json"),
                      platform="cpu")
    assert [s.kwargs["pixel_path"] for s in cfg.steps] == ["dct", "dct"]
    meta = tmp_path / "log-meta.txt"
    meta.write_text('Args: {"config": "c"}\n1.0 2.0\nPixel path: dct\n'
                    "Decode backend: synth\nStaging: slots=3 "
                    "transfer_bytes=10\n")
    got = read_meta(str(meta))
    assert got["pixel_path"] == "dct" and got["decode_backend"] == "synth"
    assert got["lines"]["Staging"]["transfer_bytes"] == 10.0


# -- the wrappers off the card ------------------------------------------

def test_dct_wrappers_never_fall_back_and_cpu_launches_nothing():
    meta = torch.empty((2, 8, 4704), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError):
        dct.unpack_dct_rows(meta, 112, 112)
    with pytest.raises(ValueError):
        dct.ragged_normalize_dct(meta, 1, 112, 112)
    plane = torch.empty((1, 1, 32, 32), dtype=torch.int32, device="meta")
    half = torch.empty((1, 1, 16, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        dct.dct_convert(plane, half, half, 1, 32, 32)
    with pytest.raises(ValueError):
        dct.unpack_dct_rows(torch.zeros((1, 4704), dtype=torch.int16),
                            112, 112)                  # not (rows, F, E)
    with pytest.raises(ValueError):
        dct.normalize_dct(torch.zeros((1, 1, 4705), dtype=torch.int16),
                          112, 112)                    # not NB + 2C
    _kernels.reset_launches()
    dct.ragged_normalize_dct(torch.from_numpy(_well_formed(2, 1, 32, 0)),
                             1, 32, 32)
    assert not any(_kernels.launch_counts().values())
    assert _kernels._libraries == {}
