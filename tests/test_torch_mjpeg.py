"""MJPEG in the port: its own encoder, the PIL fallback decoder, the
dataset's MJPEG mode and MJPEG served on every path, against the JAX
package on the CPU.

* ``write_mjpeg`` (``rnb_tpu_torch/decode/mjpeg_encode.py``, numpy, no
  PIL): every frame decodes, through the port's ``jpeg_frame_dct`` and
  the JAX package's, to exactly the encoder's own quantized coefficients
  times the tables (q 70, 75, 90); its DQT segments are PIL's bytes; PIL
  opens every frame; smooth content comes back within the reference's
  round-trip bound of 8. Measured against PIL's own files for the same
  frames: the files are equal byte for byte (0 coefficients differ, the
  largest pixel difference is 0), at 112x112 and at geometries that are
  not whole MCUs, and that is what is held. The coefficient decoders
  refuse a geometry that is not a multiple of 16 (both with one
  message), so there the byte equality and the native decode hold the
  encoder.
* ``MjpegPILDecoder`` is the JAX package's fallback, bitwise: rgb,
  yuv420 and dct, frames past the end, the corrupt-file classes, on the
  port's files and on PIL's; without PIL a pixel decode raises an error
  naming PIL.
* The native decode of the port's files equals the JAX package's native
  decode bitwise (where its library is built) and stays within the
  reference's bounds of the PIL fallback (``tests/test_mjpeg.py``).
* The dataset's MJPEG mode writes the reference generator's frames and
  refuses a frame over the dct budget.
* A served run over a small MJPEG tree on the dct, yuv420 and rgb paths,
  through both packages' ``run_benchmark``: the port's logits held to
  the JAX stages' within the bound of ``tests/test_torch_slice.py``.
"""

import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax

from rnb_tpu import telemetry as jax_telemetry
from rnb_tpu.benchmark import run_benchmark as jax_run_benchmark
from rnb_tpu.decode import MjpegPILDecoder as JaxMjpegPILDecoder
from rnb_tpu.decode import write_mjpeg as jax_write_mjpeg
from rnb_tpu.decode.jpeg_dct import jpeg_frame_dct as jax_jpeg_frame_dct
from rnb_tpu.decode.native import NativeY4MDecoder as JaxNativeDecoder
from rnb_tpu.decode.native import native_available as jax_native_available
from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.models.r2p1d import model as jax_model
from rnb_tpu_torch.benchmark import run_benchmark
from rnb_tpu_torch.dataset import (DCT_QUALITY, make_dataset,
                                   synth_frames, write_mjpeg_checked)
from rnb_tpu_torch.decode import (CorruptVideoError, MjpegPILDecoder,
                                  get_decoder, scan_mjpeg_frames,
                                  write_mjpeg)
from rnb_tpu_torch.decode import native
from rnb_tpu_torch.decode.jpeg_dct import jpeg_frame_dct
from rnb_tpu_torch.decode.mjpeg_encode import (ZIGZAG_NATURAL,
                                               encode_frames, quant_tables)
from rnb_tpu_torch.models.r2p1d import model as port_model
from rnb_tpu_torch.models.r2p1d.checkpoint import (filter_layer_range,
                                                   from_jax_variables)
from rnb_tpu_torch.models.r2p1d.network import (R2Plus1DClassifier,
                                                cast_compute_weights)
from rnb_tpu_torch.ops import _native
from rnb_tpu_torch.ops.dct import default_dct_coeffs

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

from make_dataset import synth_frames as jax_synth_frames  # noqa: E402
from torch_job_checks import assert_both_checks_pass  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 112
QUALITIES = (70, 75, 90)
#: even geometries (H, W) that are not whole 16x16 MCUs: a dummy block
#: column and row (104 x 88), and partial blocks as well (66 x 90)
PARTIAL = ((104, 88), (66, 90))
#: the served runs' reduced pipeline (tests/test_torch_slice.py's)
LS = (1, 1, 1, 1)
CLASSES = 10
REQUESTS = 8


def _noise(n, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


def _frames(h=HW, w=HW, seed=1):
    """The generator's content and two frames of noise (a dense
    spectrum: ZRL runs, every magnitude category, stuffed bytes)."""
    return np.concatenate([synth_frames(4, h, w, seed=[seed, h, w]),
                           _noise(2, h, w, seed)])


def _pil_jpeg(frame, quality):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(frame, "RGB").save(buf, "JPEG", quality=quality,
                                       subsampling=2)
    return buf.getvalue()


def _pil_rgb(jpeg):
    from PIL import Image
    with Image.open(io.BytesIO(jpeg)) as im:
        return np.asarray(im.convert("RGB"))


def _segments(jpeg, marker):
    """The payloads of every ``marker`` segment before SOS."""
    out, p = [], 2
    while jpeg[p + 1] != 0xDA:
        length = (jpeg[p + 2] << 8) | jpeg[p + 3]
        if jpeg[p + 1] == marker:
            out.append(jpeg[p + 4:p + 2 + length])
        p += 2 + length
    return out


def _dequantized(zz, quality, h, w):
    """The encoder's quantized zig-zag coefficients times their tables,
    as a coefficient decoder returns them."""
    luma, chroma = quant_tables(quality)
    ny = (h // 8) * (w // 8)
    q = np.concatenate([np.tile(luma[ZIGZAG_NATURAL], (ny, 1)),
                        np.tile(chroma[ZIGZAG_NATURAL],
                                (zz.shape[0] - ny, 1))])
    return zz.astype(np.int64) * q


# -- the encoder -------------------------------------------------------

@pytest.mark.parametrize("quality", QUALITIES)
def test_frames_decode_to_the_encoders_coefficients(quality):
    # tolerance: none — integer entropy decode of integer coefficients
    jpegs, zz = encode_frames(_frames(), quality)
    assert zz.shape == (6, 294, 64) and zz.dtype == np.int16
    for jpeg, coeffs in zip(jpegs, zz):
        want = _dequantized(coeffs, quality, HW, HW)
        ours, w, h = jpeg_frame_dct(jpeg)
        theirs, w2, h2 = jax_jpeg_frame_dct(jpeg)
        assert (w, h) == (w2, h2) == (HW, HW)
        np.testing.assert_array_equal(ours, want)
        np.testing.assert_array_equal(theirs, want)
    # a frame's encoding does not depend on its batch
    (one,), (coeffs,) = encode_frames(_frames()[5:], quality)
    assert one == jpegs[5]
    np.testing.assert_array_equal(coeffs, zz[5])


@pytest.mark.parametrize("h,w", PARTIAL)
def test_partial_mcu_geometry_is_pils_and_decodes(h, w, tmp_path):
    pytest.importorskip("PIL")
    frames = _frames(h, w)
    jpegs, zz = encode_frames(frames, 90)
    # Y over the MCU-aligned grid, then Cb and Cr
    mcus = -(-h // 16) * -(-w // 16)
    assert zz.shape == (6, 6 * mcus, 64)
    for frame, jpeg in zip(frames, jpegs):
        assert jpeg == _pil_jpeg(frame, 90)
    # the coefficient decoders refuse partial MCUs, both with one message
    with pytest.raises(CorruptVideoError) as ours:
        jpeg_frame_dct(jpegs[0])
    with pytest.raises(Exception) as theirs:
        jax_jpeg_frame_dct(jpegs[0])
    assert str(ours.value) == str(theirs.value)
    # the native decoder reads the stream whole: luma within the IDCT
    # rounding of libjpeg's (the reference's bound)
    path = str(tmp_path / "v.mjpg")
    write_mjpeg(path, frames, quality=90)
    out = native.NativeY4MDecoder().decode_clips_yuv(path, [0], 6, w, h)
    for i in range(6):
        from PIL import Image
        with Image.open(io.BytesIO(jpegs[i])) as im:
            im.draft("YCbCr", im.size)
            y_pil = np.asarray(im.convert("YCbCr"))[..., 0].astype(int)
        y_native = out[0, i][:h * w].reshape(h, w).astype(int)
        assert np.abs(y_native - y_pil).max() <= 2


@pytest.mark.parametrize("quality", QUALITIES + (30, 100))
def test_dqt_bytes_are_pils_and_pil_opens_every_frame(quality):
    pytest.importorskip("PIL")
    frames = _frames()
    jpegs, _ = encode_frames(frames, quality)
    tables = _segments(jpegs[0], 0xDB)
    assert len(tables) == 2
    assert tables == _segments(_pil_jpeg(frames[0], quality), 0xDB)
    for jpeg in jpegs:
        assert _pil_rgb(jpeg).shape == (HW, HW, 3)


def test_smooth_content_round_trips_within_the_references_bound(tmp_path):
    pytest.importorskip("PIL")
    # tests/test_mjpeg.py's smooth frame, its quality and its bound
    h, w = 64, 96
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    smooth = np.stack([127 + 60 * np.sin(yy / 20),
                       127 + 60 * np.cos(xx / 25),
                       127 + 50 * np.sin((xx + yy) / 30)],
                      axis=-1).astype(np.uint8)[None]
    path = str(tmp_path / "s.mjpg")
    write_mjpeg(path, smooth, quality=95)
    with open(path, "rb") as f:
        data = f.read()
    (off, length), = scan_mjpeg_frames(data)
    decoded = _pil_rgb(data[off:off + length]).astype(int)
    assert np.abs(decoded - smooth[0].astype(int)).max() <= 8


@pytest.mark.parametrize("h,w", ((HW, HW),) + PARTIAL)
@pytest.mark.parametrize("quality", QUALITIES)
def test_port_files_equal_pils(h, w, quality, tmp_path):
    """Measured: the port's file and PIL's for the same frames are the
    same bytes, so no coefficient and no decoded pixel differs."""
    pytest.importorskip("PIL")
    frames = _frames(h, w, seed=quality)
    ours, theirs = str(tmp_path / "o.mjpg"), str(tmp_path / "t.mjpg")
    write_mjpeg(ours, frames, quality=quality)
    jax_write_mjpeg(theirs, frames, quality=quality)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        a, b = f.read(), g.read()
    assert scan_mjpeg_frames(a) == scan_mjpeg_frames(b)
    assert a == b


def test_encoder_refusals():
    with pytest.raises(ValueError, match="even geometry"):
        encode_frames(np.zeros((1, 15, 16, 3), np.uint8))
    with pytest.raises(ValueError, match="uint8 RGB"):
        encode_frames(np.zeros((1, 16, 16, 3), np.float32))
    with pytest.raises(ValueError, match="uint8 RGB"):
        encode_frames(np.zeros((16, 16, 3), np.uint8))


# -- the PIL fallback decoder ------------------------------------------

@pytest.fixture(scope="module")
def mjpeg_pair(tmp_path_factory):
    """The same 6 frames at 112x112, written by the port and by PIL."""
    pytest.importorskip("PIL")
    root = tmp_path_factory.mktemp("pair")
    frames = jax_synth_frames(6, HW, HW, seed=[5, 1, 2])
    ours, theirs = str(root / "ours.mjpg"), str(root / "pil.mjpg")
    write_mjpeg(ours, frames, quality=DCT_QUALITY)
    jax_write_mjpeg(theirs, frames, quality=DCT_QUALITY)
    return {"port": ours, "pil": theirs}


@pytest.mark.parametrize("writer", ("port", "pil"))
@pytest.mark.parametrize("entry", ("rgb", "yuv420", "dct"))
def test_pil_decoder_is_the_jax_packages_bitwise(mjpeg_pair, writer, entry):
    path = mjpeg_pair[writer]
    ours, ref = MjpegPILDecoder(), JaxMjpegPILDecoder()
    assert ours.num_frames(path) == ref.num_frames(path) == 6
    starts = [0, 4, 5]  # the last two run past the end: repeats
    if entry == "rgb":
        args = (path, starts, 3, 96, 80)  # and a resize
        got, want = ours.decode_clips(*args), ref.decode_clips(*args)
    elif entry == "yuv420":
        args = (path, starts, 3, 56, 48)
        got, want = ours.decode_clips_yuv(*args), ref.decode_clips_yuv(
            *args)
    else:
        args = (path, starts, 3, HW, HW)
        got, want = ours.decode_clips_dct(*args), ref.decode_clips_dct(
            *args)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2, 1], got[2, 2])


def _classified(decode):
    try:
        decode()
    except Exception as e:  # the class name and message, both packages'
        # PIL names the stream by its object's address
        return type(e).__name__, re.sub(r" at 0x[0-9a-f]+", "", str(e))
    return None


@pytest.mark.parametrize("case", ("bad-header", "truncated", "no-frames",
                                  "over-budget", "wrong-size"))
def test_pil_decoder_classifies_corrupt_files_as_the_jax_package(
        mjpeg_pair, case, tmp_path):
    with open(mjpeg_pair["port"], "rb") as f:
        data = f.read()
    path = str(tmp_path / "bad.mjpg")
    frames = scan_mjpeg_frames(data)
    body = data
    if case == "bad-header":
        # frame 2 claims 12-bit samples: libjpeg and jpeg_dct refuse it
        sof = data.index(b"\xff\xc0", frames[2][0])
        body = data[:sof + 4] + b"\x0c" + data[sof + 5:]
    elif case == "truncated":
        # frame 3's scan cut in half and closed: libjpeg fills the rest,
        # the coefficient decoder reads a spectrum over the budget
        off, length = frames[3]
        body = data[:off + length // 2] + b"\xff\xd9" + data[off + length:]
    elif case == "no-frames":
        body = b"\x00" * 64
    with open(path, "wb") as f:
        f.write(body)
    calls = []
    for decoder in (MjpegPILDecoder(), JaxMjpegPILDecoder()):
        if case == "over-budget":
            calls.append([_classified(lambda: decoder.decode_clips_dct(
                path, [0], 2, HW, HW, coeffs=50))])
        elif case == "wrong-size":
            calls.append([_classified(lambda: decoder.decode_clips_dct(
                path, [0], 2, 96, 96))])
        else:
            calls.append([
                _classified(lambda: decoder.decode_clips(path, [0, 3], 3)),
                _classified(lambda: decoder.decode_clips_yuv(path, [0, 3],
                                                             3)),
                _classified(lambda: decoder.decode_clips_dct(
                    path, [0, 3], 3, HW, HW))])
    assert calls[0] == calls[1]
    assert any(c is not None and c[0] == "CorruptVideoError"
               for c in calls[0])


def test_without_pil_a_pixel_decode_names_pil(mjpeg_pair, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    decoder = MjpegPILDecoder()
    for decode in (decoder.decode_clips, decoder.decode_clips_yuv):
        with pytest.raises(ModuleNotFoundError, match="needs PIL"):
            decode(mjpeg_pair["port"], [0], 2)
    # the dct entry needs no PIL
    assert decoder.decode_clips_dct(mjpeg_pair["port"], [0], 2, HW,
                                    HW).shape[:2] == (1, 2)
    monkeypatch.setenv("RNB_DISABLE_NATIVE", "1")
    assert isinstance(get_decoder(mjpeg_pair["port"]), MjpegPILDecoder)


# -- the native decoder on the port's files ----------------------------

@pytest.fixture(scope="module")
def native_file(tmp_path_factory):
    """tests/test_mjpeg.py's fixture, written by the port."""
    path = str(tmp_path_factory.mktemp("native") / "v.mjpg")
    write_mjpeg(path, jax_synth_frames(6, 64, 96, seed=[5, 1, 2]),
                quality=90)
    return path


def test_native_decode_of_port_files_is_the_jax_packages(native_file):
    ours = native.NativeY4MDecoder()
    got = {"rgb": ours.decode_clips(native_file, [0, 4], 3, 112, 112),
           "yuv420": ours.decode_clips_yuv(native_file, [0, 4], 3, 96, 64)}
    if jax_native_available():
        theirs = JaxNativeDecoder()
        np.testing.assert_array_equal(
            got["rgb"], theirs.decode_clips(native_file, [0, 4], 3, 112,
                                            112))
        np.testing.assert_array_equal(
            got["yuv420"], theirs.decode_clips_yuv(native_file, [0, 4], 3,
                                                   96, 64))
    np.testing.assert_array_equal(got["rgb"][1, 1], got["rgb"][1, 2])


def test_native_decode_of_port_files_within_the_pil_bounds(native_file):
    pytest.importorskip("PIL")
    h, w = 64, 96
    nd = native.NativeY4MDecoder()
    with open(native_file, "rb") as f:
        data = f.read()
    frames = scan_mjpeg_frames(data)
    for idx in (0, 3):
        off, length = frames[idx]
        from PIL import Image
        with Image.open(io.BytesIO(data[off:off + length])) as im:
            im.draft("YCbCr", im.size)
            ycc = np.asarray(im.convert("YCbCr")).astype(int)
        out = nd.decode_clips_yuv(native_file, [idx], 1, w, h)[0, 0]
        y_native = out[:h * w].reshape(h, w).astype(int)
        assert np.abs(y_native - ycc[..., 0]).max() <= 2
        u_native = out[h * w:h * w + (h // 2) * (w // 2)].astype(int)
        u_pil = ycc[::2, ::2, 1].ravel()
        assert np.abs(u_native - u_pil).mean() <= 8
        assert np.abs(u_native - u_pil).max() <= 48
    resized = nd.decode_clips(native_file, [1], 2, 112, 112)
    fallback = MjpegPILDecoder().decode_clips(native_file, [1], 2, 112, 112)
    assert np.abs(resized.astype(int) - fallback.astype(int)).mean() <= 4.0


# -- the dataset -------------------------------------------------------

def test_dataset_mjpeg_mode_writes_the_reference_generators_frames(
        tmp_path):
    pytest.importorskip("PIL")
    for seed in ([7, 0, 0], [7, 3, 1], 11):
        np.testing.assert_array_equal(synth_frames(5, 32, 48, seed),
                                      jax_synth_frames(5, 32, 48, seed))
    root = make_dataset(str(tmp_path / "d"), videos=5, frames=9,
                        fmt="mjpeg", quality=DCT_QUALITY,
                        dct_budget=default_dct_coeffs(HW, HW))
    for i in range(5):
        path = os.path.join(root, "label%02d" % (i % 4), "v%03d.mjpg" % i)
        want = str(tmp_path / ("ref%d.mjpg" % i))
        # the reference's make_dataset seeds video vi of label li so
        jax_write_mjpeg(want, jax_synth_frames(9, HW, HW,
                                               seed=[7, i % 4, i // 4]),
                        quality=DCT_QUALITY)
        with open(path, "rb") as f, open(want, "rb") as g:
            assert f.read() == g.read()
    assert sorted(os.listdir(root)) == ["label00", "label01", "label02",
                                        "label03"]


def test_dataset_refuses_a_frame_over_the_dct_budget(tmp_path):
    frames = jax_synth_frames(3, HW, HW, seed=[7, 0, 0])
    path = str(tmp_path / "v.mjpg")
    with pytest.raises(ValueError, match=r"v\.mjpg frame 0 holds \d+ "
                       r"nonzero DCT coefficients at quality 90, over the "
                       r"dct budget of 2205"):
        write_mjpeg_checked(path, frames, 90,
                            default_dct_coeffs(HW, HW))
    assert not os.path.exists(path)
    write_mjpeg_checked(path, frames, DCT_QUALITY,
                        default_dct_coeffs(HW, HW))
    with pytest.raises(ValueError, match="format must be one of"):
        make_dataset(str(tmp_path / "x"), fmt="avi")


# -- served runs, port against the JAX package -------------------------

#: path -> (shipped config, the tree's quality)
SERVED = {"yuv420": ("configs/rnb-fused-yuv-big.json", 90),
          "dct": ("configs/rnb-fused-dct-ragged.json", DCT_QUALITY),
          "rgb": ("configs/r2p1d-whole.json", 90)}


def _served_copy(config, tmp_path):
    """tests/test_torch_slice.py's reduction (3-row batches, layer sizes
    (1,1,1,1), 10 classes); the unfused rgb loader likewise."""
    with open(os.path.join(REPO, config)) as f:
        raw = json.load(f)
    loader, runner = raw["pipeline"]
    loader.update(max_clips=3, row_buckets=[1, 3])
    if "fuse" in loader:
        loader["fuse"] = min(loader["fuse"], 3)
    runner.update(max_rows=3, row_buckets=[1, 3], layer_sizes=list(LS),
                  num_classes=CLASSES)
    if "ragged" in raw:
        raw["ragged"]["pool_rows"] = 3
        runner["ragged_chunk_rows"] = 1
    path = str(tmp_path / os.path.basename(config))
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


@pytest.fixture(scope="module")
def jax_weights():
    return jax_ckpt.load_or_init(1, 5, CLASSES, LS, None)


@pytest.fixture
def jax_decodes_natively(monkeypatch):
    """The JAX package decodes on the native library, as the port does:
    its own build where there is one, else the port's build of the same
    ``native/decode.cpp`` (the JAX binding reads ``RNB_NATIVE_LIB``).
    Through PIL, libjpeg's triangle chroma upsample moves the pixels a
    few LSB, and the logits past the bound."""
    if jax_native_available():
        return
    from rnb_tpu.decode import native as jax_native
    _native.build()
    monkeypatch.setenv("RNB_NATIVE_LIB", _native.library_path())
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_lib_checked", False)
    assert jax_native_available()


#: the JAX package's (loader, runner) per pixel path, built once
_JAX_STAGES = {}


def _jax_logits(video, pixel_path):
    """The JAX package's stages on one video: its loader (its decoder),
    then its runner on its seeded weights."""
    if pixel_path not in _JAX_STAGES:
        device = jax.devices()[0]
        loader = jax_model.R2P1DLoader(device, max_clips=3,
                                       row_buckets=[1, 3], num_warmups=0,
                                       pixel_path=pixel_path)
        runner = jax_model.R2P1DRunner(
            device, start_index=1, end_index=5, num_classes=CLASSES,
            layer_sizes=LS, max_rows=3, num_warmups=0, row_buckets=[1, 3],
            pixel_path=pixel_path)
        _JAX_STAGES[pixel_path] = (loader, runner)
    loader, runner = _JAX_STAGES[pixel_path]
    card = jax_telemetry.TimeCard(0)
    tensors, nt, card = loader(None, video, card)
    tensors, nt, card = runner(tensors, nt, card)
    return np.asarray(tensors[0].data)[:tensors[0].valid]


@pytest.mark.parametrize("pixel_path", sorted(SERVED))
def test_a_served_mjpeg_run_holds_the_jax_logits(pixel_path, tmp_path,
                                                 monkeypatch, jax_weights,
                                                 jax_decodes_natively):
    config, quality = SERVED[pixel_path]
    root = make_dataset(str(tmp_path / "data"), videos=4, frames=24,
                        fmt="mjpeg", quality=quality,
                        dct_budget=(default_dct_coeffs(HW, HW)
                                    if pixel_path == "dct" else None))
    monkeypatch.setenv("RNB_TPU_DATA_ROOT", root)
    state = from_jax_variables(jax_weights)

    def shared_network(start, end, num_classes, layer_sizes, device,
                       dtype=torch.bfloat16, factored_shortcut=False):
        net = R2Plus1DClassifier(start, end, num_classes, layer_sizes,
                                 factored_shortcut, dtype=dtype)
        net.load_state_dict(filter_layer_range(state, start, end),
                            strict=True)
        return cast_compute_weights(net).to(device).eval()

    monkeypatch.setattr(port_model, "shared_network", shared_network)
    path = _served_copy(config, tmp_path)
    sink = {}
    result = run_benchmark(path, mean_interval_ms=0, num_videos=REQUESTS,
                           log_base=str(tmp_path / "logs"),
                           print_progress=False, seed=0, platform="cpu",
                           outputs_sink=sink)
    reference = jax_run_benchmark(path, mean_interval_ms=0,
                                  num_videos=REQUESTS, queue_size=500,
                                  log_base=str(tmp_path / "jax"),
                                  print_progress=False, seed=0)
    assert result.termination_flag == reference.termination_flag == 0
    assert result.num_completed == reference.num_completed == REQUESTS
    assert result.num_failed == reference.num_failed == 0
    assert sorted(sink) == list(range(REQUESTS))
    with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
        meta = f.read()
    assert "Pixel path: %s\n" % pixel_path in meta
    assert "Decode backend: native\n" in meta
    assert_both_checks_pass(result.log_dir)
    clips = 0
    for rid, (video, logits, _stamps) in sorted(sink.items()):
        assert video.endswith(".mjpg")
        want = _jax_logits(video, pixel_path)
        # tests/test_torch_slice.py's bound: 2% of the logit scale
        bound = 0.02 * float(np.abs(want).max())
        assert logits.shape == want.shape == (logits.shape[0], CLASSES)
        assert np.abs(logits - want).max() <= bound, rid
        clips += logits.shape[0]
    assert result.clips_completed == clips
