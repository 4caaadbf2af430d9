"""The port's rgb pixel path and unfused pipeline stages against the JAX
package, on the CPU.

The same inputs, made from a seed with numpy (or the two packages'
byte-equal synthetic decoders), go through the JAX function or stage and
its counterpart in ``rnb_tpu_torch``:

* the plain ``ragged_normalize_u8`` against the masked-jnp formulation
  and against the Pallas kernel in interpret mode, bitwise;
* ``decode_clips`` (RGB), bitwise;
* ``R2P1DLoader`` emissions, bitwise: data, valid rows, segment table,
  pad rows, ``num_clips``, the padding and ragged counters, the cache
  stamps;
* ``R2P1DRunner`` on rgb input and on the ranges 1..4 and 5..5 against
  ``_shared_apply`` with bridged weights;
* the selectors' decisions and the ``Batcher``'s emissions, bitwise.

Tolerances are stated per test. The slice as a whole is in
``tests/test_torch_pipeline.py``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnb_tpu import batcher as jax_batcher
from rnb_tpu import selector as jax_selector
from rnb_tpu import stage as jax_stage
from rnb_tpu import telemetry as jax_telemetry
from rnb_tpu.decode import MjpegPILDecoder as JaxMjpegPILDecoder
from rnb_tpu.decode import SyntheticDecoder as JaxSyntheticDecoder
from rnb_tpu.decode import Y4MDecoder as JaxY4MDecoder
from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.models.r2p1d import model as jax_model
from rnb_tpu.ops.preprocess import \
    normalize_u8_reference as jax_normalize_u8_reference
from rnb_tpu.ops.ragged import _ragged_normalize_pallas
from rnb_tpu.ops.ragged import ragged_normalize_u8 as jax_ragged_normalize_u8
from rnb_tpu_torch.batcher import Batcher
from rnb_tpu_torch.decode import (MjpegPILDecoder, SyntheticDecoder,
                                  Y4MDecoder, write_mjpeg, write_y4m)
from rnb_tpu_torch.devices import DeviceSpec
from rnb_tpu_torch.models.r2p1d.checkpoint import (filter_layer_range,
                                                   from_jax_variables)
from rnb_tpu_torch.models.r2p1d.model import (LargeSmallSelector,
                                              R2P1DFusingLoader, R2P1DLoader,
                                              R2P1DRunner)
from rnb_tpu_torch.models.r2p1d.network import (R2Plus1DClassifier,
                                                cast_compute_weights)
from rnb_tpu_torch.ops.preprocess import normalize_u8
from rnb_tpu_torch.ops.ragged import (ragged_normalize_u8,
                                      ragged_normalize_u8_reference)
from rnb_tpu_torch.selector import RoundRobinSelector
from rnb_tpu_torch.stage import PaddedBatch, RaggedBatch
from rnb_tpu_torch.telemetry import TimeCard, TimeCardList

torch.set_num_threads(2)

CPU = DeviceSpec(0, "cpu")
LS = (1, 1, 1, 1)
CLASSES = 8
FRAMES = 2
#: a narrow loader: up to 3 clips of 2 frames, buckets 1 and 3
LOADER = dict(max_clips=3, consecutive_frames=FRAMES,
              num_clips_population=[1, 3], weights=[1, 1], num_warmups=0,
              row_buckets=[1, 3])
VIDEOS = ["synth://kinetics/video-%04d" % i for i in range(8)]


def _bits(x) -> np.ndarray:
    """The raw bit patterns of a bf16 (or the values of any other)
    torch or jax array."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 and \
        x.dtype.kind not in "iu" else x


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


# -- the ragged normalize (Pallas kernel 2) ----------------------------

@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("valid", [0, 1, 3, 5])
def test_ragged_normalize_plain_bitwise_equals_jnp_and_pallas(valid,
                                                              as_tensor):
    # tolerance: none — valid rows round the same exact f32 term once,
    # pad rows are exactly zero in the jnp formulation, in the Pallas
    # kernel (interpret mode, as tests/test_ragged.py runs it) and here
    pool = _u8((5, 2, 8, 8, 3), seed=31)  # row bytes 384 = 3 x 128
    rows_valid = (torch.tensor([valid], dtype=torch.int32) if as_tensor
                  else valid)
    ours = ragged_normalize_u8(torch.from_numpy(pool), rows_valid)
    plain = ragged_normalize_u8_reference(torch.from_numpy(pool),
                                          rows_valid)
    assert ours.dtype == torch.bfloat16 and ours.shape == pool.shape
    np.testing.assert_array_equal(_bits(ours), _bits(plain))
    masked = jnp.where(
        jnp.arange(5).reshape(5, 1, 1, 1, 1) < valid,
        jax_normalize_u8_reference(jnp.asarray(pool), dtype=jnp.bfloat16),
        jnp.zeros((), jnp.bfloat16))
    np.testing.assert_array_equal(_bits(ours), _bits(masked))
    pallas = _ragged_normalize_pallas(jnp.asarray(pool), valid,
                                      jnp.bfloat16, interpret=True)
    np.testing.assert_array_equal(_bits(ours), _bits(pallas))
    assert not ours[valid:].float().any()
    np.testing.assert_array_equal(
        _bits(ours[:valid]),
        _bits(normalize_u8(torch.from_numpy(pool[:valid]))))


@pytest.mark.parametrize("shape", [(4, 33), (3, 2, 7, 5, 3), (2, 1)])
def test_ragged_normalize_serves_any_row_size(shape):
    # the reference sends rows that are no multiple of 128 bytes through
    # its jnp formulation; the port has one path for every row size
    pool = _u8(shape, seed=sum(shape))
    for valid in (0, 1, shape[0], shape[0] + 2, -1):
        ours = ragged_normalize_u8(torch.from_numpy(pool), valid)
        ref = jax_ragged_normalize_u8(jnp.asarray(pool), valid)
        np.testing.assert_array_equal(_bits(ours), _bits(ref))


def test_ragged_normalize_other_dtypes_and_bad_inputs():
    pool = _u8((3, 16), seed=1)
    ours = ragged_normalize_u8(torch.from_numpy(pool), 2, torch.float32)
    ref = jax_ragged_normalize_u8(jnp.asarray(pool), 2, dtype=jnp.float32)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        ragged_normalize_u8(torch.zeros((), dtype=torch.uint8), 0)
    meta = torch.empty((3, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        ragged_normalize_u8(meta, 1)  # never the plain version off the CPU


# -- the RGB decode ----------------------------------------------------

@pytest.mark.parametrize("frames,hw", [(8, 112), (2, 16)])
def test_synthetic_decode_clips_byte_equal_to_jax_decoder(frames, hw):
    starts = [0, 7, 40]
    ours = SyntheticDecoder().decode_clips(VIDEOS[1], starts, frames, hw, hw)
    ref = JaxSyntheticDecoder().decode_clips(VIDEOS[1], starts, frames, hw,
                                             hw)
    assert ours.shape == (3, frames, hw, hw, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("geom,cs", [((112, 112), "420"), ((48, 64), "420"),
                                     ((30, 40), "444")])
def test_y4m_decode_clips_byte_equal_to_jax_decoder(tmp_path, geom, cs):
    # float32 BT.601, clip, truncate, nearest resize: numpy on both sides
    h, w = geom
    path = str(tmp_path / "v.y4m")
    write_y4m(path, _u8((12, h, w, 3), seed=h * w), colorspace=cs)
    starts = [0, 3, 9]  # the last clip runs past the end: repeats
    ours = Y4MDecoder().decode_clips(path, starts, 8, 112, 112)
    ref = JaxY4MDecoder().decode_clips(path, starts, 8, 112, 112)
    assert ours.shape == (3, 8, 112, 112, 3)
    np.testing.assert_array_equal(ours, ref)
    small = Y4MDecoder().decode_clips(path, [1], 2, 20, 24)
    np.testing.assert_array_equal(
        small, JaxY4MDecoder().decode_clips(path, [1], 2, 20, 24))


def test_decode_clips_rejects_what_it_cannot_decode(tmp_path):
    path = str(tmp_path / "v.y4m")
    write_y4m(path, _u8((4, 16, 16, 3)), colorspace="420")
    with pytest.raises(ValueError):
        Y4MDecoder().decode_clips(path, [-1], 2, 16, 16)
    decoder = Y4MDecoder()
    assert decoder.num_frames(path) == 4
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 100)  # cut inside frame 3
    with pytest.raises(ValueError, match="truncated"):
        decoder.decode_clips(path, [2], 2, 16, 16)
    # MJPEG's rgb entry without the native library: PIL's decode,
    # bitwise the JAX package's, or an error that names PIL
    mjpg = str(tmp_path / "v.mjpg")
    write_mjpeg(mjpg, _u8((4, 16, 16, 3)), quality=90)
    try:
        import PIL  # noqa: F401
    except ImportError:
        with pytest.raises(ModuleNotFoundError, match="PIL"):
            MjpegPILDecoder().decode_clips(mjpg, [0], 2, 16, 16)
    else:
        np.testing.assert_array_equal(
            MjpegPILDecoder().decode_clips(mjpg, [0, 3], 2, 8, 12),
            JaxMjpegPILDecoder().decode_clips(mjpg, [0, 3], 2, 8, 12))


# -- the unfused loader ------------------------------------------------

def _jax_loader(**kwargs):
    return jax_model.R2P1DLoader(jax.devices()[0], **dict(LOADER, **kwargs))


def _serve(loader, card_class, videos, prefetch):
    """Every video through one loader: in turn, or with the decodes of
    the whole window submitted first."""
    cards = [card_class(i) for i in range(len(videos))]
    if prefetch:
        handles = [loader.submit(v, tc) for v, tc in zip(videos, cards)]
        outs = [loader.complete(h, v, tc)
                for h, v, tc in zip(handles, videos, cards)]
    else:
        outs = [loader(None, v, tc) for v, tc in zip(videos, cards)]
    return outs, cards


def _assert_emissions_equal(ours, ref, ragged):
    for ((got,), got_nt, got_tc), ((want,), want_nt, want_tc) in zip(ours,
                                                                     ref):
        assert got_nt is None and want_nt is None
        assert got.valid == want.valid == got_tc.num_clips \
            == want_tc.num_clips
        assert tuple(got.data.shape) == tuple(want.data.shape)
        np.testing.assert_array_equal(_bits(got.data), _bits(want.data))
        assert getattr(got_tc, "pad_rows", None) == \
            getattr(want_tc, "pad_rows", None)
        if ragged:
            assert isinstance(got, RaggedBatch)
            assert got.segment_offsets == tuple(want.segment_offsets) \
                == (0, got.valid)
        else:
            assert type(got) is PaddedBatch


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_loader_rgb_emissions_bitwise_equal_to_jax_loader(ragged, prefetch):
    # tolerance: none — byte-equal decodes, one rounding in the
    # normalize. Bucketed pad rows are zero bytes normalized (-1.0);
    # ragged pad rows are exactly zero, whatever the pool tail held
    kwargs = dict(prefetch=2 if prefetch else 0, ragged=ragged,
                  ragged_pool_rows=3 if ragged else None)
    loader = R2P1DLoader(CPU, **dict(LOADER, **kwargs))
    ref_loader = _jax_loader(**kwargs)
    ours, cards = _serve(loader, TimeCard, VIDEOS, prefetch)
    ref, ref_cards = _serve(ref_loader, jax_telemetry.TimeCard, VIDEOS,
                            prefetch)
    _assert_emissions_equal(ours, ref, ragged)
    clips = [tc.num_clips for tc in cards]
    assert set(clips) == {1, 3} and clips == [tc.num_clips
                                              for tc in ref_cards]
    assert loader.padding.snapshot() == ref_loader.padding.snapshot()
    assert loader.ragged_stats == ref_loader.ragged_stats
    for (batch,), _nt, tc in ours:
        assert batch.data.dtype == torch.bfloat16
        pad = batch.data[batch.valid:].float()
        if ragged:
            assert batch.data.shape[0] == 3 and not pad.any()
        else:
            assert batch.data.shape[0] in (1, 3) and (pad == -1.0).all()
        assert tc.video.startswith("synth://")
    assert loader.ingest_stats == {"pixel_path": "rgb",
                                   "backends": {"synth"}}
    assert loader.prefetch_depth == (2 if prefetch else 0)
    loader.discard_pending()


@pytest.mark.parametrize("pixel_path,dtype", [("yuv420", torch.uint8),
                                              ("dct", torch.int16)])
def test_loader_ships_wire_rows_untouched(pixel_path, dtype):
    # the yuv420 and dct paths leave the ingest to the network stage:
    # the emission is the decoded rows, zero-padded to the bucket
    loader = R2P1DLoader(CPU, pixel_path=pixel_path, **LOADER)
    ref_loader = _jax_loader(pixel_path=pixel_path)
    ours, _cards = _serve(loader, TimeCard, VIDEOS[:4], False)
    ref, _ref_cards = _serve(ref_loader, jax_telemetry.TimeCard, VIDEOS[:4],
                             False)
    _assert_emissions_equal(ours, ref, False)
    assert all(batch.data.dtype == dtype for (batch,), _nt, _tc in ours)
    assert R2P1DLoader.output_shape_for(pixel_path=pixel_path, **LOADER) \
        == tuple(tuple(s) for s in jax_model.R2P1DLoader.output_shape_for(
            pixel_path=pixel_path, **LOADER))
    assert R2P1DLoader.output_dtype_for(pixel_path=pixel_path) == \
        jax_model.R2P1DLoader.output_dtype_for(pixel_path=pixel_path)


@pytest.mark.parametrize("ragged", [False, True])
def test_loader_cache_hits_and_coalescing_match_jax_loader(ragged):
    # a miss, a follower sharing its decode, a second miss, then hits:
    # the same stamps, counters and bytes in both packages
    kwargs = dict(prefetch=3, cache_mb=4, ragged=ragged,
                  ragged_pool_rows=3 if ragged else None)
    loader = R2P1DLoader(CPU, **dict(LOADER, **kwargs))
    ref_loader = _jax_loader(**kwargs)
    a, b = VIDEOS[0], VIDEOS[1]
    ours, ref, cards, ref_cards = [], [], [], []
    for window in ([a, a, b], [b, a]):
        out, tcs = _serve(loader, TimeCard, window, True)
        ours += out
        cards += tcs
        out, tcs = _serve(ref_loader, jax_telemetry.TimeCard, window, True)
        ref += out
        ref_cards += tcs
    _assert_emissions_equal(ours, ref, ragged)
    stamps = [(tc.cache_hit, tc.cache_coalesced) for tc in cards]
    assert stamps == [(False, False), (False, True), (False, False),
                      (True, False), (True, False)]
    assert stamps == [(tc.cache_hit, getattr(tc, "cache_coalesced", False))
                      for tc in ref_cards]
    snap, ref_snap = loader.cache.snapshot(), ref_loader.cache.snapshot()
    for key in ("hits", "misses", "inserts", "coalesced", "evictions"):
        assert snap[key] == ref_snap[key], key
    assert (snap["hits"], snap["misses"], snap["inserts"],
            snap["coalesced"]) == (2, 3, 2, 1)
    if ragged:
        assert loader.ragged_stats == ref_loader.ragged_stats
        assert loader.ragged_stats["cache_hit_rows"] == \
            cards[3].num_clips + cards[4].num_clips
    # a handle that is never completed is retired without a trace
    handle = loader.submit(VIDEOS[2], TimeCard(9))
    loader.discard(handle, VIDEOS[2])
    assert len(loader._inflight_keys) == 0
    loader.discard_pending()


def test_fusing_loader_normalizes_rgb_emissions():
    # the fusing loader, too, normalizes rgb emissions in the loader,
    # ragged or not: every request's rows are the unfused loader's
    plain = R2P1DLoader(CPU, max_clips=3, num_warmups=0, row_buckets=[1, 3],
                        num_clips_population=[1], weights=[1])
    want = {}
    for i, video in enumerate(VIDEOS[:3]):
        (batch,), _nt, tc = plain(None, video, TimeCard(i))
        want[video] = batch.data[:tc.num_clips]
    for ragged in (False, True):
        loader = R2P1DFusingLoader(CPU, fuse=3, max_clips=3, num_warmups=0,
                                   row_buckets=[1, 3], pixel_path="rgb",
                                   ragged=ragged, ragged_pool_rows=3)
        loader.sampler = plain.sampler
        emissions = []
        for i, video in enumerate(VIDEOS[:3]):
            out = loader(None, video, TimeCard(i))
            if out[2] is not None:
                emissions.append(out)
        while True:
            out = loader.flush()
            if out is None:
                break
            emissions.append(out)
        seen = 0
        for (batch,), _nt, tcs in emissions:
            assert batch.data.dtype == torch.bfloat16
            assert isinstance(batch, RaggedBatch) == ragged
            for tc in tcs.time_cards:
                rows = batch.data[tc.row0:tc.row0 + tc.num_clips]
                assert torch.equal(rows, want[tc.video])
                seen += 1
            if ragged:
                assert not batch.data[batch.valid:].float().any()
        assert seen == 3
        loader.discard_pending()


# -- the runner on rgb input and on partial ranges ---------------------

def _randomize_bn(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _randomize_bn(v, rng)
        elif k == "mean":
            out[k] = rng.normal(0.0, 0.3, np.shape(v)).astype(np.float32)
        elif k in ("var", "scale"):
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        elif k == "bias":
            out[k] = rng.normal(0.0, 0.1, np.shape(v)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def variables():
    """The JAX package's seeded init, BatchNorm randomized."""
    full = jax_ckpt.init_variables(seed=0, num_classes=CLASSES,
                                   layer_sizes=LS)
    return {k: _randomize_bn(dict(v), np.random.default_rng(1))
            for k, v in full.items()}


def _port_net(variables, start, end, dtype):
    net = R2Plus1DClassifier(start, end, CLASSES, LS, dtype=dtype)
    net.load_state_dict(filter_layer_range(from_jax_variables(variables),
                                           start, end), strict=True)
    return cast_compute_weights(net).eval()


def _assert_close_bf16(got, want):
    # bf16 on both sides with the same rounding points; what differs is
    # the accumulation order inside the convs, re-rounded to bf16 at ~20
    # points: 2% of the output scale (tests/test_torch_slice.py's bound),
    # and for logits the argmax must agree past twice that margin
    bound = 0.02 * float(np.abs(want).max())
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= bound
    if got.ndim == 2:
        for g, w in zip(got, want):
            top2 = np.sort(w)[-2:]
            if top2[1] - top2[0] > 2 * bound:
                assert g.argmax() == w.argmax()


@pytest.mark.parametrize("start,end", [(1, 5), (1, 4), (5, 5)])
def test_runner_ranges_match_jax_shared_apply(variables, start, end):
    shape = R2P1DRunner.input_shape_for(start_index=start, max_rows=2,
                                        consecutive_frames=FRAMES)[0]
    assert shape == tuple(jax_model.R2P1DRunner.input_shape_for(
        start_index=start, max_rows=2, consecutive_frames=FRAMES)[0])
    assert R2P1DRunner.input_dtype_for(start_index=start) == \
        jax_model.R2P1DRunner.input_dtype_for(start_index=start)
    rng = np.random.default_rng(10 * start + end)
    if start == 1:
        # what the loader emits: normalized bf16 frames
        x = normalize_u8(torch.from_numpy(_u8(shape, seed=end)))
        x_jax = jnp.asarray(_bits(x)).view(jnp.bfloat16)
    else:
        # what an upstream network stage emits: a float32 feature map
        x = torch.from_numpy(np.abs(rng.normal(size=shape))
                             .astype(np.float32))
        x_jax = jnp.asarray(x.numpy())
    part = jax_ckpt.filter_layer_range(variables, start, end)
    want = np.asarray(jax_model._shared_apply(start, end, CLASSES, LS)(
        part, x_jax))
    # float32: within the bound tests/test_torch_network.py uses
    net32 = _port_net(variables, start, end, torch.float32)
    with torch.inference_mode():
        got32 = net32(x.float()).numpy()
    want32 = np.asarray(jax.jit(lambda v, a: jax_model.R2Plus1DClassifier(
        start=start, end=end, num_classes=CLASSES, layer_sizes=LS,
        dtype=jnp.float32).apply(v, a, train=False))(
            part, x_jax.astype(jnp.float32)))
    np.testing.assert_allclose(got32, want32, rtol=5e-4, atol=5e-4)
    # bf16, through the stage
    runner = R2P1DRunner(CPU, start_index=start, end_index=end,
                         num_classes=CLASSES, layer_sizes=LS, max_rows=2,
                         consecutive_frames=FRAMES, num_warmups=0,
                         network=_port_net(variables, start, end,
                                           torch.bfloat16))
    (out,), _, _ = runner((PaddedBatch(x, 2),), None, None)
    assert type(out) is PaddedBatch and out.valid == 2
    assert out.data.dtype == torch.float32
    assert tuple(out.data.shape) == R2P1DRunner.output_shape_for(
        start_index=start, end_index=end, num_classes=CLASSES, max_rows=2,
        consecutive_frames=FRAMES)[0] == tuple(
            jax_model.R2P1DRunner.output_shape_for(
                start_index=start, end_index=end, num_classes=CLASSES,
                max_rows=2, consecutive_frames=FRAMES)[0])
    _assert_close_bf16(out.data.numpy(), want)


def test_split_ranges_give_the_unsplit_logits(variables):
    # the reference casts every stage's output to float32 and the next
    # stage casts back to bf16: 1..4 | 5..5 computes what 1..5 does, and
    # in both packages the two agree bit for bit
    x = normalize_u8(torch.from_numpy(_u8((2, FRAMES, 112, 112, 3), 5)))
    runners = {rng: R2P1DRunner(
        CPU, start_index=rng[0], end_index=rng[1], num_classes=CLASSES,
        layer_sizes=LS, max_rows=2, consecutive_frames=FRAMES,
        num_warmups=0, network=_port_net(variables, *rng, torch.bfloat16))
        for rng in ((1, 5), (1, 4), (5, 5))}
    (whole,), _, _ = runners[1, 5]((PaddedBatch(x, 2),), None, None)
    (mid,), _, _ = runners[1, 4]((PaddedBatch(x, 2),), None, None)
    (split,), _, _ = runners[5, 5]((mid,), None, None)
    assert torch.equal(whole.data, split.data)
    x_jax = jnp.asarray(_bits(x)).view(jnp.bfloat16)
    jax_whole = jax_model._shared_apply(1, 5, CLASSES, LS)(variables, x_jax)
    jax_mid = jax_model._shared_apply(1, 4, CLASSES, LS)(
        jax_ckpt.filter_layer_range(variables, 1, 4), x_jax)
    jax_split = jax_model._shared_apply(5, 5, CLASSES, LS)(
        jax_ckpt.filter_layer_range(variables, 5, 5), jax_mid)
    np.testing.assert_array_equal(np.asarray(jax_whole),
                                  np.asarray(jax_split))
    _assert_close_bf16(split.data.numpy(), np.asarray(jax_whole))


def test_runner_ragged_tiles_on_a_bf16_pool_match_jax(variables):
    # the rgb pool arrives normalized and masked by the loader: the
    # runner's tile loop runs ceil(rows_valid / chunk) tiles over it and
    # leaves the rest of the output zero, as the reference's fori_loop
    pool = ragged_normalize_u8(torch.from_numpy(
        _u8((3, FRAMES, 112, 112, 3), seed=9)), 2)
    want = np.asarray(jax_model._shared_apply(
        1, 5, CLASSES, LS, ragged=True, ragged_chunk=1)(
            variables, jnp.asarray(_bits(pool)).view(jnp.bfloat16),
            np.int32(2)))
    runner = R2P1DRunner(CPU, num_classes=CLASSES, layer_sizes=LS,
                         max_rows=3, consecutive_frames=FRAMES,
                         num_warmups=0, ragged=True, ragged_pool_rows=3,
                         ragged_chunk_rows=1,
                         network=_port_net(variables, 1, 5, torch.bfloat16))
    (out,), _, _ = runner((RaggedBatch(pool, 2, (0, 2)),), None, None)
    assert isinstance(out, RaggedBatch) and out.segment_offsets == (0, 2)
    _assert_close_bf16(out.data.numpy()[:2], want[:2])
    assert not out.data[2].any() and not want[2].any()


# -- selectors and the batcher -----------------------------------------

def test_round_robin_selector_decisions_equal_jax():
    ours, ref = RoundRobinSelector(3), jax_selector.RoundRobinSelector(3)
    assert [ours.select(None, None, None) for _ in range(7)] == \
        [ref.select(None, None, None) for _ in range(7)] == \
        [0, 1, 2, 0, 1, 2, 0]


@pytest.mark.parametrize("population,max_clips", [(None, 15), ([1, 3], 3),
                                                   ([2, 9], 4)])
def test_large_small_selector_decisions_equal_jax(population, max_clips):
    kwargs = dict(max_clips=max_clips, num_warmups=0)
    if population:
        kwargs.update(num_clips_population=population, weights=[1, 1])
    ours, ref = LargeSmallSelector(2), jax_model.LargeSmallSelector(2)
    ours.bind_stage(R2P1DLoader(CPU, **kwargs))
    ref.bind_stage(jax_model.R2P1DLoader(jax.devices()[0], **kwargs))
    for clips in range(0, 17):
        card, ref_card = TimeCard(clips), jax_telemetry.TimeCard(clips)
        card.num_clips = ref_card.num_clips = clips
        assert ours.select(None, None, card) == \
            ref.select(None, None, ref_card) == \
            int(clips >= min(max_clips, max(population or [1, 15])))
    for bad in (1, 3):
        with pytest.raises(ValueError):
            LargeSmallSelector(bad)


def _feed(batcher, make_batch, card_class, parts):
    """Feed ``parts`` (arrays of valid rows) and collect the emissions,
    the end-of-stream flush included."""
    out = []
    for i, rows in enumerate(parts):
        result = batcher((make_batch(rows),), "video-%d" % i, card_class(i))
        if result[2] is not None:
            out.append(result)
    tail = batcher.flush()
    if tail is not None:
        out.append(tail)
    return out


@pytest.mark.parametrize("ragged", [False, True])
def test_batcher_emissions_bitwise_equal_to_jax_batcher(ragged):
    # tolerance: none — rows are moved, pad rows are zeros. The parts
    # force a full fuse (3 requests), an early emission (a part that no
    # longer fits) and a flushed partial batch
    rng = np.random.default_rng(17)
    shape = (FRAMES, 8, 8, 3)
    parts = [rng.normal(size=(n,) + shape).astype(np.float32)
             for n in (1, 2, 1, 3, 4, 1, 1)]
    kwargs = dict(batch=3, max_rows=6, consecutive_frames=FRAMES,
                  frame_hw=8, row_buckets=[4, 6], ragged=ragged)
    ours = Batcher(DeviceSpec(-1, "cpu"), **kwargs)
    ref = jax_batcher.Batcher("host", **kwargs)

    def pad_torch(rows):
        # an upstream bucketed loader pads its part: pad rows must not
        # reach the fused batch
        padded = np.full((rows.shape[0] + 1,) + shape, 7.0, np.float32)
        padded[:rows.shape[0]] = rows
        return PaddedBatch(torch.from_numpy(padded), rows.shape[0])

    def pad_jax(rows):
        padded = np.full((rows.shape[0] + 1,) + shape, 7.0, np.float32)
        padded[:rows.shape[0]] = rows
        return jax_stage.PaddedBatch(jnp.asarray(padded), rows.shape[0])

    got = _feed(ours, pad_torch, TimeCard, parts)
    want = _feed(ref, pad_jax, jax_telemetry.TimeCard, parts)
    assert len(got) == len(want) == 3
    for ((g,), g_nt, g_tcs), ((w,), w_nt, w_tcs) in zip(got, want):
        assert g_nt is None and w_nt is None
        assert g.valid == w.valid
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        assert isinstance(g_tcs, TimeCardList)
        assert [tc.id for tc in g_tcs.time_cards] == \
            [tc.id for tc in w_tcs.time_cards]
        assert [tc.pad_rows for tc in g_tcs.time_cards] == \
            [tc.pad_rows for tc in w_tcs.time_cards]
        if ragged:
            assert isinstance(g, RaggedBatch) and g.data.shape[0] == 6
            assert g.segment_offsets == tuple(w.segment_offsets)
            assert [tc.row0 for tc in g_tcs.time_cards] == \
                list(g.segment_offsets[:-1])
        else:
            assert type(g) is PaddedBatch and g.data.shape[0] in (4, 6)
            assert not g.data[g.valid:].any()
    assert ours.padding.snapshot() == ref.padding.snapshot()
    assert ours.ragged_stats == ref.ragged_stats
    assert Batcher.output_shape_for(**kwargs) == \
        jax_batcher.Batcher.output_shape_for(**kwargs)


def test_batcher_passes_through_and_refuses_oversize():
    rows = torch.zeros((2, FRAMES, 8, 8, 3))
    passing = Batcher(DeviceSpec(-1, "cpu"), max_rows=6,
                      consecutive_frames=FRAMES, frame_hw=8)
    card = TimeCard(0)
    tensors, nt, tc = passing((PaddedBatch(rows, 2),), "v", card)
    assert tensors[0].data is rows and nt == "v" and tc is card
    assert passing.flush() is None
    assert passing.padding.snapshot()["emissions"] == 0
    small = Batcher(DeviceSpec(-1, "cpu"), batch=2, max_rows=1,
                    consecutive_frames=FRAMES, frame_hw=8)
    with pytest.raises(ValueError, match="exceeding the stage max"):
        small((PaddedBatch(rows, 2),), "v", TimeCard(1))
    with pytest.raises(ValueError, match="row_buckets"):
        Batcher(DeviceSpec(-1, "cpu"), batch=2, max_rows=6,
                row_buckets=[2, 5])
    shaped = Batcher.output_shape_for(shapes=[[15, 2, 14, 14, 256]])
    assert shaped == ((15, 2, 14, 14, 256),)


def test_batcher_fuses_cards_of_an_upstream_fused_emission():
    # an upstream fusing stage delivers card lists: the fused batch
    # carries them flat, each with its first row in the fused batch
    b = Batcher(DeviceSpec(-1, "cpu"), batch=2, max_rows=6,
                consecutive_frames=FRAMES, frame_hw=8)
    cards = [TimeCard(i) for i in range(3)]
    for tc, (row0, n) in zip(cards, ((0, 1), (1, 2), (0, 2))):
        tc.row0, tc.num_clips = row0, n
    rows = torch.arange(5.0).reshape(5, 1, 1, 1, 1).expand(
        5, FRAMES, 8, 8, 3)
    assert b((PaddedBatch(rows[:3], 3),), None,
             TimeCardList(cards[:2]))[2] is None
    (fused,), _nt, tcs = b((PaddedBatch(rows[3:], 2),), None, cards[2])
    assert fused.valid == 5 and fused.data.shape[0] == 6
    assert [tc.id for tc in tcs.time_cards] == [0, 1, 2]
    assert [tc.row0 for tc in tcs.time_cards] == [0, 1, 3]
    assert torch.equal(fused.data[:5], rows)


# -- the unfused loader on pages ---------------------------------------

def test_loader_paged_hits_and_feature_hits_serve_the_first_rows(variables):
    # a paged hit is gathered over the zero pool and goes through the
    # same ragged normalize a miss feeds: bitwise the miss's emission. A
    # feature hit ships the stub and the runner gathers the stored
    # logits: bitwise the first serving's
    from rnb_tpu_torch.pager import Pager, PagerSettings
    loader = R2P1DLoader(CPU, cache_mb=4, ragged=True, ragged_pool_rows=3,
                         **LOADER)
    runner = R2P1DRunner(CPU, num_classes=CLASSES, layer_sizes=LS,
                         max_rows=3, consecutive_frames=FRAMES,
                         num_warmups=0, ragged=True, ragged_pool_rows=3,
                         ragged_chunk_rows=1,
                         network=_port_net(variables, 1, 5, torch.bfloat16))
    pager = Pager(PagerSettings(page_rows=2, pool_mb=2, feature_cache=True))
    loader.enable_pager(pager)
    runner.enable_pager(pager)
    assert loader._feature_stub.dtype == torch.bfloat16
    assert not loader._feature_stub.float().any()
    video = VIDEOS[1]  # three clips
    cards = [TimeCard(i) for i in range(3)]
    (miss,), _, _ = loader(None, video, cards[0])
    # before the runner stored any logits: a clip-page hit
    (hit,), _, _ = loader(None, video, cards[1])
    assert cards[0].num_clips == cards[1].num_clips == 3
    assert (cards[0].cache_hit, cards[1].cache_hit) == (False, True)
    assert torch.equal(hit.data.view(torch.int16),
                       miss.data.view(torch.int16))
    (first,), _, _ = runner((miss,), None, cards[0])
    assert cards[0].feature_insert is None  # taken by the runner
    handle = loader.submit(video, cards[2])
    (stub,), _, _ = loader.complete(handle, video, cards[2])
    assert cards[2].feature_hit and stub.data is loader._feature_stub
    (again,), _, _ = runner((stub,), None, cards[2])
    assert again.data.numpy().tobytes() == first.data.numpy().tobytes()
    snap = pager.snapshot()
    assert (snap["gathers"], snap["gather_rows"]) == (1, 3)
    assert (snap["feature_hits"], snap["feature_gathers"]) == (1, 1)
    assert snap["allocs"] == snap["frees"] + snap["live"]
    assert loader.ragged_stats["cache_hit_rows"] == 3
    assert loader.ragged_stats["emissions"] == 3
    # a feature hit that is never completed gives its pin back
    handle = loader.submit(video, TimeCard(9))
    assert handle.feature_plan is not None
    loader.discard(handle, video)
    assert handle.feature_plan is None
    with pytest.raises(ValueError, match="ragged"):
        R2P1DLoader(CPU, cache_mb=1, **LOADER).enable_pager(pager)
    with pytest.raises(ValueError, match="cache_mb"):
        R2P1DLoader(CPU, ragged=True, **LOADER).enable_pager(pager)
