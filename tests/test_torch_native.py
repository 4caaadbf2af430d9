"""The port's native decode pool against the JAX package's binding and
the port's numpy decoder, and the loaders that decode into staging rows.

* ``NativeY4MDecoder`` and ``DecodePool.submit_into`` (the port's own
  ctypes binding of ``native/decode.cpp``, built into the port's build
  directory) give the bytes of ``rnb_tpu.decode.native`` (when the JAX
  package's library is built) and of the port's numpy decoders, on
  seeded y4m files (rgb, yuv420) and on MJPEG written as
  ``tests/test_mjpeg.py`` writes it (dct), at clip starts that run past
  the end. Tolerance: none — the same integer and float arithmetic.
* A corrupt file raises the port's ``CorruptVideoError``.
* ``R2P1DFusingLoader`` on the native pool (each request decoded into
  its planned slot rows, no emission copy) emits batches byte-equal to
  its numpy-backed emissions (``RNB_DISABLE_NATIVE``): the same
  requests in the same rows, bucketed and ragged, with coalesced
  followers, paged and blob cache hits; pad rows of a bucketed emission
  are zero. ``depth`` bounds the in-flight window. The unfused loader's
  prefetch decodes into its slots likewise, and an aborted run waits
  every ticket and leaves no slot referenced.
"""

import os
import sys

import numpy as np
import pytest
import torch

from rnb_tpu.decode import write_mjpeg
from rnb_tpu.decode.native import NativeY4MDecoder as JaxNativeDecoder
from rnb_tpu.decode.native import native_available as jax_native_available
from rnb_tpu_torch.decode import (CorruptVideoError, MjpegPILDecoder,
                                  Y4MDecoder, get_decoder, write_y4m)
from rnb_tpu_torch.decode import native
from rnb_tpu_torch.devices import DeviceSpec
from rnb_tpu_torch.models.r2p1d.model import (R2P1DFusingLoader,
                                              R2P1DLoader)
from rnb_tpu_torch.ops import _kernels, _native
from rnb_tpu_torch.ops.dct import dct_frame_elems, num_dct_blocks
from rnb_tpu_torch.pager import Pager, PagerSettings
from rnb_tpu_torch.telemetry import TimeCard

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

from make_dataset import synth_frames  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = DeviceSpec(0, "cpu")
HW = 112
#: clip starts: in range, overlapping, and past the last frame (frames
#: past the end repeat the last one)
STARTS = [0, 3, 9, 30, 2, 5]
#: the full coefficient budget: no frame can exceed it
FULL_COEFFS = 64 * num_dct_blocks(HW, HW)


def _dataset(root, videos=4, frames=12, seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(videos):
        label = os.path.join(root, "label%d" % (i % 2))
        os.makedirs(label, exist_ok=True)
        path = os.path.join(label, "v%02d.y4m" % i)
        write_y4m(path, rng.integers(0, 256, (frames, HW, HW, 3),
                                     dtype=np.uint8), colorspace="420")
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def y4m_files(tmp_path_factory):
    return _dataset(str(tmp_path_factory.mktemp("y4m")))


@pytest.fixture(scope="module")
def mjpeg_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("mjpeg")
    paths = []
    for i in range(2):
        path = str(root / ("v%d.mjpg" % i))
        write_mjpeg(path, synth_frames(12, HW, HW, seed=[5, 1, i]),
                    quality=90)
        paths.append(path)
    return paths


def test_the_port_builds_its_own_library():
    native.load_native()
    path = _native.library_path()
    assert os.path.exists(path)
    # into the port's build directory, never the JAX package's
    assert os.path.dirname(path) == _kernels.BUILD_DIR
    assert _native.SOURCE == os.path.join(REPO, "native", "decode.cpp")
    assert _native.build() is None  # built once: nothing to do


@pytest.mark.parametrize("starts", [STARTS[:1], STARTS[:3], STARTS])
def test_rgb_and_yuv420_byte_equal_to_jax_native_and_numpy(y4m_files,
                                                           starts):
    path = y4m_files[0]
    ours = native.NativeY4MDecoder()
    numpy_dec = Y4MDecoder()
    assert ours.num_frames(path) == numpy_dec.num_frames(path) == 12
    rgb = ours.decode_clips(path, starts, 8, HW, HW)
    yuv = ours.decode_clips_yuv(path, starts, 8, HW, HW)
    np.testing.assert_array_equal(
        rgb, numpy_dec.decode_clips(path, starts, 8, HW, HW))
    np.testing.assert_array_equal(
        yuv, numpy_dec.decode_clips_yuv(path, starts, 8, HW, HW))
    if jax_native_available():
        ref = JaxNativeDecoder()
        np.testing.assert_array_equal(
            rgb, ref.decode_clips(path, starts, 8, HW, HW))
        np.testing.assert_array_equal(
            yuv, ref.decode_clips_yuv(path, starts, 8, HW, HW))
    # the pool, into a caller's buffer, chunk by chunk
    pool = native.DecodePool.shared()
    out = np.zeros_like(yuv)
    tickets = [pool.submit_into(path, starts[lo:lo + 2], 8,
                                out[lo:lo + 2], native.PIX_YUV420, HW, HW)
               for lo in range(0, len(starts), 2)]
    for ticket in tickets:
        pool.wait(ticket, path)
    np.testing.assert_array_equal(out, yuv)
    ticket, rgb_out = pool.submit(path, starts, 8, HW, HW)
    pool.wait(ticket, path)
    np.testing.assert_array_equal(rgb_out, rgb)
    with pytest.raises(ValueError, match="already-waited"):
        pool.wait(ticket, path)


def test_dct_over_mjpeg_byte_equal_to_jax_native_and_numpy(mjpeg_files):
    path = mjpeg_files[0]
    starts = [0, 6, 9]  # the last clip runs past the end
    ours = native.NativeY4MDecoder()
    assert ours.num_frames(path) == 12
    got = ours.decode_clips_dct(path, starts, 8, HW, HW, FULL_COEFFS)
    assert got.dtype == np.int16
    assert got.shape == (3, 8, dct_frame_elems(HW, HW, FULL_COEFFS))
    np.testing.assert_array_equal(
        got, MjpegPILDecoder().decode_clips_dct(path, starts, 8, HW, HW,
                                                FULL_COEFFS))
    if jax_native_available():
        np.testing.assert_array_equal(got, JaxNativeDecoder().
                                      decode_clips_dct(path, starts, 8, HW,
                                                       HW, FULL_COEFFS))
    pool = native.DecodePool.shared()
    out = np.empty_like(got)
    ticket = pool.submit_into(path, starts, 8, out, native.PIX_DCT, HW, HW)
    while not pool.peek(ticket):
        pass
    pool.wait(ticket, path)
    np.testing.assert_array_equal(out, got)


def test_corrupt_files_raise_the_ports_error(tmp_path, y4m_files):
    bad = tmp_path / "bad.y4m"
    bad.write_bytes(b"NOT A VIDEO AT ALL\n" * 4)
    decoder = native.NativeY4MDecoder()
    with pytest.raises(CorruptVideoError):
        decoder.num_frames(str(bad))
    with pytest.raises(CorruptVideoError):
        decoder.decode_clips_yuv(str(bad), [0], 8, HW, HW)
    pool = native.DecodePool.shared()
    out = np.empty((1, 8, HW * HW * 3 // 2), np.uint8)
    ticket = pool.submit_into(str(bad), [0], 8, out, native.PIX_YUV420,
                              HW, HW)
    with pytest.raises(CorruptVideoError):
        pool.wait(ticket, str(bad))
    # a y4m file holds no coefficients
    with pytest.raises(CorruptVideoError):
        decoder.decode_clips_dct(y4m_files[0], [0], 8, HW, HW)
    with pytest.raises(ValueError, match="bad output buffer"):
        pool.submit_into(y4m_files[0], [0, 1], 8, out, native.PIX_YUV420)


def test_get_decoder_takes_the_native_backend_and_the_switch(
        y4m_files, mjpeg_files, monkeypatch):
    assert get_decoder(y4m_files[0]).BACKEND == "native"
    assert get_decoder(mjpeg_files[0]) is get_decoder(y4m_files[0])
    assert get_decoder("synth://kinetics/video-0001").BACKEND == "synth"
    monkeypatch.setenv("RNB_DISABLE_NATIVE", "1")
    assert isinstance(get_decoder(y4m_files[0]), Y4MDecoder)
    assert isinstance(get_decoder(mjpeg_files[0]), MjpegPILDecoder)


# -- the fusing loader on the native pool --------------------------------

def _held_loader(**kwargs):
    """A fusing loader whose emission rules wait for ``flush``: the
    emissions then do not depend on when a decode finished."""
    loader = R2P1DFusingLoader(CPU, num_warmups=0, **kwargs)
    loader.depth = 1 << 20
    loader.poll = lambda: None
    return loader


def _serve(loader, videos, flush_after=()):
    """Admit ``videos`` in order (flushing after the indices in
    ``flush_after``) -> every emission as (card ids and stamps, valid,
    offsets, batch bytes)."""
    emissions = []

    def keep(out):
        (batch,), _, tcs = out
        emissions.append((
            [(tc.id, tc.row0, tc.num_clips, tc.cache_hit,
              tc.cache_coalesced) for tc in tcs.time_cards],
            batch.valid, getattr(batch, "segment_offsets", None),
            batch.data))

    for i, video in enumerate(videos):
        out = loader(None, video, TimeCard(i))
        if out[2] is not None:
            keep(out)
        if i in flush_after:
            while (out := loader.flush()) is not None:
                keep(out)
    while (out := loader.flush()) is not None:
        keep(out)
    loader.discard_pending()
    return emissions


def _assert_same_emissions(got, want, ragged):
    assert len(got) == len(want)
    for (cards, valid, offsets, data), (wcards, wvalid, woffsets,
                                        wdata) in zip(got, want):
        assert (cards, valid, offsets) == (wcards, wvalid, woffsets)
        assert data.shape == wdata.shape and data.dtype == wdata.dtype
        # a ragged pool's tail is never written (the ingest reads no row
        # past rows_valid); a bucketed emission's pad rows are zeros
        rows = valid if ragged else data.shape[0]
        assert torch.equal(data[:rows], wdata[:rows])
        if not ragged:
            assert not data[valid:].any()


@pytest.mark.parametrize("pixel_path,ragged", [("yuv420", False),
                                               ("yuv420", True),
                                               ("rgb", True)])
def test_fusing_loader_native_emissions_equal_numpy_ones(
        y4m_files, monkeypatch, pixel_path, ragged):
    a, b, c, d = y4m_files
    # a miss, its coalesced follower, more misses; then (after the first
    # flush put A into the cache) hits of A and C among misses
    videos = [a, a, b, c, d, b, a, c, d, a]
    kwargs = dict(fuse=3, max_clips=15, pixel_path=pixel_path,
                  row_buckets=[3, 6, 15], cache_mb=64, ragged=ragged,
                  ragged_pool_rows=15 if ragged else None)

    def run():
        loader = _held_loader(**kwargs)
        if ragged:
            loader.enable_pager(Pager(PagerSettings(page_rows=2,
                                                    pool_mb=64)))
        emissions = _serve(loader, videos, flush_after=(4,))
        return loader, emissions

    loader, got = run()
    assert loader.ingest_stats["backends"] == {"native"}
    monkeypatch.setenv("RNB_DISABLE_NATIVE", "1")
    numpy_loader, want = run()
    assert numpy_loader.ingest_stats["backends"] == {"y4m"}
    _assert_same_emissions(got, want, ragged)
    stamps = [card for emission in got for card in emission[0]]
    assert any(coalesced for *_, coalesced in stamps)
    assert any(hit for *_, hit, _ in stamps)
    snap, numpy_snap = loader.staging.snapshot(), numpy_loader.staging.\
        snapshot()
    # every emission's rows came from the slots; on the native pool no
    # host copy placed a decoded row there (numpy decodes are copied in;
    # a paged hit's rows are gathered on the device)
    for s in (snap, numpy_snap):
        assert s["staged_batches"] + s["copied_batches"] == s["transfers"]
    assert snap["transfers"] == numpy_snap["transfers"]
    assert snap["copied_batches"] == 0 < numpy_snap["copied_batches"]
    for slot in loader.staging._slots + numpy_loader.staging._slots:
        assert slot.refs == 0


def test_fusing_loader_dct_on_mjpeg_native_equals_numpy(mjpeg_files,
                                                        monkeypatch):
    videos = mjpeg_files + mjpeg_files[:1]
    kwargs = dict(fuse=2, max_clips=6, pixel_path="dct", ragged=True,
                  ragged_pool_rows=6, dct_coeffs_per_frame=FULL_COEFFS)
    got = _serve(_held_loader(**kwargs), videos)
    monkeypatch.setenv("RNB_DISABLE_NATIVE", "1")
    want = _serve(_held_loader(**kwargs), videos)
    _assert_same_emissions(got, want, ragged=True)
    assert sum(e[1] for e in got) > 0


def test_depth_bounds_the_inflight_window(y4m_files, monkeypatch):
    from concurrent.futures import Future

    class LazyPool:
        """Decodes run when their result is first asked for."""

        def __init__(self):
            self.waited = 0

        def submit(self, fn, *args):
            pool = self

            class Lazy(Future):
                def done(self):
                    return False

                def result(self, timeout=None):
                    if not super().done():
                        pool.waited += 1
                        self.set_result(fn(*args))
                    return super().result()
            return Lazy()

        def shutdown(self, wait=True, cancel_futures=False):
            del wait, cancel_futures

    monkeypatch.setenv("RNB_DISABLE_NATIVE", "1")
    assert R2P1DFusingLoader(CPU, fuse=5, num_warmups=0).depth == 10
    loader = R2P1DFusingLoader(CPU, fuse=5, depth=2, num_warmups=0,
                               max_clips=15, pixel_path="yuv420",
                               max_hold_ms=1e9)
    loader._decode_pool = LazyPool()
    for i, video in enumerate(y4m_files * 2):
        loader(None, video, TimeCard(i))
        assert len(loader._inflight) < loader.depth
        # a decode is waited for only once the window is full
        assert loader._decode_pool.waited == max(0, i + 2 - loader.depth)
    loader.discard_pending()


def test_unfused_loader_prefetch_decodes_into_its_slots(y4m_files,
                                                        monkeypatch):
    def serve(abort=False):
        loader = R2P1DLoader(CPU, num_warmups=0, prefetch=2,
                             pixel_path="yuv420", row_buckets=[3, 15],
                             cache_mb=64)
        cards = [TimeCard(i) for i in range(4)]
        videos = [y4m_files[0], y4m_files[1], y4m_files[0], y4m_files[2]]
        handles = [loader.submit(v, tc) for v, tc in zip(videos, cards)]
        if abort:
            for handle, video in zip(handles, videos):
                loader.discard(handle, video)
            return loader, None
        out = [loader.complete(h, v, tc)[0][0].data
               for h, v, tc in zip(handles, videos, cards)]
        return loader, out

    loader, got = serve()
    assert loader.staging is not None
    assert loader.staging.snapshot()["staged_batches"] == 4
    assert loader.ingest_stats["backends"] == {"native"}
    aborted, _ = serve(abort=True)
    for slot in loader.staging._slots + aborted.staging._slots:
        assert slot.refs == 0
    monkeypatch.setenv("RNB_DISABLE_NATIVE", "1")
    numpy_loader, want = serve()
    assert numpy_loader.staging is None
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fusing_loader_warms_the_native_decode_before_the_window(
        y4m_files, monkeypatch):
    # as the reference's loaders do: the library is loaded and the pool
    # started while the stage is built, not by the first request
    monkeypatch.setenv("RNB_TPU_DATA_ROOT",
                       os.path.dirname(os.path.dirname(y4m_files[0])))
    loader = R2P1DFusingLoader(CPU, num_warmups=1, fuse=2, max_clips=15,
                               pixel_path="yuv420")
    assert native.DecodePool._shared is not None
    assert loader._starts_cache and set(loader._starts_cache) <= set(
        y4m_files)
    assert loader.ingest_stats["backends"] == set()  # served nothing
    loader.discard_pending()
