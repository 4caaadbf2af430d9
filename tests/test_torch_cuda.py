"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card (marker ``cuda``) and skip without one.
The file imports no jax, so it also runs on a machine that has PyTorch
for CUDA and no JAX; there, skip the repo's jax-configuring conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rnb_tpu_torch.cache import ClipCache
from rnb_tpu_torch.decode import SyntheticDecoder
from rnb_tpu_torch.ops import _kernels, dct, handoff_dma
from rnb_tpu_torch.ops.pages import gather_rows, gather_rows_reference
from rnb_tpu_torch.ops.preprocess import (normalize_u8, normalize_u8_reference,
                                          normalize_u8_rows)
from rnb_tpu_torch.ops.ragged import (ragged_normalize_u8,
                                      ragged_normalize_u8_reference)
from rnb_tpu_torch.ops.yuv import (packed_frame_bytes, yuv420_normalize,
                                   yuv420_to_rgb_u8)
from rnb_tpu_torch.pager import Pager, PagerSettings

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    # the plain dct convert multiplies in float32: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _packed(rows, seed, h=112, w=112):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (rows, 8, packed_frame_bytes(h, w)), dtype=np.uint8))


def test_kernels_match_plain_versions_on_card(device):
    # tolerance: the colourspace kernel within one u8 step of its plain
    # version (the reference's own bound; exact in practice), pad rows
    # exactly the conversion of zero bytes; the normalize bitwise
    for rows in (15, 4):
        packed = _packed(rows, seed=rows)
        for valid in (rows, 2, 0):
            rgb = yuv420_to_rgb_u8(packed.to(device), 112, 112, valid)
            plain = yuv420_to_rgb_u8(packed, 112, 112, valid)
            assert (rgb.cpu().int() - plain.int()).abs().max() <= 1
            assert torch.equal(rgb.cpu()[valid:], plain[valid:])
            out = normalize_u8_rows(rgb, valid)
            assert torch.equal(out.cpu().view(torch.int16),
                               normalize_u8_rows(rgb.cpu(), valid)
                               .view(torch.int16))


def test_wrappers_count_launches_and_refuse_what_kernels_cannot_take(
        device):
    _kernels.reset_launches()
    packed = _packed(2, seed=0, h=16, w=16).to(device)
    rgb = yuv420_to_rgb_u8(packed, 16, 16)
    normalize_u8(rgb)
    torch.cuda.synchronize(device)
    assert _kernels.launch_counts() == {"normalize_u8": 1,
                                        "yuv420_to_rgb_u8": 1,
                                        "yuv420_normalize": 0,
                                        "dct_unpack": 0, "dct_convert": 0,
                                        "dct_ingest": 0,
                                        "gather_rows": 0,
                                        "ragged_normalize_u8": 0,
                                        "ring_shift": 0}
    with pytest.raises(TypeError):
        normalize_u8(rgb.float())                     # not uint8
    with pytest.raises(ValueError):
        normalize_u8(rgb.transpose(2, 3))             # not contiguous
    with pytest.raises(ValueError):
        normalize_u8(rgb.view(-1)[1:33].view(2, 16))  # not 16-byte aligned
    with pytest.raises(ValueError):
        yuv420_to_rgb_u8(packed[:, :, :-2], 16, 16)   # wrong plane size
    wire = torch.zeros((2, 8, 4704), dtype=torch.int16, device=device)
    dct.ragged_normalize_dct(wire, 1, 112, 112)
    torch.cuda.synchronize(device)
    with pytest.raises(TypeError):
        dct.unpack_dct_rows(wire.int(), 112, 112)          # not int16
    with pytest.raises(ValueError):
        dct.unpack_dct_rows(wire.transpose(0, 1), 112, 112)  # strided
    with pytest.raises(TypeError):
        dct.normalize_dct(wire, 112, 112, torch.float16)   # no fp16 out
    assert _kernels.launch_counts() == {"normalize_u8": 1,
                                        "yuv420_to_rgb_u8": 1,
                                        "yuv420_normalize": 0,
                                        "dct_unpack": 0, "dct_convert": 0,
                                        "dct_ingest": 1,
                                        "gather_rows": 0,
                                        "ragged_normalize_u8": 0,
                                        "ring_shift": 0}


def test_ragged_normalize_kernel_reads_rows_valid_from_the_card(device):
    # tolerance: none. Valid rows are bitwise the plain version and the
    # bucketed normalize kernel; pad rows are exactly zero whatever the
    # pool tail holds; rows_valid is clamped to [0, rows]
    rng = np.random.default_rng(21)
    for shape in ((15, 8, 112, 112, 3), (5, 3, 7, 3), (4, 33)):
        pool = torch.from_numpy(rng.integers(0, 256, shape,
                                             dtype=np.uint8)).to(device)
        rows = shape[0]
        scalar = torch.zeros((1,), dtype=torch.int32, device=device)
        _kernels.reset_launches()
        for valid in (0, 1, rows // 2, rows - 1, rows, rows + 3, -2):
            # one device scalar rewritten between launches: the launch
            # arguments stay the same
            scalar.fill_(valid)
            got = ragged_normalize_u8(pool, scalar)
            want = ragged_normalize_u8_reference(pool, valid)
            assert got.dtype == torch.bfloat16 and got.shape == pool.shape
            assert torch.equal(got.view(torch.int16),
                               want.view(torch.int16))
            clamped = max(0, min(valid, rows))
            assert not got[clamped:].float().any()
            # the int form writes the scalar to the card itself
            assert torch.equal(ragged_normalize_u8(pool, valid)
                               .view(torch.int16), got.view(torch.int16))
        assert _kernels.RAGGED_NORMALIZE_U8.launches == 14
        assert _kernels.NORMALIZE_U8.launches == 0
    pool = torch.from_numpy(rng.integers(
        0, 256, (15, 8, 112, 112, 3), dtype=np.uint8)).to(device)
    assert torch.equal(ragged_normalize_u8(pool, 15).view(torch.int16),
                       normalize_u8(pool).view(torch.int16))
    # an unaligned pool start goes through the byte loop
    odd = pool.view(-1)[1:1 + 4 * 1000].view(4, 1000)
    assert torch.equal(ragged_normalize_u8(odd, 3).view(torch.int16),
                       ragged_normalize_u8_reference(odd, 3)
                       .view(torch.int16))
    with pytest.raises(TypeError):
        ragged_normalize_u8(pool.float(), 1)                 # not uint8
    with pytest.raises(ValueError):
        ragged_normalize_u8(pool.transpose(2, 3), 1)         # strided
    with pytest.raises(ValueError):
        ragged_normalize_u8(pool, torch.zeros(1, dtype=torch.int32))  # host
    with pytest.raises(ValueError):
        ragged_normalize_u8(pool, torch.zeros(1, dtype=torch.int64,
                                              device=device))
    with pytest.raises(TypeError):
        ragged_normalize_u8(pool, 1, torch.float16)


def test_fused_yuv420_entry_is_bitwise_k1_of_the_u8_entry(device):
    # tolerance: none. bf16 out is bitwise rnb_normalize_u8 of the u8
    # entry's output over every row (pad rows are the conversion of zero
    # bytes), float32 out bitwise the plain normalize of it; one device
    # scalar is rewritten between launches with the same arguments, and
    # the int form gives the same bytes
    scalar = torch.zeros((1,), dtype=torch.int32, device=device)
    for rows in (15, 4):
        packed = _packed(rows, seed=30 + rows).to(device)
        _kernels.reset_launches()
        for valid in (rows, 2, 0, rows + 3, -1):
            scalar.fill_(valid)
            rgb = yuv420_to_rgb_u8(packed, 112, 112, scalar)
            plain = yuv420_to_rgb_u8(packed.cpu(), 112, 112,
                                     max(0, min(valid, rows)))
            assert (rgb.cpu().int() - plain.int()).abs().max() <= 1
            fused = yuv420_normalize(packed, 112, 112, scalar)
            assert torch.equal(fused.view(torch.int16),
                               normalize_u8(rgb).view(torch.int16))
            assert torch.equal(yuv420_normalize(packed, 112, 112, valid)
                               .view(torch.int16), fused.view(torch.int16))
            f32 = yuv420_normalize(packed, 112, 112, scalar, torch.float32)
            assert torch.equal(f32, normalize_u8_reference(rgb,
                                                           torch.float32))
        assert _kernels.YUV420_NORMALIZE.launches == 15
        assert _kernels.YUV420_TO_RGB_U8.launches == 5
    with pytest.raises(TypeError):
        yuv420_normalize(packed, 112, 112, None, torch.float16)
    with pytest.raises(ValueError):
        yuv420_normalize(packed, 112, 112, scalar.cpu())        # host
    with pytest.raises(ValueError):
        yuv420_normalize(packed, 112, 112, scalar.long())       # int64


def test_yuv420_scalar_path_at_widths_not_a_multiple_of_16(device):
    # tolerance: the u8 entry within one step of its plain version, pad
    # rows exact; the fused entry bitwise the normalize of it. A pool
    # view one byte off 16-byte alignment takes the scalar path too
    rng = np.random.default_rng(31)
    for h, w in ((66, 90), (10, 18), (16, 40)):
        packed = torch.from_numpy(rng.integers(
            0, 256, (5, 3, packed_frame_bytes(h, w)), dtype=np.uint8))
        card = packed.to(device)
        for valid in (5, 2):
            rgb = yuv420_to_rgb_u8(card, h, w, valid)
            plain = yuv420_to_rgb_u8(packed, h, w, valid)
            assert (rgb.cpu().int() - plain.int()).abs().max() <= 1
            assert torch.equal(rgb.cpu()[valid:], plain[valid:])
            fused = yuv420_normalize(card, h, w, valid)
            assert torch.equal(fused.view(torch.int16),
                               normalize_u8_reference(rgb)
                               .view(torch.int16))
    flat = torch.from_numpy(rng.integers(
        0, 256, 2 * 8 * packed_frame_bytes(32, 32) + 1,
        dtype=np.uint8)).to(device)
    odd = flat[1:].view(2, 8, packed_frame_bytes(32, 32))
    assert (yuv420_to_rgb_u8(odd, 32, 32).cpu().int()
            - yuv420_to_rgb_u8(odd.cpu(), 32, 32).int()).abs().max() <= 1


def _u8(x):
    """Normalized frames back to u8 steps: (x*255 + 255) / 2."""
    return torch.round((x.float() * 255.0 + 255.0) / 2.0)


def _dct_pool(rows, seed):
    """Synthetic spectra, random well-formed rows over all 64 positions,
    and a random-int16 garbage tail, one third each."""
    rng = np.random.default_rng(seed)
    nb = dct.num_dct_blocks(112, 112)
    third = max(1, rows // 3)
    pool = np.empty((rows, 8, dct.dct_frame_elems(112, 112)), np.int16)
    pool[:third] = SyntheticDecoder().decode_clips_dct(
        "synth://card-%d" % seed, list(range(third)), 8, 112, 112)
    for r in range(third, rows - third):
        for f in range(8):
            zz = np.where(rng.random((nb, 64)) < 0.1,
                          rng.integers(-900, 900, (nb, 64)), 0)
            pool[r, f] = dct.pack_frame_dct(zz, 112, 112)
    pool[rows - third:] = rng.integers(-32768, 32768,
                                       pool[rows - third:].shape)
    return torch.from_numpy(pool)


def test_dct_kernels_match_plain_versions_on_card(device):
    # tolerance: the unpack bitwise on every row it writes (rows past
    # rows_valid are not written); the convert within two u8 steps
    # (one step per quantized plane, carried through BT.601's 1.772;
    # tests/test_torch_dct.py) with at least 99% exact, pad rows exact
    # zeros, in both output dtypes
    for rows in (15, 4):
        pool = _dct_pool(rows, seed=rows)
        card = pool.to(device)
        plain_planes = dct.unpack_dct_rows(pool, 112, 112)
        for valid in (rows, 2, 0):
            planes = dct.unpack_dct_rows(card, 112, 112, valid)
            for got, want in zip(planes, plain_planes):
                assert torch.equal(got[:valid].cpu(), want[:valid])
            for dtype in (torch.bfloat16, torch.float32):
                out = dct.dct_convert(*planes, valid, 112, 112, dtype)
                plain = dct.dct_convert_reference(
                    *(p.to(device) for p in plain_planes), valid, 112, 112,
                    dtype)
                assert out.dtype == dtype
                steps = (_u8(out) - _u8(plain)).abs()
                assert float(steps.max()) <= 2
                assert float((out == plain).double().mean()) >= 0.99
                assert not out[valid:].float().any()


def test_dct_convert_at_two_widths_reads_rows_valid_from_the_card(device):
    # tolerance as above; one device scalar rewritten between launches
    # with the same arguments; 176 is wider than one round of the load
    # phase
    rng = np.random.default_rng(32)
    scalar = torch.zeros((1,), dtype=torch.int32, device=device)
    for h, w in ((112, 112), (64, 176)):
        nb = dct.num_dct_blocks(h, w)
        pool = np.empty((6, 4, dct.dct_frame_elems(h, w)), np.int16)
        for r in range(6):
            for f in range(4):
                zz = np.where(rng.random((nb, 64)) < 0.05,
                              rng.integers(-900, 900, (nb, 64)), 0)
                pool[r, f] = dct.pack_frame_dct(zz, h, w)
        planes = [p.to(device) for p in dct.unpack_dct_rows(
            torch.from_numpy(pool), h, w)]
        for valid in (6, 3, 0):
            scalar.fill_(valid)
            for dtype in (torch.bfloat16, torch.float32):
                out = dct.dct_convert(*planes, scalar, h, w, dtype)
                plain = dct.dct_convert_reference(*planes, valid, h, w,
                                                  dtype)
                assert float((_u8(out) - _u8(plain)).abs().max()) <= 2
                assert float((out == plain).double().mean()) >= 0.99
                assert not out[valid:].float().any()
                assert torch.equal(dct.dct_convert(*planes, valid, h, w,
                                                   dtype), out)


def test_dct_ingest_is_bitwise_the_two_kernels_on_card(device):
    # tolerance: none against rnb_dct_unpack followed by rnb_dct_convert
    # (the same arithmetic after the load phase), in both dtypes; against
    # the plain version two u8 steps with at least 99% exact, as for the
    # convert; pad rows exact zeros whatever the pool tail holds. One
    # device scalar is rewritten between launches with the same
    # arguments (clamped to [0, rows]), and the int form gives the same
    # bytes; 64x176 is wider than one round of the load phase
    rng = np.random.default_rng(41)
    scalar = torch.zeros((1,), dtype=torch.int32, device=device)
    wide = np.empty((4, 3, dct.dct_frame_elems(64, 176)), np.int16)
    nb = dct.num_dct_blocks(64, 176)
    for r in range(3):
        for f in range(3):
            zz = np.where(rng.random((nb, 64)) < 0.05,
                          rng.integers(-900, 900, (nb, 64)), 0)
            wide[r, f] = dct.pack_frame_dct(zz, 64, 176)
    wide[3] = rng.integers(-32768, 32768, wide[3].shape)
    for pool, h, w in ((_dct_pool(15, seed=40), 112, 112),
                       (_dct_pool(4, seed=44), 112, 112),
                       (torch.from_numpy(wide), 64, 176)):
        card = pool.to(device)
        rows = int(pool.shape[0])
        _kernels.reset_launches()
        for valid in (rows, 2, 0, rows + 3, -1):
            scalar.fill_(valid)
            n = max(0, min(valid, rows))
            planes = dct.unpack_dct_rows(card, h, w, n)
            for dtype in (torch.bfloat16, torch.float32):
                bits = (torch.int16 if dtype == torch.bfloat16
                        else torch.int32)
                one = dct.ragged_normalize_dct(card, scalar, h, w, dtype)
                two = dct.dct_convert(*planes, scalar, h, w, dtype)
                assert one.dtype == dtype
                assert torch.equal(one.view(bits), two.view(bits))
                assert torch.equal(dct.ragged_normalize_dct(
                    card, valid, h, w, dtype).view(bits), one.view(bits))
                plain = dct.dct_ingest_reference(card, n, h, w, dtype)
                assert float((_u8(one) - _u8(plain)).abs().max()) <= 2
                assert float((one == plain).double().mean()) >= 0.99
                assert not one[n:].float().any()
        assert _kernels.DCT_INGEST.launches == 20


def _gather_tables(pool_rows, slab_rows, seed):
    """Source tables: all sentinels, all hits, mixed, duplicate sources,
    and the slab's last row (plus an index past it, clamped)."""
    rng = np.random.default_rng(seed)
    mixed = rng.integers(-1, slab_rows, pool_rows)
    return {"all_miss": np.full(pool_rows, -1),
            "all_hit": rng.integers(0, slab_rows, pool_rows),
            "mixed": mixed,
            "duplicates": np.where(mixed >= 0, 3, -1),
            "last_row": np.where(np.arange(pool_rows) % 2, slab_rows - 1,
                                 slab_rows + 5)}


def test_gather_kernel_is_bitwise_its_plain_version(device):
    # bitwise: the kernel moves bytes. The clip rows (150,528 B, 10
    # chunks of 16 KiB), the feature rows (1,600 B), a 7-byte row (the
    # byte loop), and a slab view that starts 1 byte off alignment
    rng = np.random.default_rng(5)
    shapes = (((15, 8, 18816), np.uint8, 400), ((15, 400), np.float32, 64),
              ((9, 7), np.uint8, 30))
    for shape, dtype, slab_rows in shapes:
        if dtype == np.uint8:
            pool = rng.integers(0, 256, shape, dtype=np.uint8)
            slab = rng.integers(0, 256, (slab_rows,) + shape[1:],
                                dtype=np.uint8)
        else:
            pool = rng.standard_normal(shape).astype(dtype)
            slab = rng.standard_normal((slab_rows,) + shape[1:]).astype(
                dtype)
        pool_d = torch.from_numpy(pool).to(device)
        slab_d = torch.from_numpy(slab).to(device)
        for name, table in _gather_tables(shape[0], slab_rows, 1).items():
            src = table.astype(np.int32)
            out = gather_rows(pool_d, slab_d, src)
            plain = gather_rows_reference(pool_d, slab_d, src)
            assert out.cpu().numpy().tobytes() == \
                plain.cpu().numpy().tobytes(), (shape, name)
    flat = torch.from_numpy(rng.integers(0, 256, 30 * 7 + 1,
                                         dtype=np.uint8)).to(device)
    odd = flat[1:].view(30, 7)
    pool = torch.zeros((9, 7), dtype=torch.uint8, device=device)
    src = _gather_tables(9, 30, 2)["mixed"].astype(np.int32)
    assert torch.equal(gather_rows(pool, odd, src),
                       gather_rows_reference(pool, odd, src))


def test_gather_wrapper_counts_launches_and_refuses(device):
    _kernels.reset_launches()
    pool = torch.zeros((4, 400), dtype=torch.float32, device=device)
    slab = torch.ones((8, 400), dtype=torch.float32, device=device)
    src = np.asarray([0, -1, 7, 3], np.int32)
    gather_rows(pool, slab, src)
    gather_rows(pool, slab, torch.from_numpy(src).to(device))
    torch.cuda.synchronize(device)
    assert _kernels.GATHER_ROWS.launches == 2
    with pytest.raises(ValueError):
        gather_rows(pool, slab.cpu(), src)               # two devices
    with pytest.raises(TypeError):
        gather_rows(pool, slab.half(), src)              # two dtypes
    with pytest.raises(ValueError):
        gather_rows(pool, slab[:, :200], src)            # row shapes
    with pytest.raises(ValueError):
        gather_rows(pool, slab[:0], src)                 # empty slab
    with pytest.raises(ValueError):
        gather_rows(pool, slab.t().contiguous().t(), src)  # strided
    with pytest.raises(ValueError):
        gather_rows(pool, slab, torch.from_numpy(src).long().to(device))
    with pytest.raises(ValueError):
        gather_rows(pool, slab, src[:3])                 # table length
    assert _kernels.GATHER_ROWS.launches == 2


def test_arena_orders_a_gather_before_a_later_write_of_its_page(device):
    # the slab is written in place: a gather issued, its plan released,
    # its page evicted and rewritten by an insert, all without a host
    # sync -- the gather must still return the old rows, because the
    # arena runs every gather and write on its one stream, in order
    rng = np.random.default_rng(9)
    pager = Pager(PagerSettings(page_rows=1))
    arena = pager.create_arena("clips", (8, 18816), torch.uint8,
                               budget_bytes=8 * 18816, device=device)
    assert arena.num_pages == 1
    cache = ClipCache(1.0, device=device)
    cache.attach_arena(arena)
    for trial in range(5):
        old, new = (torch.from_numpy(rng.integers(
            0, 256, (1, 8, 18816), dtype=np.uint8)).to(device)
            for _ in range(2))
        assert cache.insert_pages(("old", trial), old, 0, 1)
        plan = cache.acquire(("old", trial))
        dest = torch.zeros((15, 8, 18816), dtype=torch.uint8, device=device)
        out = arena.gather(dest, np.full(15, plan.src_rows[0], np.int32))
        plan.release()
        assert cache.insert_pages(("new", trial), new, 0, 1)  # same page
        torch.cuda.synchronize(device)
        assert torch.equal(out, old.expand(15, 8, 18816)), trial
        assert torch.equal(arena._slab[0], new[0])
        cache.acquire(("new", trial)).release()
        with pager.lock:  # empty the cache for the next trial
            cache._entries.clear()
            arena.free_locked((0,))
    snap = pager.snapshot()
    assert snap["gathers"] == 5 and snap["limbo"] == 0


# -- the runner's captured forward ----------------------------------------

def _graph_runner(device, **kwargs):
    from rnb_tpu_torch.devices import DeviceSpec
    from rnb_tpu_torch.models.r2p1d.model import R2P1DRunner
    return R2P1DRunner(DeviceSpec(device.index or 0), num_classes=10,
                       layer_sizes=(1, 1, 1, 1), num_warmups=1, **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(max_rows=6, row_buckets=[3, 6], pixel_path="yuv420"),
    dict(max_rows=6, pixel_path="yuv420", ragged=True, ragged_pool_rows=6,
         ragged_chunk_rows=2),
    dict(max_rows=6, pixel_path="dct", ragged=True, ragged_pool_rows=6,
         ragged_chunk_rows=3),
], ids=["yuv420-bucketed", "yuv420-ragged", "dct-ragged"])
def test_every_graph_replays_bitwise_its_eager_forward(device, kwargs):
    # tolerance: none — the same kernels on the same input; a capture
    # only records them
    runner = _graph_runner(device, **kwargs)
    keys = runner.graph_keys()
    assert runner.graph_stats["graphs"] == len(keys) >= 2
    _kernels.reset_launches()
    for i, (((shape, _),), tiles) in enumerate(keys):
        rows = shape[0]
        if kwargs["pixel_path"] == "dct":
            x = _dct_pool(rows, seed=50 + i).to(device)
        else:
            x = _packed(rows, seed=50 + i).to(device)
        valid = rows if tiles is None else min(
            rows, tiles * runner.ragged_chunk_rows) - 1
        assert runner.graph_key(x, valid) == keys[i]
        replayed = runner.forward(x, valid)
        eager = runner.eager_forward(x, valid)
        torch.cuda.synchronize(device)
        assert torch.equal(replayed, eager), keys[i]
    # one ingest per replay, counted as the eager forward counts it
    ingest = "dct_ingest" if kwargs["pixel_path"] == "dct" \
        else "yuv420_normalize"
    assert _kernels.launch_counts()[ingest] == 2 * len(keys)
    assert runner.graph_stats["replays"] == len(keys)
    # the replay's output is a copy: the next replay leaves it alone
    first = runner.forward(x, valid)
    again = first.clone()
    runner.forward(torch.zeros_like(x), valid)
    torch.cuda.synchronize(device)
    assert torch.equal(first, again)


def test_a_new_signature_is_captured_and_counted(device):
    runner = _graph_runner(device, max_rows=6, row_buckets=[3, 6],
                           pixel_path="yuv420")
    runner.compiles.freeze()
    x = _packed(4, seed=60).to(device)  # no bucket declared 4 rows
    from rnb_tpu_torch.stage import PaddedBatch
    (out,), _, _ = runner((PaddedBatch(x, 4),), None, None)
    torch.cuda.synchronize(device)
    assert torch.equal(out.data, runner.eager_forward(x, 4))
    assert runner.graph_stats["graphs"] == 3
    assert runner.compiles.snapshot()["steady_new"] == 1


def test_a_failing_capture_raises(device):
    runner = _graph_runner(device, max_rows=3, row_buckets=[3],
                           pixel_path="yuv420")
    network = runner.network

    class Syncs(torch.nn.Module):
        """A forward that reads a value back to the host: not
        capturable."""

        def forward(self, x):
            out = network(x)
            if float(out.sum()) != float(out.sum()):
                raise AssertionError("unreachable")
            return out

    runner.network = Syncs()
    runner._graphs.clear()
    with pytest.raises(RuntimeError):
        runner.forward(_packed(3, seed=61).to(device), 3)
    torch.cuda.synchronize(device)


def test_a_devobs_capture_sees_the_graph_replayed_kernels(device):
    """A capture opened from another thread after the runner captured its
    graphs (the devobs worker's pattern) records the kernels those
    graphs replay on this one, the yuv420 kernel among them, on
    ``/device:GPU:<index>``."""
    import threading

    from rnb_tpu_torch import profiler
    runner = _graph_runner(device, max_rows=6, row_buckets=[3, 6],
                           pixel_path="yuv420")
    x = _packed(6, seed=70).to(device)
    opened, done = threading.Event(), threading.Event()
    captured = {}

    def capture():
        profiler.initialize()
        opened.set()
        done.wait(timeout=60)
        profiler.flush()
        captured["ops"] = profiler.report(include_plane=True)
    worker = threading.Thread(target=capture)
    worker.start()
    try:
        assert opened.wait(timeout=120)
        for _ in range(3):
            runner.forward(x, 6)
        torch.cuda.synchronize(device)
    finally:
        done.set()
        worker.join(timeout=120)
    assert not worker.is_alive()
    plane = "/device:GPU:%d" % (device.index or 0)
    ops = captured["ops"]
    assert ops and {op[3] for op in ops} == {plane}
    assert sum("yuv420_kernel" in op[0] for op in ops) == 3
    assert all(t1 >= t0 >= 0 for _name, t0, t1, _plane in ops)
    assert runner.graph_stats["replays"] == 3


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16,
                                   torch.float32])
def test_ring_shift_kernel_is_bitwise_its_plain_version(device, dtype):
    # tolerance: none (the hop moves bytes): every degree and shift, a
    # channels-last conv kernel's shards, and an odd byte count
    gen = torch.Generator().manual_seed(7)
    for degree in (2, 4, 8):
        for shape in ((256, 1152, 3, 1, 1), (15, 200), (1001,)):
            shards = [torch.randint(0, 256, shape, generator=gen,
                                    dtype=torch.uint8).to(dtype)
                      for _ in range(degree)]
            if len(shape) == 5:
                shards = [s.contiguous(memory_format=torch.channels_last_3d)
                          for s in shards]
            for shift in range(1, degree):
                before = _kernels.RING_SHIFT.launches
                got = handoff_dma.ring_shift([s.to(device) for s in shards],
                                             shift)
                assert _kernels.RING_SHIFT.launches == before + 1
                want = handoff_dma.ring_shift_reference(shards, shift)
                for g, w in zip(got, want):
                    assert g.stride() == w.stride()
                    assert torch.equal(g.cpu(), w)


def test_ring_shift_kernel_on_a_misaligned_view_and_refusals(device):
    base = torch.randint(0, 256, (2, 40007), dtype=torch.uint8,
                         device=device)
    # 1 and 3 bytes off 16-byte alignment: the byte loop
    members = [base[0, 1:40001], base[1, 3:40003]]
    got = handoff_dma.ring_shift(members, 1)
    torch.cuda.synchronize(device)
    assert torch.equal(got[1], members[0]) and torch.equal(got[0],
                                                           members[1])
    with pytest.raises(ValueError, match="one dense block"):
        handoff_dma.ring_shift([base[:, ::2], base[:, 1::2]], 1)
    with pytest.raises(ValueError, match="within one card"):
        handoff_dma.ring_shift([base[0], base[1].cpu()], 1)
    with pytest.raises(ValueError, match="one dtype and shape"):
        handoff_dma.ring_shift([base[0], base[1, :5]], 1)


#: buffers of a grouped table on the card: (shard shape, dtype, the
#: destination tensor's shape, its slot): a channels-last conv kernel's
#: dim-0 slot, a float32 merge block's column block at a pitch, odd bytes
#: one byte off 16-byte alignment, and 13-byte rows at a pitch
_CARD_SLOTS = (
    ((256, 144, 3, 1, 1), torch.bfloat16, (512, 144, 3, 1, 1),
     lambda full: full[256:]),
    ((15, 200), torch.float32, (15, 400), lambda full: full[:, 200:]),
    ((1001,), torch.uint8, (2002,), lambda full: full[1:1002]),
    ((3, 13), torch.uint8, (3, 26), lambda full: full[:, 13:]))


def test_grouped_ring_kernel_writes_every_slot_and_nothing_else(device):
    # tolerance: none. Entries of other sizes and layouts, shifts
    # 0..degree-1, written into slots of canary-filled tensors, against
    # the plain version into twins of them on the same card; 44 entries
    # pass the launch's cap at both degrees, so the table splits
    gen = torch.Generator().manual_seed(11)
    for degree in (2, 4):
        table, plain, fulls = [], [], []
        for e, (shape, dtype, wide, slot) in enumerate(_CARD_SLOTS * 11):
            srcs = [torch.randint(0, 256, shape, generator=gen,
                                  dtype=torch.uint8).to(dtype).to(device)
                    for _ in range(degree)]
            if len(shape) == 5:
                srcs = [x.contiguous(memory_format=torch.channels_last_3d)
                        for x in srcs]
            fmt = (torch.channels_last_3d if len(shape) == 5
                   else torch.contiguous_format)
            full = [torch.full(wide, 7, dtype=dtype, device=device)
                    .contiguous(memory_format=fmt) for _ in range(2 * degree)]
            table.append(handoff_dma.RingEntry(
                srcs, [slot(f) for f in full[:degree]], e % degree))
            plain.append(handoff_dma.RingEntry(
                srcs, [slot(f) for f in full[degree:]], e % degree))
            fulls.append(full)
        handoff_dma.ring_shift_group_reference(plain)
        before = _kernels.RING_SHIFT.launches
        handoff_dma.ring_shift_group(table)
        torch.cuda.synchronize(device)
        cap = handoff_dma.RING_MAX_TILES // degree
        assert _kernels.RING_SHIFT.launches - before == -(-len(table) // cap)
        for full in fulls:
            for got, want in zip(full[:degree], full[degree:]):
                assert torch.equal(got, want)


def test_a_sharded_stage_replays_degree_1_s_logits_bitwise(device):
    # tolerance: none — the gathers move bytes and the ops are the
    # unsharded forward's, in the same captured form
    from rnb_tpu_torch.stage import RaggedBatch
    kwargs = dict(max_rows=6, pixel_path="yuv420", ragged=True,
                  ragged_pool_rows=6, ragged_chunk_rows=0)
    plain = _graph_runner(device, **kwargs)
    kwargs.pop("ragged_chunk_rows")
    sharded = _graph_runner(device, shard_degree=2, **kwargs)
    sharded.bind_shard_step(1)
    assert sharded.graph_keys() == plain.graph_keys()
    (graph,) = sharded._graphs.values()
    # the nine temporal kernels of layer sizes (1, 1, 1, 1) and the head's
    # two leaves, gathered together: one launch at degree 2, inside the
    # graph
    assert graph.launches == {"yuv420_normalize": 1, "ring_shift": 1}
    _kernels.reset_launches()
    for valid in (6, 2):
        x = _packed(6, seed=70 + valid).to(device)
        (want,), _, _ = plain((RaggedBatch(x, valid, (0, valid)),), None,
                              None)
        (got,), _, _ = sharded((RaggedBatch(x, valid, (0, valid)),), None,
                               None)
        torch.cuda.synchronize(device)
        assert torch.equal(got.data, want.data)
    # one replay (one grouped gather) and one merge launch a forward
    assert _kernels.RING_SHIFT.launches == 2 * (1 + 1)
    assert sharded.shard_stats["gathers"] == 2
    assert sharded.shard_stats["collective_ms"] > 0


#: one process of the two-process launch below: the ring collectives
#: across the processes (the kernel's cross-process form, one launch a
#: hop straight into the successor's arena) against their plain versions
#: on the same inputs; a result holds its arena range until it dies
_ACROSS = '''
import torch
from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.ops import handoff_dma as dma
from rnb_tpu_torch.parallel import distributed, peers
from rnb_tpu_torch.parallel.mesh import Member, Ring
assert distributed.maybe_initialize()
rank, n = distributed.process_index(), distributed.process_count()
device = distributed.local_device()
ring = Ring([Member(p, distributed.local_device(p)) for p in range(n)])
gen = torch.Generator().manual_seed(7)
members = [torch.randn(3, 1000, 7, generator=gen).to(device)
           for _ in range(n)]
before = _kernels.RING_SHIFT.launches
got = dma.ring_shift([members[rank]], 1, ring)[0]
assert torch.equal(got, members[(rank - 1) % n])
assert _kernels.RING_SHIFT.launches == before + 1  # one launch a hop
arena = peers.endpoint(ring).arena
assert arena.place(got.data_ptr(), got.untyped_storage().nbytes()) \
    is not None
leased = sum(arena.leased)
del got
assert sum(arena.leased) < leased
# slots along the last dim: rows at a pitch through the window
full = dma.ring_all_gather([members[rank]], ring, axis=-1)[0]
assert torch.equal(full, torch.cat(members, dim=-1))
ints = [torch.randint(-8, 9, (4, 2 * n), generator=gen).float().to(device)
        for _ in range(n)]
chunk = dma.ring_psum_scatter([ints[rank]], ring, -1)[0]
assert torch.equal(chunk, sum(ints).narrow(-1, 2 * rank, 2))
distributed.shutdown()
'''


def test_the_ring_collectives_across_two_processes_on_the_card(device,
                                                               tmp_path):
    # tolerance: none (moves, and sums of integers in float32)
    import sys
    from rnb_tpu_torch.tools.launch import launch
    script = tmp_path / "across.py"
    script.write_text(_ACROSS)
    for ended in launch(2, [sys.executable, str(script)], 300):
        assert ended.returncode == 0, ended.stderr[-4000:]


#: one process of the launch below: processes whose shapes disagree. Each
#: member's post then disagrees with its predecessor's table, so both
#: hops fail on the card before any byte is written: a caller's own
#: destination keeps every byte, and both processes raise
_DISAGREE = '''
import torch
from rnb_tpu_torch.ops import handoff_dma as dma
from rnb_tpu_torch.parallel import distributed, peers
from rnb_tpu_torch.parallel.mesh import Member, Ring
assert distributed.maybe_initialize()
rank, n = distributed.process_index(), distributed.process_count()
device = distributed.local_device()
peers.set_wait_cap(5.0)


def ring(axis):
    return Ring([Member(p, distributed.local_device(p)) for p in range(n)],
                axis)


small = torch.zeros(16 * (rank + 1), dtype=torch.uint8, device=device)
mine = torch.full_like(small, 7)
try:
    dma.ring_shift_group([dma.RingEntry([small], [mine], 1)], ring("small"))
    raise AssertionError("a hop of another table did not raise")
except RuntimeError as e:
    assert "tables disagree" in str(e), e
assert (mine == 7).all()
big = torch.zeros((2 << 20) if rank == 0 else (1 << 19), dtype=torch.uint8,
                  device=device)
try:
    dma.ring_shift([big], 1, ring("big"))
    raise AssertionError("a hop of another table did not raise")
except RuntimeError as e:
    assert "tables disagree" in str(e), e
peers.set_wait_cap(60.0)
distributed.shutdown()
'''


def test_processes_whose_shapes_disagree_fail_the_hop_on_the_card(
        device, tmp_path):
    import sys
    from rnb_tpu_torch.tools.launch import launch
    script = tmp_path / "disagree.py"
    script.write_text(_DISAGREE)
    for ended in launch(2, [sys.executable, str(script)], 300):
        assert ended.returncode == 0, ended.stderr[-4000:]
