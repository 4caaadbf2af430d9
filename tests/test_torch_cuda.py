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
from rnb_tpu_torch.ops import _kernels, dct
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
                                        "ragged_normalize_u8": 0}
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
                                        "ragged_normalize_u8": 0}


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
