"""The port's CUDA kernels, compiled for the host and run on the CPU.

``tests/host_cuda/`` emulates the CUDA subset the kernels use (threads,
barriers, warp votes, shared memory, the rounding intrinsics), so a
host C++ compiler builds ``rnb_tpu_torch/csrc/ingest.cu``, ``dct.cu``
``pages.cu`` and ``ring.cu`` unchanged but for the launch syntax. The
kernels then run on CPU tensors through their C entry points and are
held to the plain versions, the fused dct ingest bitwise to the unpack
and convert kernels it fuses, the page gather and the ring shift bitwise
to their plain versions: this
checks their indexing, masking, vector and scalar paths, warp
collectives and arithmetic on the CPU. Speed, and races that only the card's
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
from rnb_tpu_torch.ops.handoff_dma import (RING_MAX_TILES, RingEntry,
                                           ring_gather_tables,
                                           ring_launches,
                                           ring_shift_group_reference,
                                           ring_shift_reference)
from rnb_tpu_torch.ops.pages import gather_rows_reference
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
    built = {source: _build(source, out)
             for source in ("ingest.cu", "dct.cu", "pages.cu", "ring.cu")}
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


def _steps(out, ref):
    """Normalized outputs apart, in u8 steps."""
    return (torch.round((out.float() * 255 + 255) / 2)
            - torch.round((ref.float() * 255 + 255) / 2)).abs()


def _ingest_and_two_kernels(libs, wire, valid, h, w, dtype):
    """``rnb_dct_ingest``'s output, and the planes and output of
    ``rnb_dct_unpack`` followed by ``rnb_dct_convert``, on the emulated
    card; ``rows_valid`` from a device scalar (None: a null pointer).
    Every buffer starts as garbage."""
    rows, frames = int(wire.shape[0]), int(wire.shape[1])
    coeffs = dct.coeffs_from_elems(h, w, wire.shape[-1])
    scalar = _scalar(valid)
    bf16 = int(dtype == torch.bfloat16)
    planes = [torch.full((rows, frames, h // k, w // k), 99,
                         dtype=torch.int32) for k in (1, 2, 2)]
    assert libs["dct_unpack"](
        _ptr(wire), *(_ptr(p) for p in planes),
        rows if valid is None else valid, frames, h, w, coeffs, 0,
        None) == 0
    two = torch.full((rows, frames, h, w, 3), 7.0, dtype=dtype)
    assert libs["dct_convert"](
        *(_ptr(p) for p in planes), _ptr(two), _ptr(scalar), rows, frames,
        h, w, bf16, 0, None) == 0
    one = torch.full(two.shape, 5.0, dtype=dtype)
    assert libs["dct_ingest"](
        _ptr(wire), _ptr(one), _ptr(scalar), rows, frames, h, w, coeffs,
        bf16, 0, None) == 0
    return one, planes, two


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("valid", [None, 2, 0])
@pytest.mark.parametrize("h,w", [(32, 32), (48, 80), (16, 144), (112, 112)])
def test_dct_ingest_is_bitwise_the_two_kernels(libs, h, w, valid, dtype):
    # tolerance: none against rnb_dct_unpack followed by rnb_dct_convert
    # (the same arithmetic after the load phase); against the plain
    # version two RGB steps with at least 99% exact, as for the convert.
    # The last row's wire is garbage: a pad row at rows_valid 2 and 0,
    # which must come out exact zeros
    frames = 1 if h * w > 64 * 64 else 2
    wire = _wire(4, frames, h, w, seed=h * w)
    one, _planes, two = _ingest_and_two_kernels(libs, wire, valid, h, w,
                                                dtype)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(one.view(bits), two.view(bits))
    n = 4 if valid is None else valid
    ref = dct.dct_ingest_reference(wire, n, h, w, dtype)
    assert float(_steps(one, ref).max()) <= 2
    assert float((one == ref).double().mean()) >= 0.99
    assert not one[n:].float().any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dct_ingest_last_entry_wins_and_drops_past_the_budget(libs, dtype):
    # one 32x32 frame with a budget of C = 100: block 0 claims 99 entries
    # (64 after the clamp), block 1 -7 (none), block 2 40 and the last
    # block 200 (64), so the counts sum past C: block 2 keeps 36 and the
    # last block none. Positions in [-5, 70] put many entries of blocks
    # 0 and 2 on one slot, within a round of 32 lanes and across rounds;
    # entries 0-2 (one round) and 10 and 50 (two rounds) are forced onto
    # one slot. The second row is garbage past rows_valid = 1
    h = w = 32
    nb = dct.num_dct_blocks(h, w)
    coeffs = 100
    rng = np.random.default_rng(17)
    frame = np.zeros(nb + 2 * coeffs, np.int16)
    frame[[0, 1, 2, nb - 1]] = [99, -7, 40, 200]
    frame[nb:nb + coeffs] = rng.integers(-1000, 1000, coeffs)
    pos = rng.integers(-5, 71, coeffs)
    pos[[0, 1, 2]] = [-3, 0, 0]
    pos[[10, 50]] = 9
    frame[nb + coeffs:] = pos
    garbage = rng.integers(-32768, 32768, frame.shape).astype(np.int16)
    wire = torch.from_numpy(np.stack([frame, garbage])[:, None])
    one, planes, two = _ingest_and_two_kernels(libs, wire, 1, h, w, dtype)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(one.view(bits), two.view(bits))
    want = dct.unpack_dct_rows_reference(wire, h, w)
    for got, ref in zip(planes, want):
        assert torch.equal(got[:1], ref[:1])
    # the slot of zigzag position 0 holds the last kept entry of block 0
    # on it
    slot0 = np.clip(pos[:64], 0, 63) == 0
    assert planes[0][0, 0, 0, 0] == frame[nb + np.flatnonzero(slot0)[-1]]
    assert 0 < int((want[0][0, 0, :8, 16:24] != 0).sum()) <= 36
    assert not want[2][0, 0, 8:, 8:].any()   # the last (V) block: dropped
    ref = dct.dct_ingest_reference(wire, 1, h, w, dtype)
    assert float(_steps(one, ref).max()) <= 2
    assert float((one == ref).double().mean()) >= 0.99
    assert not one[1:].float().any()


#: row kinds of the gather: the clip arena's u8 row (8 frames of packed
#: 4:2:0), the feature arena's float32 logit row, a row size that is not
#: a multiple of 16, and a clip-sized row whose source and destination
#: sit one byte off 16-byte alignment
_GATHER_ROWS = {"clip": (np.uint8, (8, 18816)),
                "feature": (np.float32, (400,)),
                "odd": (np.uint8, (1001,)),
                "misaligned": (np.uint8, (8, 18816))}


def _gather_table(kind, pool_rows, slab_rows, rng):
    return {"all_sentinel": np.full(pool_rows, -1),
            "all_hit": rng.integers(0, slab_rows, pool_rows),
            "mixed": np.where(np.arange(pool_rows) % 2, -1,
                              rng.integers(0, slab_rows, pool_rows)),
            # past the slab: clamped to its last row
            "past_slab": np.where(np.arange(pool_rows) % 2, slab_rows + 7,
                                  rng.integers(-1, slab_rows, pool_rows)),
            }[kind].astype(np.int32)


@pytest.mark.parametrize("table", ["all_sentinel", "all_hit", "mixed",
                                   "past_slab"])
@pytest.mark.parametrize("row", sorted(_GATHER_ROWS))
def test_gather_kernel_is_bitwise_its_plain_version(libs, row, table):
    # tolerance: none (the kernel moves bytes). The clip row takes the
    # batched 16-byte path over several chunks with a partial last one,
    # the feature row one partial chunk, the odd and misaligned rows the
    # byte loop; the output starts as garbage
    dtype, shape = _GATHER_ROWS[row]
    rng = np.random.default_rng(len(row) * 10 + len(table))
    pool_rows, slab_rows = 3, 5
    pool = torch.from_numpy(rng.integers(0, 255, (pool_rows,) + shape)
                            .astype(dtype))
    slab = torch.from_numpy(rng.integers(0, 255, (slab_rows,) + shape)
                            .astype(dtype))
    src = torch.from_numpy(_gather_table(table, pool_rows, slab_rows, rng))
    want = gather_rows_reference(pool, slab, src)
    row_bytes = want[0].numel() * want.element_size()
    shift = int(row == "misaligned")
    # pool and output one byte into buffers of their own
    pool_buf = torch.zeros(pool_rows * row_bytes + shift, dtype=torch.uint8)
    pool_buf[shift:] = pool.reshape(-1).view(torch.uint8)
    out_buf = torch.full((pool_rows * row_bytes + shift,), 0xA5,
                         dtype=torch.uint8)
    assert libs["gather_rows"](
        pool_buf.data_ptr() + shift, _ptr(slab), _ptr(src),
        out_buf.data_ptr() + shift, pool_rows, slab_rows, row_bytes, 0,
        None) == 0
    assert torch.equal(out_buf[shift:], want.reshape(-1).view(torch.uint8))


#: buffer sizes of the ring shift: 16-byte vectors over several blocks
#: with a byte tail, a size under one vector, and the same buffers one
#: byte off 16-byte alignment (the byte loop over the whole buffer)
_RING_CASES = {"vectors_and_tail": (40007, 0), "small": (13, 0),
               "misaligned": (40007, 1)}


def _run_ring(libs, table):
    """``table`` through the emulated ``rnb_ring_shift``, launch by
    launch, as the wrapper splits it; returns the launches."""
    launches = ring_launches(table)
    for args in launches:
        assert libs["ring_shift"](*args, 0, None) == 0
    return len(launches)


@pytest.mark.parametrize("case", sorted(_RING_CASES))
@pytest.mark.parametrize("degree,shift", [(1, 0), (2, 1), (4, 1), (4, 3),
                                          (8, 5)])
def test_ring_shift_kernel_is_bitwise_its_plain_version(libs, degree, shift,
                                                        case):
    # tolerance: none (the hop moves bytes); every destination starts as
    # garbage
    nbytes, offset = _RING_CASES[case]
    rng = np.random.default_rng(degree * 10 + shift + nbytes)
    srcs = [torch.from_numpy(rng.integers(0, 256, nbytes + offset,
                                          dtype=np.uint8))
            for _ in range(degree)]
    dsts = [torch.full((nbytes + offset,), 0xA5, dtype=torch.uint8)
            for _ in range(degree)]
    want = ring_shift_reference([t[offset:] for t in srcs], shift)
    assert _run_ring(libs, [RingEntry([t[offset:] for t in srcs],
                                      [t[offset:] for t in dsts],
                                      shift)]) == 1
    for got, expected in zip(dsts, want):
        assert torch.equal(got[offset:], expected)


def _arena_views(arena, kind, nbytes, rows, cursor, rng):
    """A view of ``arena`` at ``cursor`` for an entry of ``kind``, and
    the cursor past it and a gap of canary bytes."""
    offset = cursor + (int(rng.integers(1, 16)) if kind == "misaligned"
                       else 0)
    if kind in ("rows", "odd_rows"):
        row_bytes = nbytes // rows
        pitch = 2 * row_bytes + (0 if kind == "rows" else 3)
        view = arena[offset:offset + rows * pitch].view(rows, pitch)
        return view[:, :row_bytes], offset + rows * pitch + 32
    return arena[offset:offset + nbytes], offset + nbytes + 32


#: entry kinds of a grouped table: (bytes, rows). One byte; an odd size
#: under one vector; vectors and a tail; five blocks of 16 KB; the same
#: one to 15 bytes off 16-byte alignment (the byte loop); rows of 48
#: bytes at a pitch of 96 (16-byte vectors at a pitch); rows of 13 bytes
#: at a pitch of 29 (the byte loop at a pitch)
_GROUP_KINDS = {"one": (1, 1), "odd": (13, 1), "tail": (40007, 1),
                "blocks": (70000, 1), "misaligned": (40007, 1),
                "rows": (15 * 48, 15), "odd_rows": (3 * 13, 3)}


def _group_table(degree, entries, seed):
    """A seeded table of ``entries`` entries of mixed kinds and shifts
    0..degree-1, sources in one random arena a member and destinations
    in one canary-filled arena a member, with canary gaps between them;
    returns the table and the destination arenas."""
    rng = np.random.default_rng(seed)
    kinds = [sorted(_GROUP_KINDS)[(seed + e) % len(_GROUP_KINDS)]
             for e in range(entries)]
    # the large kinds are few: the emulation runs a thread a CUDA thread
    kinds = [k if k not in ("tail", "blocks", "misaligned") or e % 5 == 0
             else "odd" for e, k in enumerate(kinds)]
    size = sum(_GROUP_KINDS[k][0] * 2 + 128 for k in kinds)
    src_arenas = [torch.from_numpy(rng.integers(0, 256, size,
                                                dtype=np.uint8))
                  for _ in range(degree)]
    dst_arenas = [torch.full((size,), 0xA5, dtype=torch.uint8)
                  for _ in range(degree)]
    table, src_cursor, dst_cursor = [], [0] * degree, [0] * degree
    for e, kind in enumerate(kinds):
        nbytes, rows = _GROUP_KINDS[kind]
        srcs, dsts = [], []
        for m in range(degree):
            # sources dense on even entries, at a pitch on odd ones
            src_kind = kind if kind != "rows" or e % 2 else "dense_rows"
            if src_kind == "dense_rows":
                view = src_arenas[m][src_cursor[m]:src_cursor[m] + nbytes]
                srcs.append(view.view(rows, nbytes // rows))
                src_cursor[m] += nbytes + 32
            else:
                view, src_cursor[m] = _arena_views(
                    src_arenas[m], kind, nbytes, rows, src_cursor[m], rng)
                srcs.append(view)
            view, dst_cursor[m] = _arena_views(
                dst_arenas[m], kind, nbytes, rows, dst_cursor[m], rng)
            dsts.append(view)
        table.append(RingEntry(srcs, dsts, e % degree))
    return table, dst_arenas


def _reference_arenas(table, dst_arenas):
    """The plain version of ``table`` into copies of the canary arenas."""
    copies = [a.clone() for a in dst_arenas]
    index = {a.data_ptr(): c for a, c in zip(dst_arenas, copies)}
    ref = []
    for entry in table:
        dsts = []
        for d in entry.dsts:
            (base,) = [a for a in dst_arenas
                       if 0 <= d.data_ptr() - a.data_ptr() < a.numel()]
            dsts.append(torch.as_strided(
                index[base.data_ptr()], d.shape, d.stride(),
                d.data_ptr() - base.data_ptr()))
        ref.append(RingEntry(entry.srcs, dsts, entry.shift))
    ring_shift_group_reference(ref)
    return copies


@pytest.mark.parametrize("entries", ["few", "cap", "past_cap", "twice_cap"])
@pytest.mark.parametrize("degree", [2, 4, 8])
def test_grouped_ring_kernel_is_bitwise_its_plain_version(libs, degree,
                                                          entries):
    # tolerance: none (the hop moves bytes). Mixed entry sizes and
    # layouts, per-entry shifts 0..degree-1, up to the launch's cap and
    # past it (the wrapper's split); the destination arenas start as
    # canary bytes, so a byte written outside a slot, or a slot byte not
    # written, differs from the plain version's arenas
    cap = RING_MAX_TILES // degree
    count = {"few": 7, "cap": cap, "past_cap": cap + 1,
             "twice_cap": 2 * cap + 3}[entries]
    table, arenas = _group_table(degree, count, seed=degree * 100 + count)
    want = _reference_arenas(table, arenas)
    assert _run_ring(libs, table) == -(-count // cap)
    for got, expected in zip(arenas, want):
        assert torch.equal(got, expected)
    assert {e.shift for e in table} == set(range(degree)) or count < degree


def test_grouped_ring_kernel_skips_empty_entries(libs):
    # an empty entry moves nothing and takes no tile; a table of them
    # launches nothing
    a = torch.arange(32, dtype=torch.uint8)
    b = torch.zeros(32, dtype=torch.uint8)
    empty = RingEntry([a[:0], a[:0]], [b[:0], b[:0]], 1)
    assert _run_ring(libs, [empty]) == 0
    assert _run_ring(libs, [empty, RingEntry([a[:16], a[16:]],
                                             [b[:16], b[16:]], 1)]) == 1
    assert torch.equal(b, torch.cat([a[16:], a[:16]]))


def _refusal_args(n=2, entries=1, shift=1, rows=1, row_bytes=16,
                  src_pitch=16, dst_pitch=16):
    one = torch.zeros(4096, dtype=torch.uint8)
    pairs = max(1, entries * n)
    pointers = ctypes.c_void_p * pairs
    longs = ctypes.c_longlong
    return (pointers(*[one.data_ptr()] * pairs),
            pointers(*[one.data_ptr()] * pairs),
            (longs * pairs)(*[src_pitch] * pairs),
            (longs * pairs)(*[dst_pitch] * pairs),
            (ctypes.c_int * max(1, entries))(*[shift] * max(1, entries)),
            (longs * max(1, entries))(*[rows] * max(1, entries)),
            (longs * max(1, entries))(*[row_bytes] * max(1, entries)),
            n, entries, 0, None), one


@pytest.mark.parametrize("bad", [
    dict(n=0, shift=0), dict(n=9, shift=0), dict(shift=2), dict(shift=-1),
    dict(entries=RING_MAX_TILES // 2 + 1), dict(n=8, entries=11),
    dict(entries=-1), dict(row_bytes=-16), dict(rows=-1),
    dict(rows=2, src_pitch=8), dict(rows=2, dst_pitch=15),
    dict(rows=2, row_bytes=1 << 31, src_pitch=1 << 32,
         dst_pitch=1 << 32)])
def test_ring_shift_kernel_refuses_what_it_cannot_run(libs, bad):
    args, _keep = _refusal_args(**bad)
    assert libs["ring_shift"](*args) != 0


def test_ring_shift_kernel_takes_a_full_table(libs):
    # the cap itself is taken, at every degree
    for n in (1, 2, 3, 8):
        args, _keep = _refusal_args(n=n, entries=RING_MAX_TILES // n,
                                    shift=0)
        assert libs["ring_shift"](*args) == 0


@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("degree", [2, 3, 4, 8])
def test_ring_all_gather_tables_through_the_kernel_are_the_unsharded(
        libs, degree, axis):
    # tolerance: none. Leaves of mixed shapes and dtypes, a channels-last
    # conv kernel among them on axis 0; the all-gather's tables run
    # through the emulated kernel in degree - 1 launches at degree 2 to 4
    # (the first table at degree 8 holds 2 x 8 x 3 pairs: one split)
    rng = np.random.default_rng(degree * 7 + axis)
    shapes = [(degree * 2, 6), (3, degree * 5), (degree, 3, 2)]
    leaves_full = [torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in shapes]
    conv = torch.from_numpy(rng.integers(0, 256, (degree * 2, 5, 3, 1, 1),
                                         dtype=np.uint8)).contiguous(
        memory_format=torch.channels_last_3d)
    if axis == 0:
        leaves_full.append(conv)
    leaves = [[c.clone() for c in torch.chunk(x, degree, dim=axis)]
              if x.shape[axis] % degree == 0 else None for x in leaves_full]
    leaves_full = [x for x, s in zip(leaves_full, leaves) if s is not None]
    leaves = [s for s in leaves if s is not None]
    if axis == 0:
        leaves[-1] = [s.contiguous(memory_format=torch.channels_last_3d)
                      for s in leaves[-1]]
    got, tables = ring_gather_tables(leaves, axis)
    assert len(tables) == degree - 1
    splits = -(-2 * degree * len(leaves) // RING_MAX_TILES) - 1
    assert sum(_run_ring(libs, table) for table in tables) == (degree - 1
                                                              + splits)
    for members, full in zip(got, leaves_full):
        assert len(members) == degree
        for member in members:
            assert torch.equal(member, full)
            if full.dim() == 5:
                assert member.stride() == full.stride()
