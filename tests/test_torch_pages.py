"""The port's paged memory, clip cache and Zipf workload against the JAX
package, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX
package (``rnb_tpu/ops/pages.py``, ``pager.py``, ``cache.py``,
``video_path_provider.py``) and through ``rnb_tpu_torch``'s plain
versions, which the CUDA gather kernel is held to on the card:

* ``gather_rows_reference`` bitwise against JAX's masked-jnp twin and,
  where the row is lane-divisible, the Pallas kernel in interpret mode;
* ``write_rows_page``: the same slab bytes after the same page writes;
* one scripted sequence of allocations, inserts, hits, releases,
  evictions and limbo, applied to both packages' pager and caches:
  identical page tuples, flat rows, counters and slab rows;
* the Zipf draws, id for id; the settings and config refusals.

Everything here moves bytes or counts, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnb_tpu import cache as jax_cache
from rnb_tpu import pager as jax_pager
from rnb_tpu import video_path_provider as jax_vpp
from rnb_tpu.ops import pages as jax_pages
from rnb_tpu_torch import cache, pager, video_path_provider
from rnb_tpu_torch.config import ConfigError, parse_config
from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.ops.pages import (gather_rows, gather_rows_reference,
                                     write_rows_page)

#: source tables: all sentinels, all hits, mixed, duplicate sources,
#: and the slab's last row (11 is the last of 12)
PATTERNS = {
    "all_miss": [-1, -1, -1, -1, -1, -1],
    "all_hit": [0, 1, 2, 3, 4, 5],
    "mixed": [7, -1, 0, -1, 11, -1],
    "duplicates": [3, 3, -1, 3, 3, -1],
    "last_row": [11, -1, 11, 10, -1, 11],
}
#: (row shape, dtype): lane-divisible u8 rows (2*256 = 4*128) and
#: 400-float feature rows (1,600 bytes: not a multiple of 128 lanes)
ROWS = {"u8": ((2, 256), np.uint8), "f32": ((400,), np.float32)}


@pytest.fixture(autouse=True)
def _fresh_jax_page_writer():
    """These tests compile the reference's memoized page writer at
    shapes tests/test_pager.py's single-signature pin never uses: hand
    later tests in the same process a fresh writer."""
    yield
    jax_pages._page_writer_jit.cache_clear()


def _rows(rng, n, shape, dtype):
    if dtype == np.uint8:
        return rng.integers(0, 256, (n,) + shape, dtype=np.uint8)
    return rng.standard_normal((n,) + shape).astype(dtype)


@pytest.mark.parametrize("rows", sorted(ROWS))
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_gather_rows_reference_bitwise_equals_jax(rows, pattern):
    shape, dtype = ROWS[rows]
    rng = np.random.default_rng(7)
    pool, slab = _rows(rng, 6, shape, dtype), _rows(rng, 12, shape, dtype)
    src = np.asarray(PATTERNS[pattern], np.int32)
    got = gather_rows_reference(torch.from_numpy(pool),
                                torch.from_numpy(slab), src).numpy()
    want = np.asarray(jax_pages.gather_rows_reference(
        jnp.asarray(pool), jnp.asarray(slab), src))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # the entry point takes the plain version for CPU tensors
    assert gather_rows(torch.from_numpy(pool), torch.from_numpy(slab),
                       src).numpy().tobytes() == want.tobytes()
    if rows == "u8":
        # the TPU kernel body itself, in interpret mode
        pallas = np.asarray(jax_pages._gather_rows_pallas(
            jnp.asarray(pool), jnp.asarray(slab), src, interpret=True))
        assert pallas.tobytes() == got.tobytes()


def test_gather_rows_never_falls_back_for_non_cpu_tensors():
    meta = torch.empty((6, 400), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        gather_rows(meta, meta, np.zeros(6, np.int32))
    _kernels.reset_launches()
    pool = torch.zeros((6, 400))
    gather_rows(pool, pool, np.zeros(6, np.int32))
    assert _kernels.GATHER_ROWS.launches == 0


def test_write_rows_page_matches_jax_writer():
    rng = np.random.default_rng(2)
    for dtype in (np.uint8, np.float32):
        slab_t = torch.zeros((12, 2, 256), dtype=torch.from_numpy(
            np.zeros(0, dtype)).dtype)
        slab_j = jnp.zeros((12, 2, 256), dtype)
        src = _rows(rng, 5, (2, 256), dtype)
        # page_rows=4 writes: full, clamp-padded, out-of-range indices
        # (clipped), and a start past the slab end (clamped to fit)
        for idx, dst in (([0, 1, 2, 3], 4), ([1, 2, 2, 2], 0),
                         ([3, 4, 9, 9], 8), ([4, 3, 2, 1], 11)):
            idx = np.asarray(idx, np.int32)
            out = write_rows_page(slab_t, torch.from_numpy(src), idx, dst)
            assert out is slab_t  # in place
            slab_j = jax_pages.write_rows_page(slab_j, jnp.asarray(src),
                                               idx, dst)
            assert slab_t.numpy().tobytes() == \
                np.asarray(slab_j).tobytes(), (idx, dst)


# -- the pager and caches, one script applied to both packages ---------

class _Twin:
    """The same pager objects in both packages, with one clip arena
    (page_rows=2, 5 pages of 16-float rows) and one feature arena."""

    def __init__(self, mod_pager, mod_cache, make_pool, feature=True):
        self.make_pool = make_pool
        settings = mod_pager.PagerSettings(page_rows=2,
                                           feature_cache=feature)
        self.pager = mod_pager.Pager(settings)
        dtype = torch.float32 if mod_pager is pager else np.float32
        self.clips = self.pager.create_arena("clips", (16,), dtype,
                                             budget_bytes=5 * 2 * 64)
        self.cache = mod_cache.ClipCache(1.0)
        self.cache.attach_arena(self.clips)
        self.features = self.pager.create_arena(
            "features", (16,), dtype, budget_bytes=3 * 2 * 64,
            gather_keys=("feature_gathers", "feature_gather_rows"))
        self.pager.feature.attach(self.features, ("fp", 1))

    def slab(self, arena):
        return np.asarray(arena._slab)


def _script(twin, pools):
    """Apply the scripted sequence; returns what it observed."""
    seen = []
    c, f = twin.cache, twin.pager.feature

    def note(tag, value):
        seen.append((tag, value))

    note("ins v0", c.insert_pages(("v0",), pools[0], 1, 3))     # 2 pages
    note("ins v0 again", c.insert_pages(("v0",), pools[0], 0, 2))
    note("ins v1", c.insert_pages(("v1",), pools[1], 0, 1))     # 1 page
    note("ins big", c.insert_pages(("big",), pools[1], 0, 11))  # oversize
    p0 = c.acquire(("v0",))
    note("p0", (p0.pages, p0.src_rows.tolist(), p0.valid))
    note("miss", c.acquire(("none",)))
    note("ins v2", c.insert_pages(("v2",), pools[2], 0, 4))     # 2 pages
    # the arena is full: v3 evicts v1 (freed), the pinned v0 (limbo)
    # and v2 (freed) before its two pages fit
    note("ins v3", c.insert_pages(("v3",), pools[3], 0, 3))
    note("snap1", twin.pager.snapshot())
    # the planned gather still reads v0's rows: limbo pages are not
    # reused under the pin
    src = np.full((6,), -1, np.int32)
    src[1:4] = p0.src_rows
    out = twin.clips.gather(twin.make_pool(np.zeros((6, 16), np.float32)),
                            src)
    note("gather p0", np.asarray(out).tolist())
    p0.release()
    note("snap2", twin.pager.snapshot())
    note("ins v5", c.insert_pages(("v5",), pools[2], 5, 2))
    p3, p5 = c.acquire(("v3",)), c.acquire(("v5",))
    # every evictable page is pinned: the insert is skipped, not blocked
    note("ins v4 pinned", c.insert_pages(("v4",), pools[1], 0, 10))
    note("snap3", twin.pager.snapshot())
    p3.release()
    p5.release()
    p5.release()  # idempotent
    note("ins v4", c.insert_pages(("v4",), pools[1], 0, 10))
    note("snap4", twin.pager.snapshot())
    note("flat", twin.clips.flat_rows((3, 1, 4), 5).tolist())
    # feature pages: first writer wins, LRU eviction, hits, gathers
    note("f miss", f.acquire(("v0",)))
    note("f ins v0", f.insert(("v0",), pools[0], 0, 3))
    note("f ins v0 again", f.insert(("v0",), pools[1], 0, 3))
    note("f ins v1", f.insert(("v1",), pools[1], 2, 2))
    fp = f.acquire(("v0",))
    note("fp", (fp.pages, fp.src_rows.tolist()))
    fsrc = np.full((4,), -1, np.int32)
    fsrc[:3] = fp.src_rows
    fout = twin.features.gather(
        twin.make_pool(np.ones((4, 16), np.float32)), fsrc)
    note("f gather", np.asarray(fout).tolist())
    fp.release()
    note("f ins v2", f.insert(("v2",), pools[2], 0, 4))   # evicts v1
    note("f contains", (f.contains(("v0",)), f.contains(("v1",))))
    note("cache snap", c.snapshot())
    note("pager snap", twin.pager.snapshot())
    note("clip slab", twin.slab(twin.clips).tolist())
    note("feature slab", twin.slab(twin.features).tolist())
    return seen


def test_pager_and_caches_follow_the_reference_step_by_step():
    rng = np.random.default_rng(11)
    pools = [rng.standard_normal((12, 16)).astype(np.float32)
             for _ in range(4)]
    ours = _script(_Twin(pager, cache,
                         lambda a: torch.from_numpy(np.array(a))),
                   [torch.from_numpy(p) for p in pools])
    theirs = _script(_Twin(jax_pager, jax_cache, jnp.asarray),
                     [jnp.asarray(p) for p in pools])
    assert [t for t, _ in ours] == [t for t, _ in theirs]
    for (tag, got), (_, want) in zip(ours, theirs):
        assert got == want, tag
    # the script reached what it is about
    seen = dict(ours)
    assert seen["snap1"]["limbo"] == 2 and seen["snap2"]["limbo"] == 0
    assert np.array_equal(np.asarray(seen["gather p0"])[1:4], pools[0][1:4])
    assert seen["snap3"]["limbo"] > 0 and seen["ins v4 pinned"] is False
    assert seen["ins v4"] is True and seen["ins big"] is False
    assert seen["cache snap"]["oversize"] == 1
    snap = seen["pager snap"]
    assert snap["allocs"] == snap["frees"] + snap["live"]
    assert snap["limbo"] == 0 and snap["feature_evictions"] > 0


def test_blob_cache_modes_follow_the_reference():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, (3, 8, 64), dtype=np.uint8)
    mb = 3 * 8 * 64 * 3 / float(1 << 20)  # room for three 3-row batches
    snaps = []
    for mod in (cache, jax_cache):
        c = mod.ClipCache(mb)
        c.insert_host(("a",), rows, 2, (3, 8, 64))
        c.insert_host(("a",), rows, 2, (3, 8, 64))           # first wins
        c.insert_rows(("b",), rows, 1)
        c.insert_host(("c",), rows, 3, (3, 8, 64))
        c.insert_host(("d",), rows, 3, (3, 8, 64))           # evicts a
        c.insert_host(("huge",), rows, 3, (30, 8, 64))       # oversize
        hit = c.lookup(("c",))
        assert np.asarray(hit.batch)[:3].tobytes() == rows.tobytes()
        assert np.asarray(c.lookup(("b",)).batch).tobytes() == \
            rows[:1].tobytes()
        assert c.lookup(("a",)) is None
        c.note_coalesced(2)
        snaps.append(c.snapshot())
        assert mod.aggregate_snapshots([snaps[-1]] * 2)["hits"] == 4
    assert snaps[0] == snaps[1]
    assert cache.content_key("synth://x", 7) == \
        jax_cache.content_key("synth://x", 7)
    table = cache.InflightTable()
    table.put(("k",), "rec")
    assert table.get(("k",)) == "rec" and len(table) == 1
    table.pop(("k",))
    table.pop(None)
    assert table.get(("k",)) is None


def test_settings_and_budget_follow_the_reference():
    for raw in (None, {}, {"enabled": False}, {"enabled": True},
                {"enabled": True, "page_rows": 2, "pool_mb": 1.5,
                 "feature_cache": True}):
        ours = pager.PagerSettings.from_config(raw)
        theirs = jax_pager.PagerSettings.from_config(raw)
        assert (ours is None) == (theirs is None)
        if ours is not None:
            assert dataclass_tuple(ours) == dataclass_tuple(theirs)
    for bad in ({"page_rows": 0}, {"pool_mb": 0}):
        with pytest.raises(ValueError):
            pager.PagerSettings.from_config(bad)
    for mod in (pager, jax_pager):
        p = mod.Pager(mod.PagerSettings(pool_mb=2))
        assert p.resolve_budget(123) == 2 << 20
        p = mod.Pager(mod.PagerSettings())
        assert p.resolve_budget(123) == 123
        assert p.resolve_budget() == mod.DEFAULT_ARENA_MB << 20
        p.size_hint(456)
        assert p.resolve_budget() == 456
    assert pager.Pager.COUNTER_KEYS == jax_pager.Pager.COUNTER_KEYS


def dataclass_tuple(settings):
    return (settings.page_rows, settings.pool_mb, settings.feature_cache)


def _paged_raw():
    import json
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs",
                           "rnb-fused-yuv-paged-zipf.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("where,value,match", [
    ("pager", {"enabled": True, "bogus": 1}, "not yet ported"),
    ("pager", {"page_rows": 0}, "page_rows"),
    ("pager", {"pool_mb": -1}, "pool_mb"),
    ("pager", {"feature_cache": "yes"}, "feature_cache"),
    ("pager", {"enabled": 1}, "enabled"),
    ("popularity", {"dist": "pareto"}, "dist"),
    ("popularity", {"s": -1}, "popularity.s"),
    ("popularity", {"universe": 0}, "universe"),
    ("popularity", {"skew": 1}, "not yet ported"),
])
def test_config_refuses_bad_pager_and_popularity(where, value, match):
    raw = _paged_raw()
    raw[where] = value
    with pytest.raises(ConfigError, match=match):
        parse_config(raw, platform="cpu")


def test_config_pager_requires_ragged():
    raw = _paged_raw()
    del raw["ragged"]
    with pytest.raises(ConfigError, match="requires 'ragged'"):
        parse_config(raw, platform="cpu")
    raw["pager"]["enabled"] = False  # a disabled pager needs nothing
    assert parse_config(raw, platform="cpu").pager == raw["pager"]


# -- the Zipf workload -------------------------------------------------

class _Base(video_path_provider.VideoPathIterator):
    def __init__(self, videos, finite=True):
        self._videos, self._finite = videos, finite

    def dataset(self):
        return list(self._videos) if self._finite else None

    def __iter__(self):
        import itertools
        return itertools.cycle(self._videos)


@pytest.mark.parametrize("s,universe,finite", [(1.1, 32, True),
                                               (0.0, None, True),
                                               (2.0, 5, False)])
def test_zipf_draws_are_the_reference_draws(s, universe, finite):
    import itertools
    videos = ["label%d/v%03d.y4m" % (i % 4, i) for i in range(40)]
    for u, ss in ((None, None), (universe, None)):
        assert np.array_equal(
            video_path_provider.zipf_probabilities(u or 40, s),
            jax_vpp.zipf_probabilities(u or 40, s))
    # the client's child seed for the popularity draws
    for seed in (0, 7):
        child = np.random.SeedSequence([seed, 1])
        ours = video_path_provider.ZipfPathIterator(
            _Base(videos, finite), s=s, universe=universe, seed=child)
        theirs = jax_vpp.ZipfPathIterator(
            _Base(videos, finite), s=s, universe=universe,
            seed=np.random.SeedSequence([seed, 1]))
        assert ours.dataset() == theirs.dataset()
        assert list(itertools.islice(iter(ours), 300)) == \
            list(itertools.islice(iter(theirs), 300))


def test_path_iterator_exposes_its_dataset(tmp_path, monkeypatch):
    from rnb_tpu_torch.models.r2p1d.model import R2P1DVideoPathIterator
    monkeypatch.delenv("RNB_TPU_DATA_ROOT", raising=False)
    ids = R2P1DVideoPathIterator().dataset()
    assert len(ids) == 200 and ids[0] == "synth://kinetics/video-0000"
    with pytest.raises(ValueError):
        video_path_provider.ZipfPathIterator(_Base([]))
