"""The port's fused serving slices against the JAX package, and end to
end on the CPU.

* ``R2P1DRunner`` (yuv420 ingest + R(2+1)D layers 1..5, bucketed and
  ragged/chunked) against the JAX ``_shared_apply`` on the same
  variables — ``rnb_tpu``'s seeded init, BatchNorm randomized, carried
  across with ``from_jax_variables`` — and the same packed planes, made
  from a seed with numpy. Both compute in bf16.
* the fused loader's batching, and ``run_benchmark(platform="cpu")``
  over reduced copies of the shipped configs (yuv420 over a y4m
  dataset, dct over ``synth://`` ids), its logs read back with
  ``parse_utils``.
* the paged clip cache and feature pages: the loader and runner driven
  by hand through a miss, a coalesced follower, a clip-page hit and
  feature hits, every served request's logits against the JAX
  ``_shared_apply`` on its own decoded rows, feature hits bitwise equal
  to the first serving; and both Zipf configs end to end.
* config reading: the repo's configs unchanged, every unported key
  refused.
"""

import json
import os
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.models.r2p1d.model import _shared_apply
from rnb_tpu_torch.config import ConfigError, load_config, parse_config
from rnb_tpu_torch.decode import Y4MDecoder, write_y4m
from rnb_tpu_torch.devices import DeviceResolutionError, DeviceSpec
from rnb_tpu_torch.models.r2p1d.checkpoint import from_jax_variables
from rnb_tpu_torch.models.r2p1d.model import (R2P1DFusingLoader,
                                              R2P1DRunner)
from rnb_tpu_torch.models.r2p1d.network import (R2Plus1DClassifier,
                                                cast_compute_weights)
from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.pager import Pager, PagerSettings
from rnb_tpu_torch.parse_utils import summarize
from rnb_tpu_torch.stage import PaddedBatch, RaggedBatch
from rnb_tpu_torch.telemetry import TimeCard
from torch_job_checks import assert_both_checks_pass

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("configs/rnb-fused-yuv-big.json",
           "configs/rnb-fused-yuv-ragged.json",
           "configs/rnb-fused-dct-ragged.json")
#: per config: its pixel path and what its requests' ids look like
#: (the dct path serves synthetic ids: a y4m file has no coefficients)
PIXEL_PATH = {CONFIGS[0]: "yuv420", CONFIGS[1]: "yuv420",
              CONFIGS[2]: "dct"}
#: the Zipf cache cells: the paged one and its blob-cache twin
ZIPF_CONFIGS = ("configs/rnb-fused-yuv-paged-zipf.json",
                "configs/rnb-fused-yuv-zipf-cache.json")
LS = (1, 1, 1, 1)  # minimal layer sizes: the full topology, fast
CLASSES = 10
PACKED = 18816  # one 112x112 4:2:0 frame
CPU = DeviceSpec(0, "cpu")


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
def bridged():
    """(JAX variables, the port's bf16 network on the same weights)."""
    variables = jax_ckpt.init_variables(seed=0, num_classes=CLASSES,
                                        layer_sizes=LS)
    variables = {k: _randomize_bn(dict(v), np.random.default_rng(1))
                 for k, v in variables.items()}
    net = R2Plus1DClassifier(1, 5, CLASSES, LS, dtype=torch.bfloat16)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    return variables, cast_compute_weights(net).eval()


def _assert_logits_close(got, want):
    # bf16 on both sides with the same rounding points; what differs is
    # the accumulation order inside the convs (XLA vs oneDNN), re-rounded
    # to bf16 at ~20 points: bound 2% of the logit scale (0.2-0.3% seen
    # on the CPU), and the argmax must agree wherever the top-2 margin
    # exceeds twice that bound
    bound = 0.02 * float(np.abs(want).max())
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= bound
    for g, w in zip(got, want):
        top2 = np.sort(w)[-2:]
        if top2[1] - top2[0] > 2 * bound:
            assert g.argmax() == w.argmax()


def test_runner_bucketed_matches_jax_shared_apply(bridged):
    variables, net = bridged
    packed = np.random.default_rng(2).integers(0, 256, (2, 8, PACKED),
                                               dtype=np.uint8)
    want = np.asarray(_shared_apply(1, 5, CLASSES, LS,
                                    pixel_path="yuv420")(variables, packed))
    runner = R2P1DRunner(CPU, num_classes=CLASSES, layer_sizes=LS,
                         max_rows=2, pixel_path="yuv420", num_warmups=0,
                         network=net)
    (out,), _, _ = runner((PaddedBatch(torch.from_numpy(packed), 2),),
                          None, None)
    assert isinstance(out, PaddedBatch) and out.valid == 2
    _assert_logits_close(out.data.numpy(), want)


def test_runner_ragged_chunked_matches_jax_shared_apply(bridged):
    variables, net = bridged
    pool = np.random.default_rng(3).integers(0, 256, (3, 8, PACKED),
                                             dtype=np.uint8)
    want = np.asarray(_shared_apply(1, 5, CLASSES, LS, pixel_path="yuv420",
                                    ragged=True, ragged_chunk=1)(
        variables, pool, np.int32(2)))
    runner = R2P1DRunner(CPU, num_classes=CLASSES, layer_sizes=LS,
                         max_rows=3, pixel_path="yuv420", num_warmups=0,
                         ragged=True, ragged_pool_rows=3,
                         ragged_chunk_rows=1, network=net)
    batch = RaggedBatch(torch.from_numpy(pool), 2, (0, 1, 2))
    (out,), _, _ = runner((batch,), None, None)
    assert isinstance(out, RaggedBatch)
    assert out.segment_offsets == (0, 1, 2)
    got = out.data.numpy()
    _assert_logits_close(got[:2], want[:2])
    # the tile past rows_valid runs nowhere: zero in both packages
    assert not got[2].any() and not want[2].any()


def test_runner_rejects_unported_pixel_paths():
    # rgb, yuv420 and dct are ported; anything else is no pixel path
    for kwargs in (dict(pixel_path="nv12"), dict(pixel_path="RGB")):
        with pytest.raises(ValueError, match="pixel_path must be one of"):
            R2P1DRunner(CPU, num_warmups=0, **kwargs)
    # the wire paths fuse their ingest in front of layer 1 only
    with pytest.raises(ValueError, match="receives activations"):
        R2P1DRunner(CPU, start_index=2, pixel_path="yuv420",
                    num_warmups=0)


# -- the fused loader --------------------------------------------------

def _dataset(root, videos=6, frames=40):
    rng = np.random.default_rng(0)
    for i in range(videos):
        label = os.path.join(root, "label%d" % (i % 2))
        os.makedirs(label, exist_ok=True)
        write_y4m(os.path.join(label, "v%02d.y4m" % i),
                  rng.integers(0, 256, (frames, 112, 112, 3),
                               dtype=np.uint8), colorspace="420")
    return root


def _drain(loader, cards):
    emissions = []
    for tc in cards:
        out = loader(None, tc.video, tc)
        if out[2] is not None:
            emissions.append(out)
    while True:
        out = loader.flush()
        if out is None:
            return emissions
        emissions.append(out)


@pytest.mark.parametrize("ragged", [False, True])
def test_fusing_loader_fuses_and_pads(tmp_path, ragged):
    root = _dataset(str(tmp_path / "data"), videos=4)
    videos = sorted(os.path.join(d, f) for d, _, fs in os.walk(root)
                    for f in fs)
    loader = R2P1DFusingLoader(CPU, fuse=2, max_clips=3, num_warmups=1,
                               row_buckets=[1, 3], pixel_path="yuv420",
                               ragged=ragged, ragged_pool_rows=3)
    cards = []
    for i, video in enumerate(videos):
        cards.append(TimeCard(i))
        cards[-1].video = video
    emissions = _drain(loader, cards)
    seen = []
    for (batch,), _nt, tcs in emissions:
        rows = sum(tc.num_clips for tc in tcs.time_cards)
        assert batch.valid == rows <= 3
        assert len(tcs) <= 2
        if ragged:
            assert isinstance(batch, RaggedBatch)
            assert batch.data.shape[0] == 3
            assert batch.segment_offsets[-1] == rows
        else:
            assert batch.data.shape[0] in (1, 3)
            assert not batch.data[rows:].any()  # pad rows zeroed
        seen.extend(tc.id for tc in tcs.time_cards)
    assert sorted(seen) == list(range(len(videos)))
    loader.discard_pending()


# -- end to end --------------------------------------------------------

def _reduced(config, tmp_path):
    """A copy of a shipped config cut to a CPU-sized runner: 3-row
    batches, layer sizes (1,1,1,1), 10 classes."""
    with open(os.path.join(REPO, config)) as f:
        raw = json.load(f)
    loader, runner = raw["pipeline"]
    loader.update(max_clips=3, row_buckets=[1, 3],
                  fuse=min(loader["fuse"], 3))
    runner.update(max_rows=3, row_buckets=[1, 3], layer_sizes=list(LS),
                  num_classes=CLASSES)
    if "ragged" in raw:
        raw["ragged"]["pool_rows"] = 3
        runner["ragged_chunk_rows"] = 1
    if "cache_mb" in loader:
        loader["cache_mb"] = 4  # a 4 MB clip arena, not 256 MB
    path = str(tmp_path / os.path.basename(config))
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


@pytest.mark.parametrize("config", CONFIGS)
def test_run_benchmark_on_cpu_completes_every_request(tmp_path, config,
                                                      monkeypatch):
    from rnb_tpu_torch.benchmark import run_benchmark
    dct = PIXEL_PATH[config] == "dct"
    if dct:
        monkeypatch.delenv("RNB_TPU_DATA_ROOT", raising=False)
    else:
        monkeypatch.setenv("RNB_TPU_DATA_ROOT",
                           _dataset(str(tmp_path / "d")))
    _kernels.reset_launches()
    sink = {}
    result = run_benchmark(_reduced(config, tmp_path), mean_interval_ms=0,
                           num_videos=8, log_base=str(tmp_path / "logs"),
                           print_progress=False, seed=0, platform="cpu",
                           outputs_sink=sink)
    assert result.termination_flag == 0
    assert result.num_completed == 8 and result.device == "cpu"
    assert sorted(sink) == list(range(8))
    for video, logits, _stamps in sink.values():
        if dct:
            assert video.startswith("synth://kinetics/video-")
        else:
            assert video.endswith(".y4m")
        assert logits.shape[1] == CLASSES and 1 <= logits.shape[0] <= 3
        assert np.isfinite(logits).all()
    # the CPU runs the plain versions: no kernel is launched or built
    assert _kernels.launch_counts() == {"normalize_u8": 0,
                                        "yuv420_to_rgb_u8": 0,
                                        "yuv420_normalize": 0,
                                        "dct_unpack": 0, "dct_convert": 0,
                                        "dct_ingest": 0,
                                        "gather_rows": 0,
                                        "ragged_normalize_u8": 0,
                                        "ring_shift": 0}
    with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
        meta = f.read()
    assert "Termination flag: 0" in meta
    assert ("Ragged:" in meta) == ("ragged" in config)
    assert "Pixel path: %s\n" % PIXEL_PATH[config] in meta
    assert "Decode backend: %s\n" % ("synth" if dct else "native") in meta
    assert_both_checks_pass(result.log_dir)
    table = os.path.join(result.log_dir, "cpu0-group0-0.txt")
    with open(table) as f:
        lines = f.read().splitlines()
    assert lines[0].split()[:2] == ["enqueue_filename", "runner0_start"]
    assert len([ln for ln in lines[1:] if not ln.startswith("#")]) == 8

    # the log reader gives back what the run reported
    stats = summarize(result.log_dir)
    assert stats["requests"] == 8 and 1 <= stats["emissions"] <= 8
    assert stats["pixel_path"] == PIXEL_PATH[config]
    assert stats["videos_per_s"] == pytest.approx(result.throughput_vps,
                                                  rel=1e-3)
    assert stats["runner_service_ms"] > 0 and stats["runner_wait_ms"] >= 0
    assert "kernel_ms" not in stats  # no profile on the CPU
    with open(os.path.join(result.log_dir, "profile.json"), "w") as f:
        json.dump({"kernels": {
            "normalize_u8_kernel(uint4 const*)": {"device_us": 10.0,
                                                  "count": 1},
            "sm80_xmma_fprop_implicit_gemm_f32f32": {"device_us": 30.0,
                                                     "count": 2},
            "void at::native::elementwise_kernel<128>": {"device_us": 60.0,
                                                         "count": 4},
        }}, f)
    stats = summarize(result.log_dir)
    assert stats["kernel_ms"] == pytest.approx(0.1)
    assert stats["device_launches"] == 7
    assert stats["kernel_families"] == pytest.approx(
        {"ingest": 0.1, "conv_f32": 0.3, "elementwise": 0.6})


# -- the paged clip cache and feature pages ----------------------------

class _ManualPool:
    """A decode pool whose decodes run only when the test says, so the
    hit kinds arise in a fixed order."""

    def __init__(self):
        self.jobs = []

    def submit(self, fn, *args):
        future = Future()
        self.jobs.append((future, fn, args))
        return future

    def run_all(self):
        for future, fn, args in self.jobs:
            future.set_result(fn(*args))
        self.jobs = []

    def shutdown(self, wait=True, cancel_futures=False):
        del wait, cancel_futures


def _polled(loader):
    """Every emission the loader's rules let out now."""
    out = []
    while True:
        emission = loader.poll()
        if emission is None:
            return out
        out.append(emission)


def test_paged_hits_serve_the_jax_logits_and_feature_hits_are_bitwise(
        tmp_path, bridged, monkeypatch):
    variables, net = bridged
    # numpy decodes on a pool the test drives, so the hit kinds arise in
    # a fixed order
    monkeypatch.setenv("RNB_DISABLE_NATIVE", "1")
    root = _dataset(str(tmp_path / "data"), videos=2)
    video_a, video_b = sorted(os.path.join(d, f) for d, _, fs in
                              os.walk(root) for f in fs)
    loader = R2P1DFusingLoader(CPU, fuse=3, max_clips=3, num_warmups=0,
                               row_buckets=[1, 3], pixel_path="yuv420",
                               ragged=True, ragged_pool_rows=3, cache_mb=4)
    runner = R2P1DRunner(CPU, num_classes=CLASSES, layer_sizes=LS,
                         max_rows=3, pixel_path="yuv420", num_warmups=0,
                         ragged=True, ragged_pool_rows=3,
                         ragged_chunk_rows=1, network=net)
    pager = Pager(PagerSettings(page_rows=2, pool_mb=2,
                                feature_cache=True))
    loader.enable_pager(pager)
    runner.enable_pager(pager)
    loader._decode_pool = _ManualPool()
    cards = []

    def admit(video):
        cards.append(TimeCard(len(cards)))
        out = loader(None, video, cards[-1])
        return [out] if out[2] is not None else []

    # a miss, a coalesced follower, a second miss: one or two pools
    for video in (video_a, video_a, video_b):
        assert admit(video) == []
    loader._decode_pool.run_all()
    first = _polled(loader)
    # before the runner stores any logits: a clip-page hit
    second = admit(video_a)
    second += _polled(loader)
    served = {}
    for emission in first + second:
        (batch,), _, tcs = runner(*emission)
        for tc in tcs.time_cards:
            served[tc.id] = batch.data[tc.row0:tc.row0 + tc.num_clips]
    # the runner stored A's and B's logits: feature hits, emitted at once
    for video in (video_a, video_b):
        (emission,) = admit(video)
        (batch,), _, tcs = runner(*emission)
        (tc,) = tcs.time_cards
        served[tc.id] = batch.data[:tc.num_clips]
    loader.discard_pending()

    assert [(tc.cache_hit, tc.cache_coalesced, tc.feature_hit)
            for tc in cards] == [(False, False, False), (False, True, False),
                                 (False, False, False), (True, False, False),
                                 (None, False, True), (None, False, True)]
    apply = _shared_apply(1, 5, CLASSES, LS, pixel_path="yuv420",
                          ragged=True, ragged_chunk=1)
    for tc in cards:
        starts = loader._starts_cache[tc.video]
        rows = Y4MDecoder().decode_clips_yuv(tc.video, starts, 8, 112, 112)
        pool = np.zeros((3, 8, PACKED), np.uint8)
        pool[:len(rows)] = rows
        want = np.asarray(apply(variables, pool, np.int32(len(rows))))
        got = served[tc.id].numpy()
        _assert_logits_close(got, want[:len(rows)])
    # a feature hit is the first serving's rows, bit for bit
    assert served[4].numpy().tobytes() == served[0].numpy().tobytes()
    assert served[5].numpy().tobytes() == served[2].numpy().tobytes()
    assert served[1].numpy().tobytes() == served[0].numpy().tobytes()
    snap = pager.snapshot()
    assert snap["gathers"] == 1 and snap["feature_hits"] == 2
    assert snap["gather_rows"] == cards[3].num_clips
    assert snap["feature_gathers"] == 2
    assert snap["allocs"] == snap["frees"] + snap["live"]
    assert loader.ragged_stats["cache_hit_rows"] == cards[3].num_clips
    assert loader.staging.snapshot()["bypassed_batches"] == 2


def test_pager_refuses_what_the_reference_refuses():
    pager = Pager(PagerSettings(feature_cache=True))
    bucketed = R2P1DFusingLoader(CPU, max_clips=3, num_warmups=0,
                                 pixel_path="yuv420", cache_mb=1)
    with pytest.raises(ValueError, match="ragged"):
        bucketed.enable_pager(pager)
    cacheless = R2P1DFusingLoader(CPU, max_clips=3, num_warmups=0,
                                  pixel_path="yuv420", ragged=True)
    with pytest.raises(ValueError, match="cache_mb"):
        cacheless.enable_pager(pager)
    for loader in (bucketed, cacheless):
        loader.discard_pending()
    with pytest.raises(ValueError, match="ragged"):
        R2P1DRunner(CPU, num_classes=CLASSES, layer_sizes=LS, max_rows=3,
                    pixel_path="yuv420", num_warmups=0,
                    network=object()).enable_pager(pager)
    with pytest.raises(ValueError, match="end the network"):
        R2P1DRunner(CPU, end_index=4, num_classes=CLASSES, layer_sizes=LS,
                    max_rows=3, pixel_path="yuv420", num_warmups=0,
                    ragged=True, network=object()).enable_pager(pager)


@pytest.mark.parametrize("config", ZIPF_CONFIGS)
def test_zipf_configs_serve_every_request_and_foot(tmp_path, config,
                                                   monkeypatch):
    from rnb_tpu_torch.benchmark import run_benchmark
    from rnb_tpu_torch.parse_utils import main as parse_main
    monkeypatch.setenv("RNB_TPU_DATA_ROOT", _dataset(str(tmp_path / "d")))
    sink = {}
    result = run_benchmark(_reduced(config, tmp_path), mean_interval_ms=0,
                           num_videos=12, log_base=str(tmp_path / "logs"),
                           print_progress=False, seed=0, platform="cpu",
                           outputs_sink=sink)
    assert result.termination_flag == 0 and result.num_completed == 12
    assert sorted(sink) == list(range(12))
    stamps = [st for _v, _l, st in sink.values()]
    assert all(st["cache_hit"] is not None or st["feature_hit"]
               for st in stamps)
    # every request the feature pages did not answer is one clip-cache
    # lookup; a coalesced follower is counted a miss
    assert result.cache_hits + result.cache_misses \
        == sum(st["cache_hit"] is not None for st in stamps)
    assert result.cache_coalesced == sum(st["cache_coalesced"]
                                         for st in stamps)
    with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
        meta = f.read()
    assert "Cache: hits=%d misses=%d " % (result.cache_hits,
                                          result.cache_misses) in meta
    paged = "paged" in config
    assert ("Pages: arenas=2 " in meta) == paged
    assert ("Pages arenas: " in meta) == paged
    assert ("cache_hit_rows=" in meta) == paged
    stats = summarize(result.log_dir)
    assert stats["footing_problems"] == []
    assert stats["clips_per_s"] > 0 and stats["cache_hit_rate"] is not None
    if paged:
        assert result.pages["allocs"] == (result.pages["frees"]
                                          + result.pages["live"])
        assert set(stats["arenas"]) == {"clips", "features"}
    with open(os.path.join(result.log_dir, "cpu0-group0-0.txt")) as f:
        trailers = [ln for ln in f.read().splitlines() if ln[:1] == "#"]
    assert trailers[0].startswith("# cache num_hits=%d "
                                  % result.cache_hits)
    assert parse_main([result.log_dir]) == 0
    assert_both_checks_pass(result.log_dir)


def test_parse_utils_flags_a_broken_footing(tmp_path):
    from rnb_tpu_torch.parse_utils import footing_problems, read_meta
    meta = tmp_path / "log-meta.txt"
    meta.write_text(
        "Ragged: pool_rows=15 emissions=2 rows=4 pad_rows_eliminated=0 "
        "cache_hit_rows=1\n"
        "Pages: arenas=2 pages=9 page_rows=4 live=2 limbo=0 bytes=1 "
        "allocs=3 frees=0 alloc_fails=0 gathers=1 gather_rows=2 "
        "feature_lookups=1 feature_hits=2 feature_inserts=0 "
        "feature_evictions=0 feature_gathers=0 feature_gather_rows=0 "
        "feature_bytes_saved=0 feature_entries=0 bypassed_batches=0\n")
    problems = footing_problems(read_meta(str(meta)))
    assert len(problems) == 3
    assert "allocs=3" in problems[0] and "feature_hits=2" in problems[1]
    assert "gather_rows=2" in problems[2]


# -- configs -----------------------------------------------------------

@pytest.mark.parametrize("config", CONFIGS)
def test_shipped_configs_read_unchanged(config):
    cfg = load_config(os.path.join(REPO, config), platform="cpu")
    assert cfg.video_path_iterator == \
        "rnb_tpu_torch.models.r2p1d.model.R2P1DVideoPathIterator"
    assert [s.model.rpartition(".")[2] for s in cfg.steps] == [
        "R2P1DFusingLoader", "R2P1DRunner"]
    assert all(s.model.startswith("rnb_tpu_torch.") for s in cfg.steps)
    assert cfg.steps[0].groups[0].devices[0].resolve() == \
        torch.device("cpu")
    assert [s.kwargs["pixel_path"] for s in cfg.steps] == [
        PIXEL_PATH[config]] * 2


def _base_raw():
    with open(os.path.join(REPO, CONFIGS[1])) as f:
        return json.load(f)


@pytest.mark.parametrize("where,key,value", [
    ("root", "cache", {"mb": 64}),
    ("root", "shard", {}),
    ("root", "devobs", {"capture_window_ms": 300, "xplane": True}),
    ("root", "operator", {"enabled": True, "host": "0.0.0.0"}),
    ("root", "whatif", {"enabled": True}),
    ("root", "netedge", {"enabled": True}),
    ("loader", "pixel_path", "nv12"),
    ("runner", "pixel_path", "nv12"),
    ("runner", "shard", {"degree": 2}),
    ("loader", "raw_output", True),
    ("loader", "enable_autotune", True),
    ("runner", "replicas", 2),
    ("runner", "hedge_ms", 5),
    ("runner", "ckpt_path", "weights.npz"),
    ("runner", "async_dispatch", True),
    ("group", "queue_selector", "rnb_tpu.selector.ReplicaSelector"),
    ("group", "take_shed", True),
])
def test_unported_keys_are_refused(where, key, value):
    raw = _base_raw()
    target = {"root": raw, "loader": raw["pipeline"][0],
              "runner": raw["pipeline"][1],
              "group": raw["pipeline"][0]["queue_groups"][0]}[where]
    target[key] = value
    # devobs, operator, whatif, netedge, the step-level shard key and
    # the replica lanes are ported: an unknown devobs or operator key,
    # whatif without metrics, an edge with neither a peer to dial nor
    # one to spawn, a degree-2 ring or two replicas on a one-device
    # group, and hedging on a step without lanes, are refused with the
    # reference's messages; ReplicaSelector on an ordinary edge reads,
    # as in the reference (it routes round-robin there)
    if (where, key) == ("group", "queue_selector"):
        config = parse_config(raw, platform="cpu")
        assert config.steps[0].groups[0].queue_selector == \
            "rnb_tpu_torch.selector.ReplicaSelector"
        return
    if (where, key) == ("runner", "ckpt_path"):
        # ported with the checkpoint store: the runner reads it
        assert parse_config(raw, platform="cpu").steps[1].kwargs[
            "ckpt_path"] == "weights.npz"
        return
    if (where, key) == ("runner", "async_dispatch"):
        # ported with the loader and launch keys: a step key, not a
        # stage kwarg
        config = parse_config(raw, platform="cpu")
        assert config.steps[1].async_dispatch is True
        assert key not in config.steps[1].kwargs
        return
    message = {("root", "devobs"): r"'devobs' has unknown key\(s\) "
                                   r"\['xplane'\]",
               ("root", "operator"): r"'operator' has unknown key\(s\) "
                                     r"\['host'\]",
               ("root", "whatif"): r"'whatif' requires an enabled root "
                                   r"'metrics' key",
               ("root", "netedge"): r"invalid 'netedge': netedge needs "
                                    r"'connect'",
               ("runner", "shard"): r"'shard.degree'=2 needs exactly that "
                                    r"many devices per lane \(got 1\)",
               ("runner", "replicas"): r"pipeline step 1: 'replicas'=2 must "
                                       r"evenly divide the 1-entry device "
                                       r"list",
               ("runner", "hedge_ms"): r"pipeline step 1: 'hedge_ms' needs "
                                       r"replica lanes to re-dispatch onto"
               }.get((where, key), "not yet ported")
    with pytest.raises(ConfigError, match=message):
        parse_config(raw, platform="cpu")


@pytest.mark.parametrize("where,key,value", [
    ("root", "metrics", {"interval_ms": 100}),
    ("root", "metrics", {"flight_recorder": {"ring_events": 64,
                                             "queue_saturation": 1}}),
    ("root", "autotune", {"enabled": True}),
    ("root", "autotune", {"slo_ms": 20, "buckets": [6, 15]}),
    ("root", "critpath", {"enabled": True}),
    ("root", "overload_policy", "shed"),
    ("root", "fault_containment", False),
    ("root", "fault_plan", {"seed": 3, "faults": [
        {"step": 1, "kind": "transient", "request_ids": [3]},
        {"kind": "stall", "ms": 5, "probability": 0.1}]}),
    ("root", "deadline", {"budget_ms": 250}),
    ("root", "deadline", {"enabled": False}),
    ("loader", "autotune", True),
    ("runner", "autotune", False),
    ("loader", "max_retries", 2),
    ("runner", "retry_backoff_ms", 5),
])
def test_ported_plane_keys_are_read(where, key, value):
    raw = _base_raw()
    target = {"root": raw, "loader": raw["pipeline"][0],
              "runner": raw["pipeline"][1]}[where]
    target[key] = value
    config = parse_config(raw, platform="cpu")
    if where == "root":
        assert getattr(config, key) == value
    else:
        step = config.steps[where == "runner"]
        assert getattr(step, key) == value and key not in step.kwargs


def test_the_critpath_copy_of_the_traced_config_is_read(tmp_path):
    with open(os.path.join(REPO, "configs/rnb-fused-yuv-traced.json")) as f:
        raw = json.load(f)
    raw["critpath"] = {"enabled": True}
    path = str(tmp_path / "rnb-fused-yuv-traced-critpath.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    config = load_config(path, platform="cpu")
    assert config.critpath == {"enabled": True}
    assert config.trace["enabled"] is True


@pytest.mark.parametrize("where,key,value", [
    ("root", "metrics", {"enabled": "yes"}),
    ("root", "metrics", {"interval_ms": 0}),
    ("root", "metrics", {"interval_ms": -5}),
    ("root", "metrics", {"flight_recorder": {"rings": 4}}),
    ("root", "metrics", {"flight_recorder": {"ring_events": 0}}),
    ("root", "metrics", {"flight_recorder": {"queue_saturation": 1.5}}),
    ("root", "metrics", {"flight_recorder": "on"}),
    ("root", "metrics", {"interval": 100}),
    ("root", "metrics", []),
    ("root", "critpath", {"enabled": 1}),
    ("root", "critpath", {"mode": "fast"}),
    ("root", "autotune", {"enabled": "true"}),
    ("root", "autotune", {"slo_ms": 0}),
    ("root", "autotune", {"slo_ms": "50"}),
    ("root", "autotune", {"ewma_alpha": 1.5}),
    ("root", "autotune", {"min_hold_ms": 5, "max_hold_ms": 1}),
    ("root", "autotune", {"buckets": [6, 6]}),
    ("root", "autotune", {"budget": 3}),
    ("loader", "autotune", "no"),
    ("root", "overload_policy", "drop"),
    ("root", "fault_containment", "yes"),
    ("root", "fault_plan", {"faults": [{"step": 5, "kind": "transient",
                                        "request_ids": [1]}]}),
    ("root", "fault_plan", {"faults": "all"}),
    ("root", "fault_plan", {"faults": [{"kind": "stall",
                                        "probability": 0.5}]}),
    ("root", "deadline", {"budget_ms": 0}),
    ("root", "deadline", {"budget": 5}),
    ("root", "deadline", {"enabled": "no"}),
    ("root", "deadline", []),
    ("loader", "max_retries", -1),
    ("loader", "max_retries", 1.5),
    ("runner", "retry_backoff_ms", -5),
    ("runner", "retry_backoff_ms", "5"),
])
def test_bad_plane_values_fail_with_the_reference_message(where, key,
                                                          value):
    from rnb_tpu import config as jax_config
    raw = _base_raw()
    target = {"root": raw, "loader": raw["pipeline"][0],
              "runner": raw["pipeline"][1]}[where]
    target[key] = value
    with pytest.raises(jax_config.ConfigError) as jax_error:
        jax_config.parse_config(json.loads(json.dumps(raw)))
    with pytest.raises(ConfigError) as port_error:
        parse_config(raw, platform="cpu")
    assert str(port_error.value) == str(jax_error.value)


@pytest.mark.parametrize("base,where,value", [
    # the ragged base: the root key is unknown to both readers, and the
    # root 'ragged' key refuses segments before any step is read
    (1, "root", 2),
    (1, "loader", 2),
    # the bucketed base: 'row_buckets' refuses segments, the last step
    # may have none, and the count must be a positive integer
    (0, "loader", 2),
    (0, "runner", 2),
    (0, "loader", 0),
])
def test_num_segments_refused_with_the_reference_message(base, where, value):
    from rnb_tpu import config as jax_config
    with open(os.path.join(REPO, CONFIGS[base])) as f:
        raw = json.load(f)
    target = {"root": raw, "loader": raw["pipeline"][0],
              "runner": raw["pipeline"][1]}[where]
    target["num_segments"] = value
    with pytest.raises(jax_config.ConfigError) as jax_error:
        jax_config.parse_config(json.loads(json.dumps(raw)))
    with pytest.raises(ConfigError) as port_error:
        parse_config(raw, platform="cpu")
    if where == "root":
        # a step key on the root: both readers refuse it as a key they
        # do not read there
        assert "unknown root key(s) ['num_segments']" in str(
            jax_error.value)
        assert str(port_error.value) == ("root key 'num_segments' is not "
                                         "yet ported to rnb_tpu_torch")
    else:
        assert str(port_error.value) == str(jax_error.value)


def test_device_mapping_and_platform_guard(monkeypatch):
    assert DeviceSpec(-1, "cuda").resolve() == torch.device("cpu")
    assert DeviceSpec(-1).label == "host"
    assert DeviceSpec(0, "cpu").label == "cpu:0"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceResolutionError):
        parse_config(_base_raw())  # no card and no cpu request: raise
