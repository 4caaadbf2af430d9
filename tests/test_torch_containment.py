"""Fault containment and deadlines end to end on the CPU, held to the JAX
package.

The chaos copy of ``configs/rnb-fused-yuv-staged.json`` (the fused
yuv420 loader and the runner, cut to a CPU-sized runner as
``tests/test_torch_metrics.py`` cuts it: 3-row buckets, layer sizes
(1, 1, 1, 1), 10 classes) with ``overload_policy: "shed"``, a retry
budget on both steps, a deadline and a seeded fault plan (permanent
faults at step 0, transients at step 1 on ids no fused take can hold
together) runs through both packages' ``run_benchmark``: the same
dead-lettered ids, retries and ``Faults:``/``Failure reasons:`` lines,
the same ``failed-requests.txt``, and every served request's logits
within 2% of the logit scale of the JAX stages' on the JAX package's
weights. The one-card copy of ``configs/r2p1d-tiny-shed.json`` under a
deadline and a step-0 stall longer than the budget sheds the same ids at
the same sites in both (``Shed sites:``, ``Deadline sites:``). In the
port alone: a run that sheds far more requests at step 1 than the
producer has ring credits ends; a forked segment card never sheds;
``fault_containment: false`` aborts; the fusing loader contains a failed
decode inside its take (the chaos dataset's broken video through the
native decoder among them) and retries a transient one; a kernel or
decoder library that fails to load aborts the stage call; and
``parse_utils``
passes the job directories and catches an altered ``Shed sites:`` or
``Deadline sites:`` line.
"""

import json
import os
import shutil
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from rnb_tpu.benchmark import run_benchmark as jax_run_benchmark
from rnb_tpu.decode import get_decoder as jax_get_decoder
from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.models.r2p1d.model import _shared_apply
from rnb_tpu.models.r2p1d.sampler import R2P1DSampler as JaxSampler
from rnb_tpu_torch import metrics, trace
from rnb_tpu_torch.batcher import Batcher
from rnb_tpu_torch.benchmark import run_benchmark
from rnb_tpu_torch.control import TerminationFlag
from rnb_tpu_torch.decode import (CorruptVideoError, TransientDecodeError,
                                  write_y4m)
from rnb_tpu_torch.health import DeadlineSettings
from rnb_tpu_torch.models.r2p1d import model as port_model
from rnb_tpu_torch.models.r2p1d.checkpoint import (filter_layer_range,
                                                   from_jax_variables)
from rnb_tpu_torch.models.r2p1d.network import (R2Plus1DClassifier,
                                                cast_compute_weights)
from rnb_tpu_torch.parse_utils import (fault_problems, read_dead_letters,
                                       read_meta, summarize)
from rnb_tpu_torch.runner import (RunnerContext, _overloaded,
                                  _sheddable_expired)
from rnb_tpu_torch.stage import PaddedBatch
from rnb_tpu_torch.telemetry import TimeCard, TimeCardList
from torch_job_checks import assert_both_checks_pass

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LS = (1, 1, 1, 1)
CLASSES = 10
REQUESTS = 20
#: permanent at step 0 and transient at step 1, on ids no fused take of
#: three requests can hold two of
PERMANENT_IDS = [2, 9]
TRANSIENT_IDS = [4, 15]
CHAOS_PLAN = {"seed": 7, "faults": [
    {"step": 0, "kind": "permanent", "request_ids": PERMANENT_IDS},
    {"step": 1, "kind": "transient", "request_ids": TRANSIENT_IDS}]}


def _dataset(root, videos=6, frames=40):
    rng = np.random.default_rng(0)
    for i in range(videos):
        label = os.path.join(root, "label%d" % (i % 2))
        os.makedirs(label, exist_ok=True)
        write_y4m(os.path.join(label, "v%02d.y4m" % i),
                  rng.integers(0, 256, (frames, 112, 112, 3),
                               dtype=np.uint8), colorspace="420")
    return root


def _write(tmp, name, raw):
    path = os.path.join(tmp, name + ".json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _chaos_copy(tmp, plan=CHAOS_PLAN, **root):
    """The chaos copy of the staged cell, cut to the CPU."""
    with open(os.path.join(REPO, "configs/rnb-fused-yuv-staged.json")) as f:
        raw = json.load(f)
    raw.update(overload_policy="shed", fault_plan=plan,
               deadline={"budget_ms": 600000}, **root)
    loader, runner = raw["pipeline"]
    loader.update(max_clips=3, row_buckets=[1, 3], fuse=3)
    runner.update(max_rows=3, row_buckets=[1, 3], layer_sizes=list(LS),
                  num_classes=CLASSES)
    for step in (loader, runner):
        step.update(max_retries=2, retry_backoff_ms=5)
    return _write(tmp, "chaos-%d" % len(os.listdir(tmp)), raw)


def _tiny_shed_copy(tmp, name, **root):
    """``configs/r2p1d-tiny-shed.json`` on one card (devices 0 and 1
    made 0), with root keys added."""
    with open(os.path.join(REPO, "configs/r2p1d-tiny-shed.json")) as f:
        raw = json.load(f)
    for step in raw["pipeline"]:
        for group in step["queue_groups"]:
            group["devices"] = [0 for _ in group["devices"]]
    raw.update(root)
    return _write(tmp, name, raw)


def _jax_logits(weights, video, n):
    """The JAX stages' logits for one served request."""
    decoder = jax_get_decoder(video)
    starts = JaxSampler(consecutive_frames=8).sample(
        decoder.num_frames(video), video_id=video)[:3]
    rows = np.asarray(decoder.decode_clips_yuv(video, starts, 8, 112, 112))
    assert len(rows) == n
    pool = np.zeros((3,) + rows.shape[1:], np.uint8)
    pool[:n] = rows
    apply = _shared_apply(1, 5, CLASSES, LS, pixel_path="yuv420")
    return np.asarray(apply(weights, pool))[:n]


def _meta_lines(log_dir, heads):
    with open(os.path.join(log_dir, "log-meta.txt")) as f:
        return [line for line in f.read().splitlines()
                if line.split(":")[0] in heads]


FAULT_HEADS = ("Faults", "Failure reasons", "Shed sites", "Queue overflows",
               "Deadline", "Deadline sites")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the slice, once: the chaos copy through both
    packages, the tiny-shed deadline copy through both, and the port's
    own runs."""
    weights = jax_ckpt.load_or_init(1, 5, CLASSES, LS, None)
    state = from_jax_variables(weights)
    seeded = port_model.shared_network

    def shared_network(start, end, num_classes, layer_sizes, device,
                       dtype=torch.bfloat16, factored_shortcut=False):
        if num_classes != CLASSES:
            # the tiny-shed runs: their logits are not compared
            return seeded(start, end, num_classes, layer_sizes, device,
                          dtype, factored_shortcut)
        net = R2Plus1DClassifier(start, end, num_classes, layer_sizes,
                                 factored_shortcut, dtype=dtype)
        net.load_state_dict(filter_layer_range(state, start, end),
                            strict=True)
        return cast_compute_weights(net).to(device).eval()

    tmp = str(tmp_path_factory.mktemp("containment"))
    configs = os.path.join(tmp, "configs")
    os.makedirs(configs)
    out = {"weights": weights}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_model, "shared_network", shared_network)
        mp.setenv("RNB_TPU_DATA_ROOT", _dataset(os.path.join(tmp, "data")))
        mp.delenv("RNB_FAULT_PLAN", raising=False)
        chaos = _chaos_copy(configs)
        # a deadline shorter than a stall on the first request: every
        # request is shed, and where is fixed by the topology
        deadline = _tiny_shed_copy(
            configs, "tiny-shed-deadline", deadline={"budget_ms": 200},
            fault_plan={"faults": [{"step": 0, "kind": "stall", "ms": 800,
                                    "request_ids": [0]}]})
        for label, path, videos in (("chaos", chaos, REQUESTS),
                                    ("deadline", deadline, 8)):
            sink = {}
            result = run_benchmark(
                path, mean_interval_ms=0, num_videos=videos,
                log_base=os.path.join(tmp, "logs", label),
                print_progress=False, seed=0, platform="cpu",
                outputs_sink=sink)
            assert metrics.ACTIVE is None and trace.ACTIVE is None
            reference = jax_run_benchmark(
                path, mean_interval_ms=0, num_videos=videos,
                queue_size=500, log_base=os.path.join(tmp, "jax", label),
                print_progress=False, seed=0)
            out[label] = (result, sink, reference)
        # step 1 serves every dispatch 1500 ms late under a 2000 ms
        # budget with two ring credits, at a 100 ms Poisson mean: the
        # second request is served within its budget, the three behind
        # it (two in step 1's queue, one its producer holds) expire there
        # while it is served, and the rest at step 0. The budget, the
        # latency and the arrival interval are ten times what they were
        # (200 ms, 150 ms, 10 ms), so that a host busy with other work
        # (the suite's parallel workers) keeps the margins: at the old
        # scale some 60 ms of delay moved the expiries to step 0
        ring = _tiny_shed_copy(
            configs, "tiny-shed-ring", deadline={"budget_ms": 2000},
            fault_plan={"faults": [{"step": 1, "kind": "latency",
                                    "ms": 1500, "probability": 1.0}]})
        with open(ring) as f:
            raw = json.load(f)
        raw["pipeline"][0]["num_shared_tensors"] = 2
        ring = _write(configs, "tiny-shed-ring", raw)
        out["ring"] = run_benchmark(
            ring, mean_interval_ms=100, num_videos=30, queue_size=100,
            log_base=os.path.join(tmp, "logs", "ring"),
            print_progress=False, seed=0, platform="cpu")
        strict = _chaos_copy(configs, fault_containment=False)
        out["strict"] = run_benchmark(
            strict, mean_interval_ms=0, num_videos=8,
            log_base=os.path.join(tmp, "logs", "strict"),
            print_progress=False, seed=0, platform="cpu")
    return out


def test_the_chaos_copy_contains_as_the_reference(runs):
    result, sink, reference = runs["chaos"]
    assert result.termination_flag == reference.termination_flag == 0
    assert (result.num_failed, result.num_retries, result.num_shed) == \
        (reference.num_failed, reference.num_retries,
         reference.num_shed) == (2, 2, 0)
    assert result.failure_reasons == reference.failure_reasons == {
        "injected-permanent": 2}
    assert _meta_lines(result.log_dir, FAULT_HEADS) == \
        _meta_lines(reference.log_dir, FAULT_HEADS)
    assert read_dead_letters(result.log_dir) == [
        (rid, 0, "injected-permanent") for rid in PERMANENT_IDS]
    with open(os.path.join(result.log_dir, "failed-requests.txt")) as f, \
            open(os.path.join(reference.log_dir,
                              "failed-requests.txt")) as g:
        assert f.read() == g.read()
    # the batchmates of a dead letter are served, the retried ones too
    assert sorted(sink) == sorted(set(range(REQUESTS))
                                  - set(PERMANENT_IDS))
    assert result.num_completed == REQUESTS - 2
    stats = summarize(result.log_dir)
    assert stats["footing_problems"] == []
    assert stats["compile_signatures"]["step1"]["steady_new"] == 0


def test_the_chaos_copy_serves_the_jax_logits(runs):
    weights = runs["weights"]
    _, sink, _ = runs["chaos"]
    for rid, (video, logits, _stamps) in sink.items():
        want = _jax_logits(weights, video, len(logits))
        bound = 0.02 * float(np.abs(want).max())
        assert logits.shape == want.shape
        assert np.abs(logits - want).max() <= bound, rid


def test_a_deadline_sheds_the_reference_ids_at_its_sites(runs):
    result, sink, reference = runs["deadline"]
    assert result.termination_flag == reference.termination_flag == 0
    assert not sink and result.num_completed == 0
    assert result.shed_sites == reference.shed_sites == {
        "step0_publish:deadline_expired": 1,
        "step0_take:deadline_expired": 7}
    assert result.deadline_sites == reference.deadline_sites == \
        result.shed_sites
    assert result.deadline_expired == reference.deadline_expired == 8
    assert _meta_lines(result.log_dir, FAULT_HEADS) == \
        _meta_lines(reference.log_dir, FAULT_HEADS)
    assert summarize(result.log_dir)["footing_problems"] == []


def test_more_sheds_than_ring_credits_and_the_run_ends(runs):
    result = runs["ring"]
    assert result.termination_flag == 0
    step1 = result.shed_sites.get("step1_take:deadline_expired", 0)
    # every one of them gave its producer's credit back: two credits
    # could carry no more than two
    assert step1 > 2, result.shed_sites
    assert result.num_completed + result.num_failed + result.num_shed \
        >= 30
    assert summarize(result.log_dir)["footing_problems"] == []


def test_fault_containment_false_aborts(runs):
    assert runs["strict"].termination_flag == \
        TerminationFlag.INTERNAL_ERROR


def test_a_forked_segment_card_never_sheds():
    deadline = DeadlineSettings(1.0)
    ctx = RunnerContext(in_queue=None, out_queues=None, job_id="j",
                        device=None, group_idx=0, instance_idx=0,
                        counter=None, num_videos=1, termination=None,
                        step_idx=1, sta_bar=None, fin_bar=None,
                        model_class_path="x", deadline=deadline,
                        overload_policy="shed", num_segments=3)
    card = TimeCard(0)
    card.deadline_s = 1.0  # long past
    fork = card.fork(1)
    assert _sheddable_expired(ctx, card)
    assert _sheddable_expired(ctx, TimeCardList([card]))
    assert not _sheddable_expired(ctx, fork)

    class Full:
        maxsize = 2

        @staticmethod
        def qsize():
            return 2

    assert _overloaded(ctx, Full, card) and not _overloaded(ctx, Full, fork)
    # the Batcher's emit boundary drops the expired card, keeps the fork
    batcher = Batcher(torch.device("cpu"), batch=4, shapes=[(3, 2)],
                      max_rows=3)
    for tc in (card, fork):
        batcher(((PaddedBatch(torch.ones(1, 2), 1),)), None, tc)
    out = batcher.flush()
    assert out[2].time_cards == [fork]
    assert batcher.take_shed() == [(card, "hold")]


def _loader():
    return port_model.R2P1DFusingLoader(
        torch.device("cpu"), fuse=3, max_clips=15, num_warmups=0,
        row_buckets=[6, 15], pixel_path="yuv420")


def _future(error=None):
    future = Future()
    if error is None:
        future.set_result(None)
    else:
        future.set_exception(error)
    return future


def _admitted(loader, rid, error=None):
    """A request planned into the loader's rows whose decode ends in
    ``error`` (or succeeds), as a numpy decode thread would leave it."""
    tc = TimeCard(rid)
    video = "synth://video-%d" % rid
    starts = loader._sample_starts(port_model.get_decoder(video), video)
    tc.num_clips = len(starts)
    slot, row0 = loader._stage_target(len(starts))
    rec = port_model._FuseRecord(len(starts), tc, slot, row0, video=video)
    rec.future = _future(error)
    loader._inflight.append(rec)
    return tc, starts


def _drain(loader):
    emissions = []
    while True:
        out = loader.flush()
        if out is None:
            return emissions
        emissions.append(out)


def test_the_fusing_loader_contains_a_decode_inside_its_take():
    """A permanent decode failure leaves the take and the survivors are
    emitted in a warmed bucket; a transient one is re-decoded into the
    same rows within the budget; every slot comes back."""
    loader = _loader()
    loader.fault_retry_budget = (1, 0.0)
    bad, _ = _admitted(loader, 0, CorruptVideoError("bad stream"))
    good, _ = _admitted(loader, 1)
    retried, starts = _admitted(loader, 2, TransientDecodeError("rc -1"))
    (emission,) = _drain(loader)
    assert emission[2].time_cards == [good, retried]
    pb = emission[0][0]
    assert pb.valid == good.num_clips + retried.num_clips
    assert int(pb.data.shape[0]) == (6 if pb.valid <= 6 else 15)
    want = port_model.get_decoder("synth://video-2").decode_clips_yuv(
        "synth://video-2", starts, 8, 112, 112)
    rows = pb.data[retried.row0:retried.row0 + retried.num_clips]
    assert np.array_equal(rows.numpy(), want)
    assert loader.take_failed() == [(bad, "corrupt-video")]
    assert loader.take_retries() == 1
    loader.discard_pending()
    assert loader.staging.available() == loader.DEFAULT_STAGING_SLOTS


def test_the_fusing_loader_parks_an_exhausted_transient():
    loader = _loader()
    tc, _ = _admitted(loader, 0, TransientDecodeError("rc -1"))
    assert _drain(loader) == []
    assert loader.take_failed() == [(tc, "retries-exhausted:decode-io")]
    assert loader.take_retries() == 0
    loader.discard_pending()
    assert loader.staging.available() == loader.DEFAULT_STAGING_SLOTS


def _admitted_native(loader, rid, video):
    """A request planned into the loader's rows with its native decode
    queued, as the loader's ``__call__`` leaves it."""
    tc = TimeCard(rid)
    tc.video = video
    decoder = port_model.get_decoder(video)
    starts = loader._sample_starts(decoder, video)
    tc.num_clips = len(starts)
    slot, row0 = loader._stage_target(len(starts))
    rec = port_model._FuseRecord(len(starts), tc, slot, row0, video=video)
    rec.tickets = port_model.submit_native(video, starts, 8, rec.rows,
                                           "yuv420")
    loader._inflight.append(rec)
    return tc, starts


def test_the_chaos_dataset_s_broken_video_fails_inside_the_take(tmp_path):
    """The chaos dataset's broken video probes, is planned into its rows,
    and its native decode fails when the take waits it: it leaves the
    take as corrupt-video, and its batchmates are emitted in a warmed
    bucket with their own rows."""
    from rnb_tpu_torch.faults import PERMANENT, classify_error, fault_reason
    from rnb_tpu_torch.tools import chaos
    from rnb_tpu_torch.video_path_provider import scan_video_tree
    data = _dataset(str(tmp_path / "data"), videos=2, frames=24)
    broken = chaos.write_chaos_dataset(data, str(tmp_path / "chaos"))
    videos = scan_video_tree(str(tmp_path / "chaos"))
    assert videos.index(broken) == 1 and len(videos) == 3
    decoder = port_model.get_decoder(broken)
    assert decoder.BACKEND == "native" and decoder.num_frames(broken) == 128
    with pytest.raises(CorruptVideoError) as info:
        decoder.decode_clips_yuv(broken, [0], 8, 112, 112)
    assert classify_error(info.value) is PERMANENT
    assert fault_reason(info.value) == "corrupt-video"
    loader = _loader()
    admitted = [_admitted_native(loader, rid, video)
                for rid, video in enumerate(videos)]
    (emission,) = _drain(loader)
    (good, good_starts), (bad, _), (last, last_starts) = admitted
    assert emission[2].time_cards == [good, last]
    pb = emission[0][0]
    assert pb.valid == good.num_clips + last.num_clips
    assert int(pb.data.shape[0]) == (6 if pb.valid <= 6 else 15)
    for tc, starts in ((good, good_starts), (last, last_starts)):
        want = port_model.get_decoder(tc.video).decode_clips_yuv(
            tc.video, starts, 8, 112, 112)
        rows = pb.data[tc.row0:tc.row0 + tc.num_clips]
        assert np.array_equal(rows.numpy(), want)
    assert loader.take_failed() == [(bad, "corrupt-video")]
    assert loader.take_retries() == 0
    loader.discard_pending()
    assert loader.staging.available() == loader.DEFAULT_STAGING_SLOTS


def _broken_library(monkeypatch, tmp_path, which):
    """Point the kernel libraries or the native decoder at a file that
    is there but no shared library: loading it raises an OSError."""
    from rnb_tpu_torch.decode import native
    from rnb_tpu_torch.ops import _kernels, _native
    junk = tmp_path / "libjunk.so"
    junk.write_bytes(b"not an ELF file")
    if which == "kernel":
        monkeypatch.setattr(_kernels, "library_path", lambda source: str(junk))
        monkeypatch.setattr(_kernels, "_libraries", {})
        kernel = _kernels.Kernel("normalize_u8", "ingest.cu",
                                 "rnb_normalize_u8", [], "a test")
        return kernel._bind
    monkeypatch.setattr(_native, "library_path", lambda: str(junk))
    monkeypatch.setattr(native, "_lib", None)
    return native.load_native


@pytest.mark.parametrize("which", ["kernel", "native"])
def test_a_library_that_fails_to_load_aborts_the_run(monkeypatch, tmp_path,
                                                      which):
    """A kernel or decoder library that cannot be loaded raises a fatal
    error, so the stage call aborts instead of retrying and
    dead-lettering every request that needs it."""
    import ctypes
    from rnb_tpu_torch.control import FaultStats
    from rnb_tpu_torch.faults import FATAL, classify_error
    from rnb_tpu_torch.runner import _call_stage
    load = _broken_library(monkeypatch, tmp_path, which)
    with pytest.raises(OSError):
        ctypes.CDLL(str(tmp_path / "libjunk.so"))
    with pytest.raises(RuntimeError) as info:
        load()
    assert classify_error(info.value) is FATAL
    assert isinstance(info.value.__cause__, OSError)
    stats = FaultStats()
    ctx = RunnerContext(in_queue=None, out_queues=None, job_id="j",
                        device=None, group_idx=0, instance_idx=0,
                        counter=None, num_videos=1, termination=None,
                        step_idx=1, sta_bar=None, fin_bar=None,
                        model_class_path="x", max_retries=2,
                        retry_backoff_ms=0, fault_stats=stats)

    def model(payload, non_tensors, time_card):
        load()

    with pytest.raises(RuntimeError):
        _call_stage(ctx, model, None, None, TimeCard(0), None, None,
                    "runner1_start", "exec1.model_call")
    assert (stats.num_failed, stats.num_retries) == (0, 0)


def _alter(meta_path, head, old, new):
    with open(meta_path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if line.startswith(head + ": "):
            assert old in line
            lines[i] = line.replace(old, new)
    with open(meta_path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("drift", ["shed-sites", "deadline-sites",
                                   "failure-reasons", "dead-letters"])
def test_parse_utils_catches_an_altered_ledger(runs, tmp_path, drift):
    label = "chaos" if drift in ("failure-reasons", "dead-letters") \
        else "deadline"
    src = runs[label][0].log_dir
    job = str(tmp_path / "job")
    shutil.copytree(src, job)
    meta_path = os.path.join(job, "log-meta.txt")
    assert fault_problems(job, read_meta(meta_path)) == []
    if drift == "shed-sites":
        _alter(meta_path, "Shed sites", '"step0_take:deadline_expired": 7',
               '"step0_take:deadline_expired": 6, "step1_out_queue": 1')
    elif drift == "deadline-sites":
        _alter(meta_path, "Deadline sites",
               '"step0_publish:deadline_expired": 1, '
               '"step0_take:deadline_expired": 7',
               '"step0_take:deadline_expired": 8')
    elif drift == "failure-reasons":
        _alter(meta_path, "Failure reasons", '{"injected-permanent": 2}',
               '{"injected-permanent": 1, "os-error": 1}')
    else:
        with open(os.path.join(job, "failed-requests.txt"), "a") as f:
            f.write("11 0 injected-permanent\n")
    problems = fault_problems(job, read_meta(meta_path))
    assert problems, drift


@pytest.mark.parametrize("kind", ["replica_crash", "net_reset"])
def test_a_plan_no_path_can_inject_is_refused_as_the_reference(
        tmp_path, kind):
    """The plan validates, and the run stops before it starts with the
    reference's message: the port has no replica lane, and this config
    no enabled network edge."""
    fault = {"kind": kind, "request_ids": [1]}
    if kind == "replica_crash":
        fault["step"] = 1
    path = _tiny_shed_copy(str(tmp_path), "refused",
                           fault_plan={"faults": [fault]})
    with pytest.raises(ValueError) as want:
        jax_run_benchmark(path, mean_interval_ms=0, num_videos=2,
                          log_base=str(tmp_path / "jax"),
                          print_progress=False)
    with pytest.raises(ValueError) as got:
        run_benchmark(path, mean_interval_ms=0, num_videos=2,
                      log_base=str(tmp_path / "port"), print_progress=False,
                      platform="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("empty_plan", [False, True])
def test_the_smoke_s_chaos_copy_reads_as_the_reference_reads_it(
        tmp_path, empty_plan):
    from rnb_tpu import config as jax_config
    from rnb_tpu_torch.config import load_config
    from rnb_tpu_torch.tools import chaos
    path = chaos.write_chaos_copy(str(tmp_path / "chaos.json"), empty_plan)
    cfg, jax_cfg = load_config(path, platform="cpu"), \
        jax_config.load_config(path)
    assert cfg.overload_policy == jax_cfg.overload_policy == "shed"
    assert cfg.fault_plan == jax_cfg.fault_plan
    assert bool(cfg.fault_plan["faults"]) is not empty_plan
    assert [(s.max_retries, s.retry_backoff_ms) for s in cfg.steps] == \
        [(s.max_retries, s.retry_backoff_ms) for s in jax_cfg.steps] == \
        [(2, 5.0)] * 2
    budget = DeadlineSettings.from_config(cfg.deadline).budget_ms
    if empty_plan:
        assert budget == chaos.EMPTY_PLAN_BUDGET_MS
    else:
        # the stalls outlast the budget: what waits behind them expires
        assert budget == chaos.BUDGET_MS < chaos.STALL_MS


@pytest.mark.parametrize("label", ["chaos", "deadline", "ring"])
def test_both_check_jobs_pass_the_containment_job_dirs(runs, label):
    run = runs[label]
    assert_both_checks_pass((run[0] if isinstance(run, tuple)
                             else run).log_dir)
