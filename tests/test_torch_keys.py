"""The loader and launch keys the port reads since MJPEG was ported, and
the busy-card probe, against the JAX package on the CPU.

* Each key parses as the reference's ``parse_config`` parses it: the
  same values read, the same bad values refused with the same message —
  the loaders' ``fallback_decode_threads``, ``staging_slots`` and
  ``transfer_async``, a step's ``async_dispatch``, a group's ``gpus``
  (``devices`` wins where both stand, through replica and shard
  expansion too) and the root ``lint`` key.
* Their semantics: the fallback pool's width, the plain loader's slot
  count (the reference's floor, 0 for none), the refusals of
  ``transfer_async`` on the plain loader and of ``prefetch`` on the
  fusing loader with the reference's messages, ``async_dispatch``
  skipping the executor's wait for that step only (and refused, where
  the reference reads it, on a replica step that feeds another step:
  its lanes' streams are not joined into the consumer's), a witness-armed
  run writing ``Locks:`` and ``Lock edges:`` lines that the reference's
  ``scripts/parse_utils.py`` reads and checks clean.
* ``devices.probe_busy_devices`` on mocked ``nvidia-smi -q -x`` readings
  (host pids, and a pid namespace that names every process pid 1): it warns
  about a card another process holds memory on, never about this
  process's own context, and never aborts a run.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from rnb_tpu import config as jax_config
from rnb_tpu.decode.native import \
    default_decode_threads as jax_default_decode_threads
from rnb_tpu.models.r2p1d import model as jax_model
from rnb_tpu_torch import benchmark as port_benchmark
from rnb_tpu_torch import devices, lockwitness, runner
from rnb_tpu_torch.config import ConfigError, parse_config
from rnb_tpu_torch.decode.native import default_decode_threads
from rnb_tpu_torch.devices import DeviceSpec, probe_busy_devices
from rnb_tpu_torch.models.r2p1d.model import (R2P1DFusingLoader,
                                              R2P1DLoader)
from rnb_tpu_torch.parse_utils import lock_problems, read_meta
from rnb_tpu_torch.telemetry import TimeCard

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import parse_utils as ref_parse_utils  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = DeviceSpec(0, "cpu")
WHOLE = "configs/r2p1d-whole.json"
FUSED = "configs/rnb-fused-yuv-big.json"


def _raw(config):
    with open(os.path.join(REPO, config)) as f:
        return json.load(f)


def _both(raw):
    """``(port config or its error, reference config or its error)``."""
    out = []
    for parse in (lambda r: parse_config(r, platform="cpu"),
                  jax_config.parse_config):
        try:
            out.append(parse(copy.deepcopy(raw)))
        except (ConfigError, jax_config.ConfigError) as e:
            out.append(e)
    return out


def _refused_alike(raw):
    ours, theirs = _both(raw)
    assert isinstance(ours, ConfigError), ours
    assert isinstance(theirs, jax_config.ConfigError), theirs
    assert str(ours) == str(theirs)


# -- the loader knobs --------------------------------------------------

LOADER_KNOBS = {
    "fallback_decode_threads": ([1, 3], [0, -2, True, 2.5, "4"]),
    "staging_slots": ([0, 1, 6], [-1, True, 1.5, "2"]),
    "transfer_async": ([False, True], [1, "yes", None]),
}


@pytest.mark.parametrize("config", (WHOLE, FUSED))
@pytest.mark.parametrize("key", sorted(LOADER_KNOBS))
def test_loader_knobs_parse_as_the_reference(config, key):
    good, bad = LOADER_KNOBS[key]
    for value in good:
        raw = _raw(config)
        raw["pipeline"][0][key] = value
        ours, theirs = _both(raw)
        assert ours.steps[0].kwargs[key] == value
        assert theirs.steps[0].extras[key] == value
    for value in bad:
        raw = _raw(config)
        raw["pipeline"][0][key] = value
        if value is None:
            # an explicit null reads as the default on both sides
            assert _both(raw)[0].steps[0].kwargs[key] is None
            continue
        _refused_alike(raw)


def test_fallback_pool_width_is_the_knob_or_the_native_rule(monkeypatch):
    monkeypatch.setenv("RNB_DECODE_THREADS", "5")
    assert default_decode_threads() == jax_default_decode_threads() == 5
    plain = R2P1DLoader(CPU, max_clips=3, row_buckets=[1, 3],
                        num_warmups=0, prefetch=2)
    fused = R2P1DFusingLoader(CPU, fuse=2, max_clips=3, row_buckets=[1, 3],
                              num_warmups=0)
    assert plain.fallback_decode_threads == fused.fallback_decode_threads \
        == 5
    for make in (lambda: R2P1DLoader(CPU, max_clips=3, row_buckets=[1, 3],
                                     num_warmups=0, prefetch=2,
                                     fallback_decode_threads=3),
                 lambda: R2P1DFusingLoader(CPU, fuse=2, max_clips=3,
                                           row_buckets=[1, 3],
                                           num_warmups=0,
                                           fallback_decode_threads=3)):
        loader = make()
        assert loader.fallback_decode_threads == 3
        # a synthetic id decodes off the native pool: on the knob's pool
        video, card = "synth://kinetics/video-0001", TimeCard(0)
        if isinstance(loader, R2P1DFusingLoader):
            # emitted by the call when the decode was already done, else
            # by the flush
            emission = loader(None, video, card)
            if emission[2] is None:
                emission = loader.flush()
            assert emission[2] is not None
        else:
            loader.complete(loader.submit(video, card), video, card)
        assert loader._decode_pool._max_workers == 3
        loader.discard_pending()
    for bad in (0, -1):
        with pytest.raises(ValueError, match="fallback_decode_threads must "
                           "be >= 1"):
            R2P1DLoader(CPU, fallback_decode_threads=bad)


@pytest.mark.parametrize("prefetch,slots,want", [
    (2, None, 4), (2, 0, None), (2, 1, 4), (2, 6, 6), (0, 6, None),
    (0, None, None)])
def test_plain_loader_staging_slots_follow_the_reference(prefetch, slots,
                                                         want):
    loader = R2P1DLoader(CPU, max_clips=3, row_buckets=[1, 3],
                         num_warmups=0, prefetch=prefetch,
                         staging_slots=slots)
    got = None if loader.staging is None else loader.staging.available()
    assert got == want
    with pytest.raises(ValueError, match="staging_slots must be >= 0"):
        R2P1DLoader(CPU, staging_slots=-1)


def test_transfer_async_and_prefetch_refused_with_the_references_words():
    device = jax.devices("cpu")[0]
    with pytest.raises(ValueError) as theirs:
        jax_model.R2P1DLoader(device, num_warmups=0, transfer_async=True)
    with pytest.raises(ValueError) as ours:
        R2P1DLoader(CPU, num_warmups=0, transfer_async=True)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError) as theirs:
        jax_model.R2P1DFusingLoader(device, prefetch=2)
    with pytest.raises(ValueError) as ours:
        R2P1DFusingLoader(CPU, prefetch=2)
    assert str(ours.value) == str(theirs.value)
    # prefetch 0 is no prefetch: read on both
    R2P1DFusingLoader(CPU, fuse=2, max_clips=3, row_buckets=[1, 3],
                      num_warmups=0, prefetch=0)


# -- async_dispatch ----------------------------------------------------

@pytest.mark.parametrize("value,read", [(True, True), (False, True),
                                        ("yes", False), (1, False)])
def test_async_dispatch_parses_as_the_reference(value, read):
    raw = _raw(WHOLE)
    raw["pipeline"][1]["async_dispatch"] = value
    if read:
        ours, theirs = _both(raw)
        assert ours.steps[1].async_dispatch is theirs.steps[1].async_dispatch \
            is value
        assert ours.steps[0].async_dispatch is False
        assert "async_dispatch" not in ours.steps[1].kwargs
    else:
        _refused_alike(raw)


def test_async_dispatch_on_a_feeding_replica_step_is_refused():
    """Lanes serve on CUDA streams of their own: an async lane step that
    feeds another step is refused (the reference reads it); the step
    before the lanes and a final lane step read as the reference's."""
    raw = _raw("configs/rnb-scaleout-r4.json")
    raw["pipeline"][0]["async_dispatch"] = True
    raw["pipeline"][1]["async_dispatch"] = True
    ours, theirs = _both(raw)
    assert ours.steps[1].replica_queues is not None
    assert [s.async_dispatch for s in ours.steps] \
        == [s.async_dispatch for s in theirs.steps] == [True, True]
    three = copy.deepcopy(raw)
    tail = copy.deepcopy(three["pipeline"][1])
    three["pipeline"][1]["queue_groups"] = [
        dict(g, out_queues=[0]) for g in tail["queue_groups"]]
    tail.pop("async_dispatch")
    tail["queue_groups"] = [{"devices": [0], "in_queue": 0}]
    three["pipeline"].append(tail)
    ours, theirs = _both(three)
    assert theirs.steps[1].async_dispatch is True
    assert isinstance(ours, ConfigError)
    assert str(ours).startswith(
        "pipeline step 1: 'async_dispatch' on a replica step that feeds "
        "another step is refused")
    three["pipeline"][1].pop("async_dispatch")
    ours, _ = _both(three)
    assert [s.async_dispatch for s in ours.steps] == [True, False, False]


def _reduced_whole(tmp_path, **root):
    raw = _raw(WHOLE)
    loader, net = raw["pipeline"]
    loader.update(max_clips=3, consecutive_frames=2,
                  num_clips_population=[1, 3], weights=[2, 1],
                  row_buckets=[1, 3])
    net.update(layer_sizes=[1, 1, 1, 1], num_classes=8, max_rows=3,
               consecutive_frames=2, row_buckets=[1, 3])
    raw.update(root)
    path = str(tmp_path / "whole.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path, raw


def _serve(path, tmp_path, requests=6):
    sink = {}
    result = port_benchmark.run_benchmark(
        path, mean_interval_ms=0, num_videos=requests,
        log_base=str(tmp_path / "logs"), print_progress=False, seed=0,
        platform="cpu", outputs_sink=sink)
    assert result.termination_flag == 0
    assert result.num_completed == requests
    return result, sink


def test_async_dispatch_skips_the_wait_of_its_step_only(tmp_path,
                                                        monkeypatch):
    monkeypatch.delenv("RNB_TPU_DATA_ROOT", raising=False)
    waited = []
    real_sync = runner._sync

    def counting_sync(payload):
        waited.append(payload)
        real_sync(payload)

    monkeypatch.setattr(runner, "_sync", counting_sync)
    path, raw = _reduced_whole(tmp_path)
    synced, sink = _serve(path, tmp_path)
    both = len(waited)
    # the loader step and the runner step each waited once a dispatch
    assert both == 2 * 6
    raw["pipeline"][1]["async_dispatch"] = True
    with open(path, "w") as f:
        json.dump(raw, f)
    del waited[:]
    result, async_sink = _serve(path, tmp_path)
    assert len(waited) == 6  # the loader's only
    # the same logits: only the stamp moved
    for rid in sink:
        np.testing.assert_array_equal(sink[rid][1], async_sink[rid][1])


# -- gpus --------------------------------------------------------------

def _devices_of(config):
    """Either package's parsed config -> each group's device indices."""
    return [[[d.spec for d in g.devices] for g in step.groups]
            for step in config.steps]


@pytest.mark.parametrize("config", (WHOLE, "configs/rnb-1chip.json",
                                    "configs/rnb-scaleout-r4.json",
                                    "configs/rnb-shard-d2.json"))
def test_gpus_is_the_references_alias_of_devices(config):
    raw = _raw(config)
    want = _devices_of(parse_config(copy.deepcopy(raw), platform="cpu"))
    aliased = copy.deepcopy(raw)
    for step in aliased["pipeline"]:
        for group in step["queue_groups"]:
            group["gpus"] = group.pop("devices")
    ours, theirs = _both(aliased)
    assert _devices_of(ours) == _devices_of(theirs) == want
    # both keys: devices wins, the alias is dropped
    both = copy.deepcopy(raw)
    for step in both["pipeline"]:
        for group in step["queue_groups"]:
            group["gpus"] = [7 for _ in group["devices"]]
    ours, theirs = _both(both)
    assert _devices_of(ours) == _devices_of(theirs) == want
    for step in ours.steps:
        for group in step.groups:
            assert "gpus" not in group.kwargs


def test_a_group_with_neither_list_is_refused():
    raw = _raw(WHOLE)
    del raw["pipeline"][1]["queue_groups"][0]["devices"]
    with pytest.raises(ConfigError, match="needs devices"):
        parse_config(raw, platform="cpu")


# -- lint --------------------------------------------------------------

@pytest.mark.parametrize("lint,read", [
    ({"lock_witness": True}, True), ({"lock_witness": False}, True),
    ({}, True), ([], False), ({"lock_witness": "yes"}, False),
    ({"lock_witness": True, "races": True}, False)])
def test_lint_parses_as_the_reference(lint, read):
    raw = _raw(WHOLE)
    raw["lint"] = lint
    if read:
        ours, theirs = _both(raw)
        assert ours.lint == theirs.lint == lint
    else:
        _refused_alike(raw)


def _reference_meta(log_dir, copy_dir):
    """The reference's ``parse_meta`` of a port job, on a copy without
    the port's ``Device:`` line (its one-word CPU value reads as a
    timestamp there)."""
    os.makedirs(copy_dir)
    with open(os.path.join(log_dir, "log-meta.txt")) as f:
        kept = [line for line in f if not line.startswith("Device:")]
    with open(os.path.join(copy_dir, "log-meta.txt"), "w") as f:
        f.writelines(kept)
    return ref_parse_utils.parse_meta(str(copy_dir))


def test_a_witness_armed_run_writes_the_references_lock_lines(tmp_path,
                                                              monkeypatch):
    monkeypatch.delenv("RNB_TPU_DATA_ROOT", raising=False)
    assert not lockwitness.enabled()
    # a deadline and a lane-free health board: witnessed locks the run
    # takes
    path, _ = _reduced_whole(tmp_path, lint={"lock_witness": True},
                             deadline={"budget_ms": 600000})
    result, _ = _serve(path, tmp_path)
    # the run's witness ends with it
    assert not lockwitness.enabled()
    with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
        lines = [line for line in f.read().splitlines()
                 if line.startswith(("Locks:", "Lock edges:"))]
    assert [line.split(":")[0] for line in lines] == ["Locks", "Lock edges"]
    assert result.locks_tracked >= 1 and result.locks_acquires >= 1
    assert result.locks_violations == 0
    assert lines[0] == ("Locks: tracked=%d acquires=%d edges=%d "
                        "violations=0" % (result.locks_tracked,
                                          result.locks_acquires,
                                          result.locks_edges))
    meta = _reference_meta(result.log_dir, tmp_path / "ref")
    assert meta["locks_tracked"] == result.locks_tracked
    assert meta["locks_acquires"] == result.locks_acquires
    assert ref_parse_utils._check_locks(meta) == []
    ours = read_meta(os.path.join(result.log_dir, "log-meta.txt"))
    assert lock_problems(ours) == []
    # and a tampered ledger fails both readers
    with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
        text = f.read()
    with open(os.path.join(result.log_dir, "log-meta.txt"), "w") as f:
        f.write(text.replace(" violations=0", " violations=2"))
    assert ref_parse_utils._check_locks(
        _reference_meta(result.log_dir, tmp_path / "tampered"))
    assert lock_problems(read_meta(os.path.join(result.log_dir,
                                                "log-meta.txt")))


def test_an_unarmed_run_writes_no_lock_lines(tmp_path, monkeypatch):
    monkeypatch.delenv("RNB_TPU_DATA_ROOT", raising=False)
    path, _ = _reduced_whole(tmp_path, lint={"lock_witness": False})
    result, _ = _serve(path, tmp_path, requests=2)
    with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
        assert "Locks:" not in f.read()
    assert result.locks_tracked == 0


# -- the busy-card probe -----------------------------------------------

def _smi_reading(monkeypatch, gpus, apps):
    """``nvidia-smi -q -x`` answering with ``gpus`` rows (index, uuid,
    MiB) and ``apps`` rows (uuid, pid, MiB), each app a compute one and
    a graphics process beside them on every card."""
    def card(uuid, used):
        procs = "".join(
            "<process_info><pid>%d</pid><type>C</type><process_name>p"
            "</process_name><used_memory>%s MiB</used_memory>"
            "</process_info>" % (pid, mib)
            for app_uuid, pid, mib in apps if app_uuid == uuid)
        return ("<gpu id='x'><uuid>%s</uuid><fb_memory_usage><total>81559 "
                "MiB</total><used>%s MiB</used></fb_memory_usage>"
                "<processes>%s<process_info><pid>7</pid><type>G</type>"
                "<used_memory>900 MiB</used_memory></process_info>"
                "</processes></gpu>" % (uuid, used, procs))
    xml = "<nvidia_smi_log><attached_gpus>1</attached_gpus>%s" \
        "</nvidia_smi_log>" % "".join(card(uuid, used)
                                      for _i, uuid, used in gpus)
    monkeypatch.setattr(devices, "_smi_xml", lambda: xml)


def test_probe_warns_about_another_processes_memory(monkeypatch):
    card = [(0, "GPU-a", 700.0)]
    spec = [DeviceSpec(0, "cuda")]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    pid = os.getpid()
    _smi_reading(monkeypatch, card, [("GPU-a", pid, 582), ("GPU-a", 41, 100)])
    (warning,) = probe_busy_devices(spec)
    assert warning.startswith("device cuda:0: 1 other process(es) already "
                              "hold 100.0 MiB before this job allocated")
    # this process's own context alone, or another under the threshold
    _smi_reading(monkeypatch, card, [("GPU-a", pid, 582)])
    assert probe_busy_devices(spec) == []
    _smi_reading(monkeypatch, card, [("GPU-a", pid, 582), ("GPU-a", 41, 10)])
    assert probe_busy_devices(spec) == []
    # a pid namespace: every process listed as pid 1 with the card's
    # total; this one's context is one of them
    _smi_reading(monkeypatch, [(0, "GPU-a", 1179.0)],
                 [("GPU-a", 1, 1164), ("GPU-a", 1, 1164)])
    (warning,) = probe_busy_devices(spec)
    assert "1 other process(es) already hold memory (1179.0 MiB in use on " \
        "the card in all)" in warning
    _smi_reading(monkeypatch, [(0, "GPU-a", 582.0)], [("GPU-a", 1, 582)])
    assert probe_busy_devices(spec) == []
    # before this process touched the card, a listed process is another's
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    (warning,) = probe_busy_devices(spec)
    assert "hold 582.0 MiB" in warning
    # a card the config does not name is not probed
    assert probe_busy_devices([DeviceSpec(1, "cuda")]) == []


def test_probe_never_reads_the_host_or_the_cpu_and_survives_no_smi(
        monkeypatch):
    calls = []

    def failing(*args, **kwargs):
        calls.append(args)
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", failing)
    assert probe_busy_devices([DeviceSpec(0, "cpu"), DeviceSpec(-1)]) == []
    assert calls == []
    assert probe_busy_devices([DeviceSpec(0, "cuda")]) == []
    assert len(calls) == 1


def test_a_run_on_a_busy_card_warns_and_serves(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.delenv("RNB_TPU_DATA_ROOT", raising=False)
    seen = []

    def busy(specs):
        seen.append([s.spec for s in specs])
        return ["device cuda:0: 1 other process(es) already hold 100.0 MiB"]

    monkeypatch.setattr(port_benchmark, "probe_busy_devices", busy)
    path, _ = _reduced_whole(tmp_path)
    result, _ = _serve(path, tmp_path, requests=2)
    assert seen == [[0, 0]]  # every group's device, probed once a run
    assert "[rnb-tpu-torch] WARNING: device cuda:0: 1 other process(es)" \
        in capsys.readouterr().err
    assert result.num_completed == 2
