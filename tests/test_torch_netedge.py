"""The network ingest edge (``rnb_tpu_torch/netedge.py``) against the JAX
package's (``rnb_tpu/netedge.py``), on the CPU.

Unit parity: the seeded reconnect schedule, the address parser, the
settings' and the config reader's refusals (the reference's messages for
bad ``netedge`` and ``health`` keys), and the reference's client cases
(``tests/test_netedge.py``: the resend dedup, the ack ledger, the
receive-boundary deadline shed, beat staleness walking the board to open,
the corrupt-frame dead letter) run against the port's client, plus a
corrupt DATA frame off a real socket dead-lettered ``net_corrupt``.

Fatal stays fatal: a peer that cannot reach the card, or whose stage
fails to build, raises before it binds and the run never starts; a peer
that dies of an unclassified error aborts the run instead of evicting
the lane; the peer contains a request's classified errors as the
executor does.

End to end, two processes on the CPU: a reduced copy of
``configs/rnb-netedge-loopback.json`` (the chaos config's geometry on the
dct wire: 2-frame clips, up to 3 a request, layers (1, 1, 1, 1), 8
classes, no faults) served through the spawned peer. Every request goes
remote; the rows each DATA frame carried are bitwise the JAX package's
synthetic coefficients for the video and its clip starts; the ingest is
within two u8 steps of the JAX package's with 99% exact; the logits are
within the dct path's bound of the JAX stages on the same parameters;
the ``Net:``/``Health:`` lines foot. ``netedge.enabled: false`` leaves
the logs byte-identical to the config without the key (numbers masked).
A one-card copy of ``configs/rnb-netedge-chaos.json`` at interval 0 runs
the chaos plan's first act (the reset and the reconnect), as the
reference's sweep row does: the acts after it need paced arrivals, and
are held on the card by ``chip_smoke.py``. Last, ``parse_utils`` and the
reference's ``_check_netedge`` both catch a cooked ``Net:`` line.
"""

import json
import os
import queue
import re
import socket
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnb_tpu import config as jax_config
from rnb_tpu import netedge as jax_netedge
from rnb_tpu.decode import SyntheticDecoder as JaxSyntheticDecoder
from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.models.r2p1d.model import _shared_apply
from rnb_tpu.models.r2p1d.sampler import R2P1DSampler as JaxSampler
from rnb_tpu.ops import dct as jax_dct
from rnb_tpu_torch import netedge
from rnb_tpu_torch.benchmark import run_benchmark
from rnb_tpu_torch.config import ConfigError, parse_config
from rnb_tpu_torch.control import (FaultStats, InferenceCounter,
                                   TerminationFlag, TerminationState)
from rnb_tpu_torch.faults import (CorruptVideoError, InjectedTransientError,
                                  fault_reason)
from rnb_tpu_torch.health import (DeadlineStats, DirectPayload,
                                  HealthSettings, LaneHealthBoard,
                                  deadline_site)
from rnb_tpu_torch.models.r2p1d import model as port_model
from rnb_tpu_torch.models.r2p1d.checkpoint import (filter_layer_range,
                                                   from_jax_variables)
from rnb_tpu_torch.models.r2p1d.network import (R2Plus1DClassifier,
                                                cast_compute_weights)
from rnb_tpu_torch.netedge import (NET_LANE, NetEdgeClient, NetEdgePeer,
                                   NetEdgeSettings, NetStats)
from rnb_tpu_torch.ops import dct, wire
from rnb_tpu_torch.parse_utils import (health_problems, netedge_problems,
                                       read_meta, summarize)
from rnb_tpu_torch.stage import PaddedBatch
from rnb_tpu_torch.telemetry import TimeCard
from torch_job_checks import assert_both_checks_pass

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LS = (1, 1, 1, 1)
CLASSES = 8
FRAMES = 2
MAX_CLIPS = 3
REQUESTS = 12
#: the dct wire's packed frame at the default budget (112 x 112)
FRAME_BYTES = 9408
#: the ingest against the JAX package's: two float32 IDCTs summed in
#: different orders flip floor(p + 128.5) by one step on a quantized
#: plane, which BT.601 carries into R or B as up to two
RGB_STEPS = 2
EXACT_SHARE = 0.99


# -- units --------------------------------------------------------------------

@pytest.mark.parametrize("backoff,retries,seed", [
    (50, 6, 17), (50, 6, 18), (20, 3, 5), (1, 1, 0), (700, 5, 11)])
def test_the_backoff_schedule_is_the_reference_s(backoff, retries, seed):
    ours = netedge.backoff_schedule_ms(backoff, retries, seed)
    assert ours == jax_netedge.backoff_schedule_ms(backoff, retries, seed)
    assert len(ours) == retries
    for i, delay in enumerate(ours):
        base = min(backoff * 2.0 ** i, netedge.BACKOFF_CAP_MS)
        assert base <= delay <= base * (1 + netedge.JITTER_FRAC)


@pytest.mark.parametrize("addr", ["127.0.0.1:80", "localhost:0", "no-port",
                                  ":80", "h:p"])
def test_parse_addr_is_the_reference_s(addr):
    try:
        want = jax_netedge.parse_addr(addr)
    except ValueError:
        with pytest.raises(ValueError):
            netedge.parse_addr(addr)
        return
    assert netedge.parse_addr(addr) == want


def _reduced_raw(**root):
    """The loopback config cut to the CPU: the chaos config's geometry on
    the dct wire, one device, no faults."""
    with open(os.path.join(REPO, "configs/rnb-netedge-loopback.json")) as f:
        raw = json.load(f)
    loader, runner = raw["pipeline"]
    for step in (loader, runner):
        step.pop("row_buckets")
        step["consecutive_frames"] = FRAMES
        step["num_warmups"] = 1
    loader.update(num_shared_tensors=30, max_clips=MAX_CLIPS,
                  num_clips_population=[1, 2, 3], weights=[2, 1, 1])
    runner.update(max_rows=MAX_CLIPS, layer_sizes=list(LS),
                  num_classes=CLASSES)
    raw.update(root)
    return raw


BAD_KEYS = [
    {"netedge": []},
    {"netedge": {"enabled": True, "spawn": True, "host": "x"}},
    {"netedge": {"enabled": "yes", "spawn": True}},
    {"netedge": {"spawn": 1}},
    {"netedge": {"spawn": True, "connect": 8080}},
    {"netedge": {"spawn": True, "beat_ms": -1}},
    {"netedge": {"spawn": True, "resend_window": 0}},
    {"netedge": {"spawn": True, "max_retries": 2.5}},
    {"netedge": {"enabled": True}},
    {"netedge": {"spawn": True, "beat_ms": 500, "io_timeout_ms": 400}},
    {"netedge": {"connect": "nohostport"}},
    {"netedge": {"spawn": True}, "ragged": {"enabled": True}},
    {"netedge": {"spawn": True}, "trace": {"enabled": True}},
    {"health": []},
    {"health": {"probe_ms": 3}},
    {"health": {"enabled": 1}},
    {"health": {"suspect_after_ms": 0}},
    {"health": {"suspect_after_ms": 900, "open_after_ms": 300}},
]


@pytest.mark.parametrize("root", BAD_KEYS, ids=[
    "-".join("%s=%s" % kv for kv in sorted(r.items()))[:60]
    for r in BAD_KEYS])
def test_bad_netedge_and_health_keys_are_refused_as_the_reference_does(root):
    raw = _reduced_raw()
    raw.pop("netedge")
    raw.update(root)
    with pytest.raises(jax_config.ConfigError) as theirs:
        jax_config.parse_config(json.loads(json.dumps(raw)))
    with pytest.raises(ConfigError) as ours:
        parse_config(raw, platform="cpu")
    assert str(ours.value) == str(theirs.value)


def test_a_segmented_step_0_and_a_single_step_are_refused():
    raw = _reduced_raw()
    raw["pipeline"][0]["num_segments"] = 2
    with pytest.raises(ConfigError, match="segmented step 0"):
        parse_config(raw, platform="cpu")
    raw = _reduced_raw()
    raw["pipeline"] = raw["pipeline"][:1]
    raw["pipeline"][0]["queue_groups"][0].pop("out_queues")
    with pytest.raises(ConfigError, match="at least 2 pipeline steps"):
        parse_config(raw, platform="cpu")


@pytest.mark.parametrize("raw", [None, {"enabled": False, "spawn": True},
                                 {"spawn": True},
                                 {"connect": "h:1", "beat_ms": 50,
                                  "io_timeout_ms": 60, "max_retries": 2,
                                  "backoff_ms": 0, "resend_window": 1,
                                  "listen": "0.0.0.0:9"}])
def test_settings_default_as_the_reference_s(raw):
    ours = NetEdgeSettings.from_config(raw)
    theirs = jax_netedge.NetEdgeSettings.from_config(raw)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert {k: getattr(ours, k) for k in ours.__slots__} == \
            {k: getattr(theirs, k) for k in theirs.__slots__}


def _client(num_videos=4, health=None, deadline_stats=None, peer_proc=None,
            rows_sink=None):
    settings = NetEdgeSettings(connect="127.0.0.1:1", beat_ms=20,
                               io_timeout_ms=100, max_retries=1,
                               backoff_ms=1, resend_window=4)
    board = LaneHealthBoard((NET_LANE,), health or HealthSettings())
    return NetEdgeClient(
        settings, board=board, stats=NetStats(), fault_plan=None,
        fault_stats=FaultStats(), deadline_stats=deadline_stats,
        counter=InferenceCounter(), num_videos=num_videos,
        termination=TerminationState(), filename_queue=queue.Queue(),
        local_queue=queue.Queue(), inject_queue=queue.Queue(),
        num_markers=1, seed=11, peer_proc=peer_proc, rows_sink=rows_sink)


def _window_entry(client, seq, rid, deadline_s=None):
    card = TimeCard(rid)
    if deadline_s is not None:
        card.deadline_s = deadline_s
    frame = wire.encode_frame(wire.REQ, wire.encode_req("video-%d" % rid,
                                                        card), seq=seq)
    client._window[seq] = netedge._WindowEntry(seq, "video-%d" % rid, card,
                                               frame)
    client.board.note_enqueue(NET_LANE)
    return card


def _data_payload(rid, deadline_s=None):
    data = torch.zeros(2, 2, dtype=torch.int16)
    data[0] = rid
    card = TimeCard(rid)
    if deadline_s is not None:
        card.deadline_s = deadline_s
    return wire.encode_data(PaddedBatch(data, 1), rid, card)


def test_a_resend_s_twin_is_dropped_and_dispatched_once():
    client = _client(rows_sink={0: None})
    _window_entry(client, seq=1, rid=0)
    payload = _data_payload(0)
    client._on_data(1, payload)           # the first arrival: injected
    client._on_data(1, payload)           # the resend's twin: dropped
    assert client.inject_queue.qsize() == 1
    item = client.inject_queue.get()
    assert isinstance(item[0], DirectPayload) and item[3] is None
    (batch,) = item[0].payload
    assert batch.valid == 1 and batch.data.device.type == "cpu"
    assert torch.equal(client.rows_sink[0], batch.data[:1])
    snap = client.stats.snapshot()
    assert snap["dup_arrivals"] == 1 and snap["dedup_drops"] == 1
    assert client._finalizing == 0
    # the pad count of the shipped emission, once
    assert client.pad_snapshot() == {"pad_rows": 1, "total_rows": 2,
                                     "emissions": 1}
    # the success path disposes nothing: it completes downstream
    assert client.counter.value == 0


def test_acks_count_once_and_data_settles_once():
    client = _client()
    _window_entry(client, seq=5, rid=2)
    client._on_ack(5)
    client._on_ack(5)
    assert client.stats.snapshot()["frames_acked"] == 1
    client._on_data(5, _data_payload(2))
    assert client.inject_queue.qsize() == 1
    assert client.stats.snapshot()["dup_arrivals"] == 0


def test_an_expired_response_is_shed_at_the_netedge_site():
    deadline_stats = DeadlineStats()
    client = _client(deadline_stats=deadline_stats)
    past = time.time() - 10.0
    _window_entry(client, seq=1, rid=0, deadline_s=past)
    client._on_data(1, _data_payload(0, deadline_s=past))
    assert client.inject_queue.qsize() == 0
    site = deadline_site("netedge")
    assert site == "netedge:deadline_expired"
    assert deadline_stats.snapshot()["sites"] == {site: 1}
    assert client.fault_stats.snapshot()["shed_sites"] == {site: 1}
    assert client.counter.value == 1
    future = time.time() + 60.0
    _window_entry(client, seq=2, rid=1, deadline_s=future)
    client._on_data(2, _data_payload(1, deadline_s=future))
    assert client.inject_queue.qsize() == 1


def test_beat_staleness_walks_the_board_to_open():
    client = _client(health=HealthSettings(suspect_after_ms=30,
                                           open_after_ms=80,
                                           probe_interval_ms=60))
    client.board.beat(NET_LANE)
    _window_entry(client, seq=1, rid=0)
    assert client.board.state(NET_LANE) == "healthy"
    deadline = time.monotonic() + 2.0
    for want in ("suspect", "open"):
        while client.board.state(NET_LANE) != want \
                and time.monotonic() < deadline:
            client._tick()
            time.sleep(0.01)
        assert client.board.state(NET_LANE) == want
    assert client.stats.snapshot()["open_before_timeout"] == 0
    client._on_data(1, _data_payload(0))   # a settle while open counts
    assert client.inject_queue.qsize() == 1


def test_a_dead_letter_fails_the_request_exactly_once():
    client = _client()
    card = _window_entry(client, seq=3, rid=1)
    client._dead_letter(3)
    assert (card.status, card.failure_reason) == ("failed", "net_corrupt")
    assert client.fault_stats.snapshot()["failure_reasons"] == {
        "net_corrupt": 1}
    assert client.counter.value == 1
    client._dead_letter(3)                # unknown seq: no second letter
    assert client.counter.value == 1


def test_a_corrupt_data_frame_off_the_wire_is_one_dead_letter():
    """The receiver reads a DATA frame with one flipped byte: the request
    it carried is dead-lettered ``net_corrupt`` once, nothing is
    injected, the connection survives (the next frame reads) and no
    resend is asked for."""
    client = _client()
    card = _window_entry(client, seq=4, rid=3)
    _window_entry(client, seq=5, rid=4)
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    client._sock = b
    client._connected.set()
    rx = threading.Thread(target=client._rx_loop, daemon=True)
    rx.start()
    try:
        frame = bytearray(wire.encode_frame(wire.DATA, _data_payload(3),
                                            seq=4))
        frame[-1] ^= 0x01
        a.sendall(bytes(frame))
        a.sendall(wire.encode_frame(wire.DATA, _data_payload(4), seq=5))
        deadline = time.monotonic() + 5.0
        while client.inject_queue.qsize() < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        client._stop.set()
        a.close()
        rx.join(timeout=5.0)
    assert not rx.is_alive()
    assert (card.status, card.failure_reason) == ("failed", "net_corrupt")
    assert client.fault_stats.snapshot()["failure_reasons"] == {
        "net_corrupt": 1}
    assert client.inject_queue.qsize() == 1   # the next frame's request
    assert client.inject_queue.get()[2].id == 4
    snap = client.stats.snapshot()
    assert snap["err_corrupt"] == 1 and snap["resends"] == 0
    assert client.counter.value == 1


class _DeadPeer:
    """A spawned peer that has exited with ``rc``."""

    def __init__(self, rc):
        self.returncode = rc

    def poll(self):
        return self.returncode

    def wait(self, timeout=None):
        return self.returncode


def test_a_peer_dead_of_an_unclassified_error_aborts_the_run():
    client = _client(peer_proc=_DeadPeer(netedge.PEER_FATAL_RC))
    assert client._ensure_connected() is False
    assert client.termination.value == TerminationFlag.INTERNAL_ERROR
    assert client.board.state(NET_LANE) == "healthy"   # not evicted
    assert client.stats.snapshot()["local"] == 0


def test_a_peer_killed_otherwise_is_a_lost_lane():
    # the fault plan's fatal net_reset: os._exit(1), every dial refused
    client = _client(peer_proc=_DeadPeer(1))
    _window_entry(client, seq=1, rid=0)
    assert client._ensure_connected() is False
    assert not client.termination.terminated
    assert client.board.state(NET_LANE) == "evicted"
    snap = client.stats.snapshot()
    assert snap["err_refused"] == 1 and snap["local"] == 1
    assert client.local_queue.get()[2].id == 0   # the window rerouted


class _Stage:
    def __init__(self, errors):
        self.errors = list(errors)

    def __call__(self, tensors, path, card):
        if self.errors:
            raise self.errors.pop(0)
        return (PaddedBatch(torch.ones(2, 3), 1),), path, card


def _peer(errors, max_retries=1):
    cfg = parse_config(_reduced_raw(), platform="cpu")
    cfg.steps[0].max_retries = max_retries
    cfg.steps[0].retry_backoff_ms = 0.0
    peer = NetEdgePeer(cfg, "127.0.0.1:0")
    peer.model = _Stage(errors)
    return peer


def test_the_peer_contains_a_request_as_the_executor_does():
    served, reason = _peer([InjectedTransientError("x")])._run_model(
        "v", TimeCard(0))
    assert reason is None and served[0].valid == 1
    assert list(served[2].timings) == ["runner0_start", "inference0_start",
                                       "inference0_finish"]
    served, reason = _peer([InjectedTransientError("x")] * 2)._run_model(
        "v", TimeCard(0))
    assert served is None and reason == "injected-transient"
    card = TimeCard(1)
    served, reason = _peer([CorruptVideoError("bad")])._run_model("v", card)
    assert served is None and reason == fault_reason(CorruptVideoError())
    assert card.status == "failed"
    # an OSError is the executor's too: a missing file permanent, a blip
    # transient
    assert _peer([FileNotFoundError("gone")])._run_model(
        "v", TimeCard(3)) == (None, "file-not-found")
    served, reason = _peer([OSError(5, "blip")])._run_model("v",
                                                            TimeCard(4))
    assert reason is None and served[0].valid == 1
    with pytest.raises(RuntimeError, match="kernel library"):
        _peer([RuntimeError("kernel library failed to load")])._run_model(
            "v", TimeCard(2))


def test_the_peer_s_serve_loop_exits_fatal_on_an_unclassified_error(
        tmp_path, monkeypatch):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(_reduced_raw()))

    def boom(self, port_file=None):
        raise RuntimeError("kernel library failed to load")

    monkeypatch.setattr(NetEdgePeer, "build_model", lambda self: None)
    monkeypatch.setattr(NetEdgePeer, "serve_forever", boom)
    assert netedge.main(["--serve", "--config", str(path), "--platform",
                         "cpu"]) == netedge.PEER_FATAL_RC


def test_a_peer_that_cannot_reach_the_card_raises_before_it_binds(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the peer would reach it")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(_reduced_raw()))
    settings = NetEdgeSettings.from_config(_reduced_raw()["netedge"])
    try:
        proc, _addr = netedge.spawn_peer(str(path), settings, "cuda")
    except RuntimeError as e:
        assert "exited rc=1 before binding" in str(e)
    else:
        netedge.stop_peer(proc, wait_s=0.0)
        pytest.fail("a peer bound without the card")


def test_a_peer_whose_stage_fails_to_build_stops_the_run(tmp_path,
                                                         monkeypatch):
    monkeypatch.delenv("RNB_TPU_DATA_ROOT", raising=False)
    raw = _reduced_raw()
    raw["pipeline"][0]["dct_coeffs_per_frame"] = 0
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw))
    with pytest.raises(RuntimeError, match="exited rc=1 before binding"):
        run_benchmark(str(path), mean_interval_ms=0, num_videos=2,
                      log_base=str(tmp_path / "logs"), print_progress=False,
                      platform="cpu")
    # it never got to a job directory
    assert not (tmp_path / "logs").exists()


def test_an_orphaned_peer_exits(tmp_path):
    """A peer whose main process died before it dialed does not wait
    for a connection forever."""
    import subprocess
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(_reduced_raw()))
    pid_file = tmp_path / "pid"
    # the launcher names itself the peer's parent and exits at once
    subprocess.run(
        [sys.executable, "-c",
         "import os, subprocess, sys; p = subprocess.Popen([sys.executable, "
         "'-m', 'rnb_tpu_torch.netedge', '--serve', '--config', %r, "
         "'--platform', 'cpu', '--parent-pid', str(os.getpid())], "
         "stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL); "
         "open(%r, 'w').write(str(p.pid))" % (str(path), str(pid_file))],
        check=True, cwd=REPO, timeout=60)
    pid = int(pid_file.read_text())
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        try:
            with open("/proc/%d/stat" % pid) as f:
                state = f.read().rpartition(")")[2].split()[0]
        except FileNotFoundError:
            break
        if state == "Z":
            break
        time.sleep(0.2)
    else:
        os.kill(pid, 9)
        pytest.fail("the orphaned peer %d kept running" % pid)


@pytest.mark.parametrize("how", ["aborted", "raised"])
def test_no_peer_outlives_the_run(tmp_path, monkeypatch, how):
    """A run that aborts (its runner fails to build) or raises (after the
    peer bound) leaves no peer process running."""
    import rnb_tpu_torch.benchmark as benchmark
    monkeypatch.delenv("RNB_TPU_DATA_ROOT", raising=False)
    spawned = []

    def spawn(*args, **kwargs):
        proc, addr = netedge.spawn_peer(*args, **kwargs)
        spawned.append(proc)
        return proc, addr

    monkeypatch.setattr(benchmark, "spawn_peer", spawn)
    raw = _reduced_raw()
    if how == "aborted":
        raw["pipeline"][1]["pixel_path"] = "dct"
        raw["pipeline"][1]["start_index"] = 2   # the wire needs layer 1
    else:
        def refuse(*args, **kwargs):
            raise RuntimeError("no client")
        monkeypatch.setattr(benchmark, "NetEdgeClient", refuse)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw))
    kwargs = dict(mean_interval_ms=0, num_videos=2,
                  log_base=str(tmp_path / "logs"), print_progress=False,
                  platform="cpu")
    if how == "aborted":
        result = run_benchmark(str(path), **kwargs)
        assert result.termination_flag == TerminationFlag.INTERNAL_ERROR
    else:
        with pytest.raises(RuntimeError, match="no client"):
            run_benchmark(str(path), **kwargs)
    (proc,) = spawned
    assert proc.poll() is not None


# -- two processes end to end ----------------------------------------------------

def _jax_rows(video):
    decoder = JaxSyntheticDecoder()
    starts = JaxSampler(consecutive_frames=FRAMES,
                        num_clips_population=[1, 2, 3],
                        weights=[2, 1, 1]).sample(
        decoder.num_frames(video), video_id=video)[:MAX_CLIPS]
    return np.asarray(decoder.decode_clips_dct(video, starts, FRAMES, 112,
                                               112))


def _u8(x):
    return np.round((np.asarray(x, np.float32) * 255.0 + 255.0) / 2.0)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The reduced loopback copy served through the spawned peer, its
    netedge-off twin and the same config without the key, on the JAX
    package's weights; the one-card chaos copy at interval 0."""
    weights = jax_ckpt.init_variables(seed=0, num_classes=CLASSES,
                                      layer_sizes=LS)
    state = from_jax_variables(weights)

    def shared_network(start, end, num_classes, layer_sizes, device,
                       dtype=torch.bfloat16, factored_shortcut=False):
        net = R2Plus1DClassifier(start, end, num_classes, layer_sizes,
                                 factored_shortcut, dtype=dtype)
        net.load_state_dict(filter_layer_range(state, start, end),
                            strict=True)
        return cast_compute_weights(net).to(device).eval()

    tmp = str(tmp_path_factory.mktemp("netedge"))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_model, "shared_network", shared_network)
        mp.delenv("RNB_TPU_DATA_ROOT", raising=False)
        mp.delenv("RNB_FAULT_PLAN", raising=False)
        off = _reduced_raw()
        off["netedge"]["enabled"] = False
        plain = _reduced_raw()
        del plain["netedge"]
        with open(os.path.join(REPO, "configs/rnb-netedge-chaos.json")) as f:
            chaos = json.load(f)
        for step in chaos["pipeline"]:
            for group in step["queue_groups"]:
                group["devices"] = [0]
        for label, raw, videos in (("loopback", _reduced_raw(), REQUESTS),
                                   ("off", off, REQUESTS),
                                   ("plain", plain, REQUESTS),
                                   ("chaos", chaos, 8)):
            path = os.path.join(tmp, label + ".json")
            with open(path, "w") as f:
                json.dump(raw, f)
            sink = {}
            rows = {rid: None for rid in range(videos)}
            result = run_benchmark(
                path, mean_interval_ms=0, num_videos=videos,
                log_base=os.path.join(tmp, "logs", label),
                print_progress=False, seed=17, platform="cpu",
                outputs_sink=sink, net_rows_sink=rows)
            runs[label] = (result, sink, rows)
    return weights, runs


def test_every_request_went_remote_and_the_ledger_foots(served):
    _, runs = served
    result, sink, _ = runs["loopback"]
    assert result.termination_flag == 0
    assert result.num_completed == len(sink) == REQUESTS
    assert result.net_remote == REQUESTS and result.net_local == 0
    assert result.net_frames_sent == result.net_frames_acked == REQUESTS
    assert result.net_err_total == 0 and result.net_reconnects == 0
    assert result.net_resends == 0 and result.net_window_stranded == 0
    # only the valid rows crossed: whole packed frames
    clips = sum(len(logits) for _, logits, _ in sink.values())
    assert result.net_frame_bytes == clips * FRAMES * FRAME_BYTES
    assert result.net_frame_bytes % FRAME_BYTES == 0
    assert result.health_lanes == 1 and result.health_transitions == 0
    assert result.health_lane_detail == {"0": {
        "state": "healthy", "path": ["healthy"], "redispatched_from": 0,
        "routes_after_open": 0}}
    # the receiver's pad count: every emission shipped its one bucket
    assert (result.pad_rows, result.total_rows) == (
        MAX_CLIPS * REQUESTS - clips, MAX_CLIPS * REQUESTS)
    stats = summarize(result.log_dir)
    assert stats["footing_problems"] == []
    assert stats["net"]["remote"] == REQUESTS
    assert stats["compile_signatures"]["step1"]["steady_new"] == 0


def test_the_rows_each_data_frame_carried_are_the_reference_s(served):
    _, runs = served
    result, sink, rows = runs["loopback"]
    assert set(rows) == set(range(REQUESTS))
    for rid, (video, _logits, _stamps) in sorted(sink.items()):
        got = rows[rid]
        assert got is not None and got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), _jax_rows(video))


def test_the_ingest_and_the_logits_are_held_to_the_jax_stages(served):
    weights, runs = served
    result, sink, rows = runs["loopback"]
    apply = _shared_apply(1, 5, CLASSES, LS, pixel_path="dct")
    for rid, (video, logits, _stamps) in sorted(sink.items()):
        wire_rows = rows[rid].numpy()
        n = len(wire_rows)
        pool = np.zeros((MAX_CLIPS,) + wire_rows.shape[1:], np.int16)
        pool[:n] = wire_rows
        ours = dct.normalize_dct(torch.from_numpy(pool), 112, 112,
                                 torch.float32).numpy()
        theirs = np.asarray(jax_dct.normalize_dct(
            jnp.asarray(pool), 112, 112, dtype=jnp.float32))
        assert np.abs(_u8(ours) - _u8(theirs)).max() <= RGB_STEPS
        assert (ours == theirs).mean() >= EXACT_SHARE
        want = np.asarray(apply(weights, pool))[:n]
        # bf16 on both sides, the accumulation order differs inside the
        # convs: 2% of the logit scale, and the argmax where the top-2
        # margin exceeds twice that (tests/test_torch_slice.py)
        bound = 0.02 * float(np.abs(want).max())
        assert logits.shape == want.shape
        assert np.abs(logits - want).max() <= bound
        for g, w in zip(logits, want):
            top2 = np.sort(w)[-2:]
            if top2[1] - top2[0] > 2 * bound:
                assert g.argmax() == w.argmax()


def _masked_meta(result):
    with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
        text = f.read()
    text = re.sub(r'"config": "[^"]*"', '"config": "C"', text)
    return re.sub(r"\d+(\.\d+)?", "N", text)


def test_netedge_off_keeps_the_logs_byte_stable(served):
    _, runs = served
    off, off_sink, off_rows = runs["off"]
    plain = runs["plain"][0]
    assert off.termination_flag == plain.termination_flag == 0
    assert _masked_meta(off) == _masked_meta(plain)
    assert "Net:" not in _masked_meta(off)
    assert "Health:" not in _masked_meta(off)
    assert off.net_frames_sent == 0 and off.health_lanes == 0
    assert set(off_rows.values()) == {None}   # no frame was read
    assert sorted(os.listdir(off.log_dir)) == sorted(
        os.listdir(plain.log_dir))
    tables = [n for n in os.listdir(off.log_dir) if "group" in n]
    with open(os.path.join(off.log_dir, tables[0])) as f:
        header = f.readline().split()
    assert header == ["enqueue_filename", "runner0_start",
                      "inference0_start", "inference0_finish",
                      "runner1_start", "inference1_start",
                      "inference1_finish", "device0", "device1"]
    # the in-process path serves the same logits as the wire
    loopback_sink = runs["loopback"][1]
    for rid, (video, logits, _stamps) in off_sink.items():
        assert loopback_sink[rid][0] == video
        np.testing.assert_array_equal(loopback_sink[rid][1], logits)


def test_the_chaos_copy_survives_its_first_act(served):
    """The plan's reset on request 2: the peer RSTs before acking, the
    sender redials on its schedule and resends, and every request still
    terminates once. At interval 0 requests 8 and 24 do not exist."""
    _, runs = served
    result, sink, _ = runs["chaos"]
    assert result.termination_flag == 0
    assert result.num_completed + result.num_failed + result.num_shed == 8
    assert result.num_completed == len(sink) == 8
    assert result.net_err_reset >= 1 and result.net_reconnects >= 1
    assert result.net_resends >= 1
    assert result.net_window_stranded == 0
    assert result.net_dedup_drops == result.net_dup_arrivals
    assert result.net_frames_sent == (result.net_frames_acked
                                      + result.net_resent_pending)
    assert result.health_evictions == 0
    assert result.health_routes_after_open == 0
    assert summarize(result.log_dir)["footing_problems"] == []


def _reference_check_netedge():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import parse_utils
    finally:
        sys.path.pop(0)
    return parse_utils._check_netedge


def _reference_net_meta(meta):
    out = {"termination_flag": meta["termination_flag"]}
    for head, prefix in (("Net", "net_"), ("Net errors", "net_err_")):
        for key, value in meta["lines"].get(head, {}).items():
            out[prefix + key] = int(value)
    return out


COOKS = {
    "acked": ("frames_acked=12", "frames_acked=11", "does not foot"),
    "class": ("reset=0", "reset=1", "escaped classification"),
    "dedup": ("dedup_drops=0", "dedup_drops=1", "exactly-once"),
    "stranded": ("window_stranded=0", "window_stranded=2", "stranded"),
    "remote": ("remote=12", "remote=13", "never produced a REQ"),
}


@pytest.mark.parametrize("cook", sorted(COOKS))
def test_both_checks_catch_a_cooked_net_line(served, tmp_path, cook):
    _, runs = served
    log = runs["loopback"][0].log_dir
    meta = read_meta(os.path.join(log, "log-meta.txt"))
    assert netedge_problems(meta) == []
    assert _reference_check_netedge()(_reference_net_meta(meta)) == []
    old, new, want = COOKS[cook]
    with open(os.path.join(log, "log-meta.txt")) as f:
        text = f.read()
    lines = [line if not line.startswith("Net") else
             re.sub(r"\b%s\b" % re.escape(old), new, line)
             for line in text.splitlines()]
    assert lines != text.splitlines()
    path = tmp_path / "log-meta.txt"
    path.write_text("\n".join(lines) + "\n")
    cooked = read_meta(str(path))
    ours = netedge_problems(cooked)
    theirs = _reference_check_netedge()(_reference_net_meta(cooked))
    assert any(want in p for p in ours), ours
    assert any(want in p for p in theirs), theirs


def test_the_health_check_catches_a_cooked_lane_path(served, tmp_path):
    _, runs = served
    meta = read_meta(os.path.join(runs["chaos"][0].log_dir, "log-meta.txt"))
    assert health_problems(meta) == []
    meta["health_lane_detail"]["0"]["path"] = ["healthy", "half_open"]
    assert any("not a legal walk" in p for p in health_problems(meta))
    meta["health_lane_detail"]["0"]["path"] = ["healthy"]
    meta["lines"]["Health"]["routes_after_open"] = 1
    assert any("containment violated" in p for p in health_problems(meta))


@pytest.mark.parametrize("label", ["loopback", "off", "plain", "chaos"])
def test_both_check_jobs_pass_the_netedge_job_dirs(served, label):
    assert_both_checks_pass(served[1][label][0].log_dir)
