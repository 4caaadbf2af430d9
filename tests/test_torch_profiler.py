"""The port's profiler bridge (``rnb_tpu_torch.profiler``) and the runs that
use it, on the CPU.

The bridge keeps the reference's contract: one session per process (a
second ``initialize`` raises the reference's ``RuntimeError``), ``report``
drains, prefers device planes and falls back to everything, and with
``include_plane`` appends the plane. On the CPU a session records every
thread's operators on ``/host:CPU``. In a served run the ``--profile``
window goes through the same guard, so a forced devobs capture inside it
is skipped and counted; ``--xprof`` writes ``xprof-ops.txt`` in the
reference's 4-column format, which the reference's own
``scripts/device_busy.py`` reads, as it reads a devobs job directory.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from rnb_tpu import profiler as jax_profiler
from rnb_tpu_torch import devobs, memledger, metrics, profiler, trace
from rnb_tpu_torch.decode import write_y4m

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_session():
    yield
    profiler.flush()
    profiler.report()
    for module in (devobs, memledger, metrics, trace):
        module.ACTIVE = None


def _matmuls(n=3):
    x = torch.randn(32, 32)
    for _ in range(n):
        x @ x


def test_a_second_session_is_refused_with_the_reference_message():
    profiler.initialize()
    with pytest.raises(RuntimeError) as ours:
        profiler.initialize()
    # the reference's guard, without starting a jax trace
    jax_profiler._capturing = True
    try:
        with pytest.raises(RuntimeError) as theirs:
            jax_profiler.initialize()
    finally:
        jax_profiler._capturing = False
    assert str(ours.value) == str(theirs.value) \
        == "profiler already initialized"


def test_report_drains_and_is_empty_while_capturing():
    profiler.initialize()
    _matmuls()
    assert profiler.report() == []  # still capturing
    profiler.flush()
    profiler.flush()  # a second flush is a no-op, as the reference's
    events = profiler.report()
    assert events and profiler.report() == []
    for name, t0, t1 in events:
        assert isinstance(name, str) and t1 >= t0 >= 0
    assert [e[1] for e in events] == sorted(e[1] for e in events)


def test_planes_filter_and_fall_back_to_everything():
    profiler.initialize()
    _matmuls()
    profiler.flush()
    events = profiler.report(include_plane=True)
    assert {plane for *_, plane in events} == {profiler.HOST_PLANE}
    assert "aten::mm" in {name for name, *_ in events}
    profiler.initialize()
    _matmuls()
    profiler.flush()
    assert profiler.report(plane_filter=profiler.DEVICE_PLANE_MARKER) == []


def test_a_session_sees_every_thread():
    """A devobs capture runs on its worker thread while the stages run
    on theirs."""
    stop = threading.Event()

    def work():
        while not stop.is_set():
            _matmuls(1)
            time.sleep(0.001)
    worker = threading.Thread(target=work)
    worker.start()
    try:
        profiler.initialize()
        time.sleep(0.1)
        profiler.flush()
    finally:
        stop.set()
        worker.join(timeout=10)
    assert not worker.is_alive()
    assert "aten::mm" in {name for name, *_ in profiler.report()}


def test_discard_drops_only_the_session_it_names():
    first = profiler.initialize()
    profiler.flush()
    profiler.discard(object())
    assert profiler._session is first
    profiler.discard(first)
    assert profiler.report() == []


def test_warm_up_leaves_nothing_and_defers_to_a_running_session():
    profiler.warm_up()
    assert profiler._session is None and not profiler._capturing
    running = profiler.initialize()
    profiler.warm_up()
    assert profiler._session is running and profiler._capturing


# -- served runs ----------------------------------------------------------

def _dataset(root, videos=4, frames=24):
    rng = np.random.default_rng(1)
    for i in range(videos):
        label = os.path.join(root, "label%d" % (i % 2))
        os.makedirs(label, exist_ok=True)
        write_y4m(os.path.join(label, "v%02d.y4m" % i),
                  rng.integers(0, 256, (frames, 112, 112, 3),
                               dtype=np.uint8), colorspace="420")
    return root


def _reduced_devobs(tmp):
    with open(os.path.join(REPO, "configs/rnb-fused-yuv-devobs.json")) as f:
        raw = json.load(f)
    loader, runner = raw["pipeline"]
    loader.update(max_clips=2, row_buckets=[1, 2], fuse=2)
    runner.update(max_rows=2, row_buckets=[1, 2], layer_sizes=[1, 1, 1, 1],
                  num_classes=10)
    path = os.path.join(tmp, "devobs.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A --profile run and an --xprof run of a reduced devobs cell, each
    with one forced capture."""
    from rnb_tpu_torch.benchmark import run_benchmark
    tmp = str(tmp_path_factory.mktemp("profiled"))
    config = _reduced_devobs(tmp)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RNB_TPU_DATA_ROOT", _dataset(os.path.join(tmp, "data")))
        mp.setenv(devobs.FORCE_ENV, "1")
        for label in ("profile", "xprof"):
            out[label] = run_benchmark(
                config, mean_interval_ms=0, num_videos=6,
                log_base=os.path.join(tmp, "logs", label),
                print_progress=False, seed=0, platform="cpu",
                **{label: True})
            assert out[label].termination_flag == 0
            assert not profiler._capturing and profiler._session is None
    return out


def test_a_capture_inside_a_profile_window_is_skipped_and_counted(runs):
    result = runs["profile"]
    assert result.compute_captures == 0
    assert result.compute_captures_skipped == 1
    files = os.listdir(result.log_dir)
    assert "profile.txt" in files
    assert not [n for n in files if n.startswith("devobs-capture-")]
    with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
        assert "captures=0\n" in f.read()


def test_the_xprof_run_writes_the_reference_format(runs):
    result = runs["xprof"]
    # the xprof session held the profiler: the forced capture was skipped
    assert (result.compute_captures, result.compute_captures_skipped) \
        == (0, 1)
    path = os.path.join(result.log_dir, "xprof-ops.txt")
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "# t0_ns t1_ns plane op_name"
    assert lines[1].startswith("# window_epoch ")
    rows = [line.split(" ", 3) for line in lines[2:]]
    assert rows and all(len(r) == 4 and int(r[1]) >= int(r[0]) >= 0
                        and r[2] == profiler.HOST_PLANE for r in rows)
    assert "aten::conv3d" in {r[3] for r in rows}


def _device_busy(path, monkeypatch, capsys):
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    import device_busy
    rc = device_busy.main([path])
    return rc, capsys.readouterr().out


def test_device_busy_reads_the_xprof_file(runs, monkeypatch, capsys):
    rc, out = _device_busy(os.path.join(runs["xprof"].log_dir,
                                        "xprof-ops.txt"), monkeypatch, capsys)
    assert rc == 0
    assert "plane               : /host:CPU" in out
    assert "measured window" in out


def test_profile_and_xprof_together_are_refused():
    from rnb_tpu_torch.benchmark import run_benchmark
    with pytest.raises(ValueError, match="one profiler session"):
        run_benchmark("unread.json", platform="cpu", profile=True,
                      xprof=True)
