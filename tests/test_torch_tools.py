"""The port's measurement tools and ``bench_cuda.py``'s Poisson mode.

``bench_cuda.py`` reads ``RNB_BENCH_MEAN_INTERVAL_MS`` and reports it,
and names the config's latency semantics by ``bench.py``'s rule (held
over every shipped config, and on copies that publish before their
device work ends); one real fresh-process cell serves a reduced config
on the CPU in Poisson mode through ``tools/bench_matrix.run_cell`` and
its job directory passes ``check_job_detail``. The matrix and frontier
tools mirror the reference's tests with ``run_cell`` faked (the short
circuit once no CUDA device answers, an unparseable cell contained) and
their plans, ``--only`` globs and outputs are checked. An AST guard
holds the new modules to importing neither ``jax``, ``rnb_tpu``, the
``scripts/`` modules, ``pandas`` nor ``matplotlib``.
"""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench  # noqa: E402
import bench_cuda  # noqa: E402
from rnb_tpu_torch.dataset import make_dataset  # noqa: E402
from rnb_tpu_torch.devobs import latency_semantics  # noqa: E402
from rnb_tpu_torch.parse_utils import check_job_detail  # noqa: E402
from rnb_tpu_torch.tools import bench_matrix, latency_frontier  # noqa: E402

CONFIGS = sorted(name for name in os.listdir(os.path.join(REPO, "configs"))
                 if name.endswith(".json"))
#: the modules of this slice
NEW_MODULES = ("rnb_tpu_torch/parse_utils.py",
               "rnb_tpu_torch/tools/rnb_diff.py",
               "rnb_tpu_torch/tools/latency_summary.py",
               "rnb_tpu_torch/tools/bench_matrix.py",
               "rnb_tpu_torch/tools/latency_frontier.py",
               "rnb_tpu_torch/tools/explain.py", "bench_cuda.py")
#: what none of them may import: the JAX package, its scripts (by the
#: names ``sys.path`` gives them), pandas and matplotlib
FORBIDDEN = ({"jax", "jaxlib", "flax", "rnb_tpu", "scripts", "pandas",
              "matplotlib"}
             | {name[:-3] for name in os.listdir(os.path.join(REPO,
                                                            "scripts"))
                if name.endswith(".py")})


def _load(name):
    with open(os.path.join(REPO, "configs", name)) as f:
        return json.load(f)


# -- latency semantics and the Poisson knob -----------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_latency_semantics_are_bench_py_s(name):
    raw = _load(name)
    assert latency_semantics(raw) == bench._latency_semantics(raw)


@pytest.mark.parametrize("name,change,want", [
    ("r2p1d-mesh.json", None, "dispatch"),
    ("r2p1d-mesh-yuv.json", None, "dispatch"),
    ("r2p1d-mesh.json", "sync", "completion"),
    ("rnb-fused-yuv-big.json", None, "completion"),
    ("rnb-scaleout-r4.json", "async", "dispatch")])
def test_a_stage_that_publishes_early_reports_dispatch(name, change, want):
    raw = _load(name)
    if change == "sync":
        for step in raw["pipeline"]:
            step.pop("sync_preds", None)
    elif change == "async":
        raw["pipeline"][0]["async_dispatch"] = True
    assert latency_semantics(raw) == want == bench._latency_semantics(raw)


def _reduced_config(tmp):
    """The scale-out r1 pipeline without its planes, on one card (the
    reduced config ``tests/test_torch_bench_cuda.py`` serves)."""
    with open(os.path.join(REPO, "configs/rnb-scaleout-r1.json")) as f:
        raw = json.load(f)
    for key in ("handoff", "placement", "fault_plan", "trace"):
        raw.pop(key)
    raw["pipeline"][1]["queue_groups"][0]["devices"] = [0]
    path = os.path.join(tmp, "reduced.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def test_a_poisson_cell_serves_in_a_fresh_process(tmp_path, monkeypatch):
    tmp = str(tmp_path)
    config = _reduced_config(tmp)
    root = make_dataset(os.path.join(tmp, "data"), videos=4, frames=16)
    for key in list(os.environ):
        if key.startswith("RNB_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("RNB_BENCH_PLATFORM", "cpu")
    monkeypatch.setenv("RNB_TPU_DATA_ROOT", root)
    row = bench_matrix.run_cell(config, 40, 8,
                                log_base=os.path.join(tmp, "jobs"))
    assert row["bench_rc"] == 0, row
    assert row["mean_interval_ms"] == 40 and row["num_videos"] == 8
    assert row["latency_semantics"] == "completion"
    assert row["value"] > 0 and row["platform"] == "cpu"
    job = row["evidence_logs"]
    assert os.path.isdir(job) and os.path.dirname(job) == \
        os.path.join(tmp, "jobs")
    assert check_job_detail(job) == ([], False)
    with open(os.path.join(job, "log-meta.txt")) as f:
        args = json.loads(f.readline().split(": ", 1)[1])
    assert args["mean_interval_ms"] == 40


@pytest.mark.parametrize("value", ["-3", "six"])
def test_a_bad_mean_interval_is_an_error_line(value, tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("RNB_")}
    env.update(RNB_BENCH_PLATFORM="cpu", RNB_BENCH_MEAN_INTERVAL_MS=value,
               RNB_BENCH_DATASET="synth")
    proc = subprocess.run([sys.executable, os.path.join(REPO,
                                                        "bench_cuda.py")],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300)
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert proc.returncode == 1 and line["value"] is None
    assert "RNB_BENCH_MEAN_INTERVAL_MS" in line["error"]


@pytest.mark.parametrize("flag", [0, 1])
def test_a_terminated_run_prints_its_numbers_with_its_flag(flag,
                                                           monkeypatch):
    seen = {}

    def fake_measure(config, num_videos, dataset_root, mode, platform,
                     log_base="logs", seed=0, mean_interval_ms=0):
        seen["mi"] = mean_interval_ms
        return {"metric": "videos_per_sec", "value": 1.5,
                "mean_interval_ms": mean_interval_ms}, flag

    monkeypatch.setattr(bench_cuda, "measure", fake_measure)
    monkeypatch.setattr(bench_cuda, "ensure_dataset",
                        lambda repo: (None, "synth"))
    monkeypatch.setenv("RNB_BENCH_PLATFORM", "cpu")
    monkeypatch.setenv("RNB_BENCH_MEAN_INTERVAL_MS", "4")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = bench_cuda.main()
    line = json.loads(out.getvalue())
    assert seen["mi"] == 4 and line["value"] == 1.5
    assert code == flag
    assert line.get("termination_flag", 0) == flag
    assert ("error" in line) == bool(flag)


# -- the matrix ---------------------------------------------------------------

def _fake_row(config, mi, videos, **extra):
    row = {"metric": "videos_per_sec", "value": 5.0, "config": config,
           "mean_interval_ms": mi, "num_videos": videos, "platform": "gpu",
           "decode_backend": "native-y4m", "p50_ms": 40.0, "p99_ms": 90.0,
           "latency_semantics": "completion"}
    row.update(extra)
    return row


def test_the_matrix_stops_once_no_cuda_device_answers(tmp_path,
                                                      monkeypatch):
    calls = []

    def fake_run_cell(config, mi, videos, extra_env=None, log_base=None):
        calls.append((config, mi, log_base))
        if len(calls) == 1:
            return _fake_row(config, mi, videos, evidence_logs="logs/x")
        return {"metric": "videos_per_sec", "value": None,
                "error": "no CUDA device is available (set "
                         "RNB_BENCH_PLATFORM=cpu for a CPU smoke)"}

    monkeypatch.setattr(bench_matrix, "run_cell", fake_run_cell)
    monkeypatch.setenv("RNB_MATRIX_OUT", str(tmp_path))
    monkeypatch.setenv("RNB_MATRIX_VIDEOS", "8")
    assert bench_matrix.main([]) == 0
    assert len(calls) == 2
    assert len({log_base for _c, _m, log_base in calls}) == 2
    with open(tmp_path / "BENCH_MATRIX.json") as f:
        artifact = json.load(f)
    rows = artifact["rows"]
    assert len(rows) == len(bench_matrix._cells(6))
    assert sum("skipped" in str(r.get("error", "")) for r in rows) == \
        len(rows) - 2
    table = (tmp_path / "MATRIX.md").read_text()
    assert table.count("\n|") == len(rows) + 2 and "logs/x" in table


@pytest.mark.parametrize("stdout,want", [
    ("not json at all\n", "unparseable"), ("", "no output"),
    ("[1, 2]\n", "not an object")])
def test_a_cell_that_prints_no_line_costs_its_row_only(stdout, want,
                                                       monkeypatch,
                                                       tmp_path):
    class FakeProc:
        returncode = 1
        stderr = "boom"

    FakeProc.stdout = stdout
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: FakeProc())
    row = bench_matrix.run_cell("configs/x.json", 0, 4,
                                log_base=str(tmp_path / "cell"))
    assert want in row["error"] and set(row) == {"error"}


def test_a_cell_names_its_one_job_directory(tmp_path, monkeypatch):
    log_base = tmp_path / "cell"

    class FakeProc:
        returncode = 0
        stderr = ""
        stdout = json.dumps(_fake_row("c", 0, 4)) + "\n"

    def fake_run(*args, **kwargs):
        job = log_base / "job-1"
        job.mkdir(parents=True)
        (job / "log-meta.txt").write_text("Termination flag: 0\n")
        assert kwargs["env"]["RNB_BENCH_LOG_BASE"] == str(log_base)
        assert kwargs["env"]["RNB_BENCH_MEAN_INTERVAL_MS"] == "6"
        return FakeProc()

    monkeypatch.setattr(subprocess, "run", fake_run)
    row = bench_matrix.run_cell("configs/rnb-fused-yuv.json", 6, 4,
                                log_base=str(log_base))
    assert row["evidence_logs"] == str(log_base / "job-1")
    assert row["bench_rc"] == 0


@pytest.mark.parametrize("only,names", [
    (None, None),
    (["rnb-fused-yuv-big@[06]", "r2p1d-whole@0"],
     ["r2p1d-whole@0", "rnb-fused-yuv-big@0", "rnb-fused-yuv-big@6"]),
    (["*+mjpeg"], ["rnb-fused-yuv-big@0+mjpeg"]),
    (["nothing"], [])])
def test_only_selects_cells_by_name(only, names):
    cells = bench_matrix.plan(200, 6, only)
    got = [bench_matrix.cell_name(c, mi, env) for c, mi, env, _n in cells]
    if names is None:
        assert len(got) == len(bench_matrix._cells(6)) == 16
        assert len(set(got)) == len(got)
    else:
        assert got == names


def test_the_plan_caps_the_slow_cells_and_halves_poisson():
    cells = {bench_matrix.cell_name(c, mi, env): n
             for c, mi, env, n in bench_matrix.plan(4000, 6)}
    assert cells["rnb-fused-yuv-big@0"] == 4000
    assert cells["rnb-fused-yuv-big@6"] == 2000
    assert cells["r2p1d-nopipeline-1chip@0"] == 300
    assert cells["rnb-fused-yuv-big@0+mjpeg"] == 2000
    small = {bench_matrix.cell_name(c, mi, env): n
             for c, mi, env, n in bench_matrix.plan(200, 6)}
    assert small["rnb-fused-yuv-big@6"] == 200
    assert set(small.values()) == {200}


def test_every_matrix_config_serves_on_one_card():
    for config, _mi, _env in bench_matrix._cells(6):
        raw = _load(os.path.basename(config))
        devices = {d for step in raw["pipeline"]
                   for g in step["queue_groups"] for d in g["devices"]}
        assert devices <= {-1, 0}, config


def test_no_output_goes_to_the_repo_root():
    assert bench_matrix.DEFAULT_OUT == os.path.join(REPO, "logs", "matrix")
    assert latency_frontier.DEFAULT_OUT == os.path.join(REPO, "logs",
                                                        "frontier")


# -- the frontier -------------------------------------------------------------

def test_the_frontier_records_an_infeasible_rate_as_a_row(tmp_path,
                                                         monkeypatch):
    def fake_run_cell(config, mi, videos, extra_env=None, log_base=None):
        assert videos == 12 and extra_env == {}
        if mi == 3:
            return _fake_row(config, mi, videos, termination_flag=1,
                             error="the run ended with termination flag 1",
                             bench_rc=1)
        return _fake_row(config, mi, videos, bench_rc=0,
                         evidence_logs=log_base)

    monkeypatch.setattr(bench_matrix, "run_cell", fake_run_cell)
    monkeypatch.setenv("RNB_FRONTIER_OUT", str(tmp_path))
    monkeypatch.setenv("RNB_FRONTIER_VIDEOS", "12")
    assert latency_frontier.main(["--only", "rnb-fused-yuv-mid@*"]) == 0
    with open(tmp_path / "FRONTIER.json") as f:
        rows = json.load(f)["rows"]
    assert [(r["mean_interval_ms"], r["termination_flag"]) for r in rows] \
        == [(3, 1), (4, 0), (6, 0), (9, 0)]
    assert [r["offered_rps"] for r in rows] == [333.333, 250.0, 166.667,
                                                111.111]
    assert all(r["config"] == "configs/rnb-fused-yuv-mid.json"
               for r in rows)
    table = (tmp_path / "FRONTIER.md").read_text()
    assert table.count("\n|") == 6 and "termination flag 1" in table


def test_the_frontier_refuses_a_glob_that_selects_nothing(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("RNB_FRONTIER_OUT", str(tmp_path))
    assert latency_frontier.main(["--only", "r2p1d-whole@*"]) == 2
    assert bench_matrix.main(["--only", "no-such-config@0"]) == 2


# -- the new modules stand alone ------------------------------------------

def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


@pytest.mark.parametrize("module", NEW_MODULES)
def test_a_new_module_imports_no_jax_scripts_pandas_or_matplotlib(module):
    tops = {name.split(".")[0] for name in _imports(os.path.join(REPO,
                                                                 module))}
    assert not tops & FORBIDDEN, (module, tops & FORBIDDEN)
    assert "parse_utils" not in tops and "rnb_diff" not in tops
