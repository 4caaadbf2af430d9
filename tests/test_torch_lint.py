"""rnb-lint of the port (``rnb_tpu_torch/analysis``, the CLI
``python -m rnb_tpu_torch.tools.lint``) held to the reference's analyzers.

* the concurrency family gives the reference's (rule, line) set on every
  ``tests/lint_fixtures/*_c00*.py`` fixture, and the graph family the
  reference's rule on every ``*.json`` fixture (read as they are);
* every shipped config passes the port's graph family;
* the PyTorch forms of RNB-H001, H003, H006, H008 and H010, and each
  schema rule RNB-T001..T009, have a bad fixture that triggers exactly
  its rule and a good one that triggers nothing (written into
  ``tmp_path``);
* the CLI exits 0 over the tree, 1 on a new finding and on a stale
  baseline entry;
* the fixes behind the hot-path findings: a wedged fallback decode
  raises a transient error at its bound instead of hanging the stage.
"""

import glob
import os
import subprocess
import sys
import threading
from concurrent.futures import Future

import pytest

from rnb_tpu.analysis import concurrency as jax_concurrency
from rnb_tpu.analysis import graph as jax_graph
from rnb_tpu_torch.analysis import concurrency, graph, hotpath, schema
from rnb_tpu_torch.analysis.findings import Baseline, package_py_files
from rnb_tpu_torch.faults import TransientDecodeError
from rnb_tpu_torch.models.r2p1d import model as port_model
from rnb_tpu_torch.telemetry import MetricSpec, StampSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
BASELINE = os.path.join(REPO, "rnb_tpu_torch", "analysis", "baseline.txt")


def _fixture(name):
    return os.path.join(FIXTURES, name)


# -- the concurrency family --------------------------------------------

@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(_fixture("*_c00*.py"))))
def test_concurrency_matches_the_reference_on_its_fixtures(name):
    ours = {(f.rule, f.line) for f in concurrency.check_file(_fixture(name))}
    theirs = {(f.rule, f.line)
              for f in jax_concurrency.check_file(_fixture(name))}
    assert ours == theirs
    assert bool(ours) == name.startswith("bad_")


def test_the_static_lock_graph_holds_the_cache_pager_nesting():
    assert ("ClipCache._lock", "Pager.lock") \
        in concurrency.static_lock_order_edges()
    declared = {cls for _file, cls, _g, _u in concurrency.contract_registry()}
    assert {"ClipCache", "StagingPool", "Pager", "NetEdgeClient"} <= declared


# -- the graph family --------------------------------------------------

@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(_fixture("*.json"))))
def test_graph_fixtures_trigger_the_reference_s_rule(name):
    ours = {f.rule for f in graph.check_config(_fixture(name), root=REPO)}
    theirs = {f.rule for f in jax_graph.check_config(_fixture(name),
                                                     root=REPO)}
    assert ours == theirs
    if name.startswith("bad_"):
        assert ours == {"RNB-" + name.split("_")[1].upper()}
    else:
        assert ours == set()


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "configs", "*.json"))))
def test_every_shipped_config_passes_the_graph_family(path):
    findings = graph.check_config(os.path.join(REPO, path), root=REPO)
    assert findings == [], [f.render() for f in findings]


# -- the hot-path family: the PyTorch forms ------------------------------

HOT_FIXTURES = {
    "H001": ('''
import time
import torch


def capture(graph, static_in, net):
    with torch.cuda.graph(graph):
        out = net(static_in)
        peak = out.max().item()
    return out, peak
''', '''
import torch


def capture(graph, static_in, net):
    rows = int(static_in.shape[0])
    with torch.cuda.graph(graph):
        out = net(static_in[:rows])
    return out
'''),
    "H003": ('''
class Stage:
    def __call__(self, tensors, non_tensors, card):
        out = []
        for t in tensors:
            out.append(t.to(self.device, non_blocking=True))
        return out, non_tensors, card
''', '''
import torch


class Stage:
    def __call__(self, tensors, non_tensors, card):
        batch = torch.stack(list(tensors)).to(self.device)
        return [batch.to(torch.float32)], non_tensors, card
'''),
    "H006": ('''
class Stage:
    def __call__(self, tensors, non_tensors, card):
        logits = self.net(tensors[0])
        return None, logits.argmax().item(), card
''', '''
class Stage:
    def __call__(self, tensors, non_tensors, card):
        logits = self.net(tensors[0])
        return None, logits.argmax(), card
'''),
    "H008": ('''
class EdgeHandoff:
    def take(self, payload):
        return [p.cpu() for p in payload]
''', '''
class EdgeHandoff:
    def take(self, payload):
        return [p.to(self.device) for p in payload]

    def take_host(self, payload):
        return [p.cpu() for p in payload]
'''),
    "H010": ('''
import torch


class Stage:
    def __call__(self, tensors, non_tensors, card):
        pool = torch.zeros(self._batch_shape(self.pool_rows),
                           device=self.device)
        return [pool], non_tensors, card
''', '''
import torch


class Stage:
    def __init__(self, device):
        self.device = device
        self._pool = torch.zeros(self._batch_shape(self.pool_rows),
                                 device=device)

    def __call__(self, tensors, non_tensors, card):
        return [self._pool], non_tensors, card
'''),
}


@pytest.mark.parametrize("rule,bad", [
    (rule, bad) for rule in sorted(HOT_FIXTURES) for bad in (True, False)])
def test_hot_path_fixtures(tmp_path, rule, bad):
    path = tmp_path / ("%s_%s.py" % ("bad" if bad else "good", rule.lower()))
    path.write_text(HOT_FIXTURES[rule][0 if bad else 1])
    rules = {f.rule for f in hotpath.check_file(str(path),
                                                root=str(tmp_path))}
    assert rules == ({"RNB-" + rule} if bad else set())


def test_the_package_s_hot_path_findings_are_the_baselined_ones():
    findings = hotpath.check_package(os.path.join(REPO, "rnb_tpu_torch"),
                                     root=REPO)
    baseline = Baseline.load(BASELINE)
    assert {f.key() for f in findings} == {
        key for key in baseline.entries if key[0].startswith("RNB-H")}


# -- the schema family -------------------------------------------------

def _py(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _stamp_case(tmp_path, rule, bad):
    registry = (StampSpec("kept{step}_done", "here", "recorded and read"),)
    reader = 'KEY = "kept%d_done"\n'
    records = 'card.record("kept%d_done" % 0)\n'
    if rule == "T001" and bad:
        records += 'card.record("bogus_stamp")\n'
    if rule == "T002" and bad:
        reader = 'KEY = "other"\n'
    if rule == "T003" and bad:
        records = "pass\n"
    path = _py(tmp_path, "stamps.py", records)
    return schema.check_stamps([path], reader, root=str(tmp_path),
                               registry=registry)


def _meta_case(tmp_path, rule, bad):
    registry = (StampSpec("Kept:", "here", "written and read"),)
    writes = 'f.write("Kept: n=%d\\n" % n)\n'
    reader = 'if head == "Kept":\n    pass\n'
    if rule == "T004" and bad:
        writes += 'f.write("Bogus line: %s\\n" % b)\n'
    if rule == "T005" and bad:
        reader = 'if head == "Other":\n    pass\n'
    path = _py(tmp_path, "bench.py", writes)
    return schema.check_meta_lines(path, reader, root=str(tmp_path),
                                   registry=registry)


def _result_case(tmp_path, bad):
    bench = os.path.join(REPO, "rnb_tpu_torch", "benchmark.py")
    with open(bench) as f:
        src = f.read()
    if bad:
        src += '\nf.write("Cache: bogus_counter=%d\\n" % n)\n'
    path = _py(tmp_path, "benchmark.py", src)
    known = {f.key()[2] for f in schema.check_benchmark_result(bench, REPO)}
    return [f for f in schema.check_benchmark_result(path, str(tmp_path))
            if f.anchor not in known]


def _content_case(tmp_path, bad):
    attr = "bogus_attr" if bad else "video"
    path = _py(tmp_path, "stage.py", "time_card.%s = 1\n" % attr)
    return schema.check_content_stamps([path], root=str(tmp_path))


def _trace_case(tmp_path, bad):
    registry = (StampSpec("ok.span", "here", "emitted"),)
    src = 'with trace.span("ok.span"):\n    pass\n'
    if bad:
        src += 'trace.instant("bad.event")\n'
    path = _py(tmp_path, "traced.py", src)
    return schema.check_trace_events([path], root=str(tmp_path),
                                     registry=registry)


def _metric_case(tmp_path, bad):
    registry = (MetricSpec("ok.count", "counter", "site", "emitted"),)
    src = 'metrics.counter("ok.count")\n'
    if bad:
        src += 'metrics.observe("bad.hist", 1.0)\n'
    path = _py(tmp_path, "metered.py", src)
    return schema.check_metric_names([path], root=str(tmp_path),
                                     registry=registry)


SCHEMA_CASES = {
    "T001": lambda tmp, bad: _stamp_case(tmp, "T001", bad),
    "T002": lambda tmp, bad: _stamp_case(tmp, "T002", bad),
    "T003": lambda tmp, bad: _stamp_case(tmp, "T003", bad),
    "T004": lambda tmp, bad: _meta_case(tmp, "T004", bad),
    "T005": lambda tmp, bad: _meta_case(tmp, "T005", bad),
    "T006": _result_case,
    "T007": _content_case,
    "T008": _trace_case,
    "T009": _metric_case,
}


@pytest.mark.parametrize("rule,bad", [
    (rule, bad) for rule in sorted(SCHEMA_CASES) for bad in (True, False)])
def test_schema_fixtures(tmp_path, rule, bad):
    rules = {f.rule for f in SCHEMA_CASES[rule](tmp_path, bad)}
    assert rules == ({"RNB-" + rule} if bad else set())


def test_the_reader_template_forms_are_seen():
    # a stamp key hoisted into a name, and one looked up in a table of
    # templates, are sites the schema family sees
    tree_src = ('KEY = "runner%d_start" % step\n'
                'TABLE = {"a": "decode%d_done"}\n'
                'card.record(KEY)\n'
                '_record_clamped(card, TABLE[stage] % step, at)\n')
    import ast
    tree = ast.parse(tree_src)
    bindings = schema._bindings(tree)
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
    assert schema._templates(calls[0].args[0], bindings) \
        == ["runner%d_start"]
    assert schema._templates(calls[1].args[1], bindings) == ["decode%d_done"]


# -- the CLI -----------------------------------------------------------

def _lint(*args):
    return subprocess.run(
        [sys.executable, "-m", "rnb_tpu_torch.tools.lint"] + list(args),
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_the_cli_is_clean_over_the_tree():
    proc = _lint()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert [ln.split(":")[0] for ln in lines[:4]] == [
        "rnb-lint graph", "rnb-lint hotpath", "rnb-lint schema",
        "rnb-lint concurrency"]
    assert lines[-1].endswith("0 stale baseline entries — OK")


def test_a_new_finding_fails_the_cli():
    proc = _lint("--family", "graph", "--config",
                 _fixture("bad_g004_selector.json"))
    assert proc.returncode == 1
    assert "RNB-G004" in proc.stdout


def test_a_stale_baseline_entry_fails_the_cli(tmp_path):
    stale = tmp_path / "baseline.txt"
    stale.write_text("RNB-G003 configs/none.json step1.group0  # gone\n")
    proc = _lint("--family", "graph", "--config",
                 _fixture("good.json"), "--baseline", str(stale))
    assert proc.returncode == 1
    assert "stale baseline entry" in proc.stdout


def test_every_baseline_entry_carries_a_justification():
    with open(BASELINE) as f:
        entries = [ln for ln in f.read().splitlines()
                   if ln.strip() and not ln.startswith("#")]
    assert len(entries) == len(Baseline.load(BASELINE).entries)
    assert all(ln.partition("#")[2].strip() for ln in entries)


def test_the_analysis_imports_nothing_of_the_reference():
    import ast
    for path in package_py_files(os.path.join(REPO, "rnb_tpu_torch",
                                              "analysis")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] not in ("rnb_tpu", "jax",
                                                  "parse_utils"), path


# -- the fixes behind the findings -------------------------------------

def test_a_wedged_fallback_decode_fails_transiently_at_its_bound():
    """The decode handle's wait was unbounded (RNB-H009): a fallback
    decode thread that never returns now dead-letters its request as a
    transient failure, as the reference's does."""
    never = Future()
    handle = port_model._DecodeHandle(None, 1, future=never,
                                      video="wedged.y4m")
    with pytest.raises(TransientDecodeError, match="wedged.y4m"):
        handle.wait(timeout=0.01)
    # the failure is sticky: a follower of this handle fails alike
    follower = port_model._DecodeHandle(None, 1, leader=handle)
    with pytest.raises(TransientDecodeError):
        follower.wait(timeout=0.01)
    record = port_model._FuseRecord(1, None, None, 0, video="w.y4m")
    record.future = Future()
    with pytest.raises(TransientDecodeError, match="w.y4m"):
        record.wait(timeout=0.01)
    done = Future()
    threading.Timer(0.01, done.set_result, ("rows",)).start()
    ok = port_model._DecodeHandle(None, 1, future=done, video="ok.y4m")
    ok.wait(timeout=5.0)
    assert ok.out == "rows"
