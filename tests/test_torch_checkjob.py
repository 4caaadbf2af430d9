"""The port's whole ``check_job`` against the reference's, on job
directories the port writes.

One reduced served run of the paged Zipf cell (clip cache, page
allocator, ragged pools, staging) with tracing and the lock-order
witness armed is read by both packages' checks as written: the
reference's ``scripts/parse_utils.check_job_detail`` returns ``([],
False)`` and the port's ``check_job`` ``[]``. The reference's
``parse_meta`` reads the port's log-meta as written: its window is the
port's. Then one doctored copy per invariant the port's ``check_job``
gained is flagged by both checkers, with the reference's message where
the invariant is new to the port, and an unreadable table is a parse
failure (exit 2) in both. The other files' served runs go through the
same pair of checks (``tests/torch_job_checks.py``).
"""

import json
import os
import re
import shutil

import pytest

from rnb_tpu_torch.analysis.concurrency import static_lock_order_edges
from rnb_tpu_torch.benchmark import run_benchmark
from rnb_tpu_torch.parse_utils import (check_job, check_job_detail,
                                       main as port_main, read_meta)

from test_torch_slice import _dataset, _reduced
from torch_job_checks import assert_both_checks_pass, jax_parse_utils

PAGED = "configs/rnb-fused-yuv-paged-zipf.json"
REQUESTS = 12


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("checkjob")
    path = _reduced(PAGED, tmp)
    with open(path) as f:
        raw = json.load(f)
    raw["trace"] = {"enabled": True}
    raw["lint"] = {"lock_witness": True}
    with open(path, "w") as f:
        json.dump(raw, f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RNB_TPU_DATA_ROOT", _dataset(str(tmp / "d")))
        result = run_benchmark(path, mean_interval_ms=0, num_videos=REQUESTS,
                               log_base=str(tmp / "logs"),
                               print_progress=False, seed=0, platform="cpu")
    assert result.termination_flag == 0 and result.num_completed == REQUESTS
    return result


def test_both_check_jobs_pass_the_paged_traced_witnessed_run(served):
    assert_both_checks_pass(served.log_dir)
    assert check_job_detail(served.log_dir) == ([], False)
    assert port_main([served.log_dir]) == 0


def test_the_reference_reads_the_port_s_log_meta_as_written(served):
    meta = read_meta(os.path.join(served.log_dir, "log-meta.txt"))
    theirs = jax_parse_utils.parse_meta(served.log_dir)
    start, end = meta["window"]
    assert theirs["time_start"] == start and theirs["time_end"] == end
    assert theirs["wall_time_s"] == end - start
    assert theirs["termination_flag"] == 0
    assert meta["device"] == {"name": "cpu", "platform": "cpu"}


def test_the_witness_s_edges_lie_in_the_static_graph(served):
    meta = read_meta(os.path.join(served.log_dir, "log-meta.txt"))
    edges = {tuple(e) for e in meta["lock_edge_detail"]["edges"]}
    # a paged hit pins its pages under the cache's lock
    assert ("ClipCache._lock", "Pager.lock") in edges
    assert edges <= static_lock_order_edges()
    assert meta["lock_edge_detail"]["violations"] == []


def _table(job):
    return sorted(n for n in os.listdir(job) if "-group" in n)[0]


def _edit_meta(head, edit):
    """Rewrite the ``head`` line of log-meta (None drops it)."""
    def apply(job):
        path = os.path.join(job, "log-meta.txt")
        with open(path) as f:
            lines = f.read().splitlines()
        hit = [i for i, ln in enumerate(lines) if ln.startswith(head)]
        assert hit, head
        if edit is None:
            del lines[hit[0]]
        else:
            lines[hit[0]] = edit(lines[hit[0]])
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return apply


def _drop_window(job):
    path = os.path.join(job, "log-meta.txt")
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines()
                 if not re.fullmatch(r"[\d.]+ [\d.]+", ln)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _edit_table(edit):
    def apply(job):
        path = os.path.join(job, _table(job))
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(edit(text))
    return apply


def _set(key, value):
    """``key=<n>`` -> ``key=<value>`` in one line or trailer."""
    return lambda text: re.sub(r"\b%s=-?\d+" % key,
                               "%s=%s" % (key, value), text, count=1)


def _spoil_first_row(text):
    lines = text.split("\n")
    fields = lines[1].split()
    fields[1] = "x"
    lines[1] = " ".join(fields)
    return "\n".join(lines)


def _retrailer(kind, key, value):
    """Edit (or add) a table's ``# <kind>`` trailer field."""
    def edit(text):
        lines = text.rstrip("\n").split("\n")
        for i, line in enumerate(lines):
            if line.startswith("# %s " % kind):
                lines[i] = _set(key, value)(line)
                break
        else:
            lines.append("# %s %s=%s" % (kind, key, value))
        return "\n".join(lines) + "\n"
    return edit


def _dead_letter(job):
    with open(os.path.join(job, "failed-requests.txt"), "w") as f:
        f.write("# request_id step reason\n3 0 corrupt-video\n")


def _phases_mean(line):
    head, rest = line.split(": ", 1)
    phases = json.loads(rest)
    phases[sorted(phases)[0]]["mean_ms"] += 5.0
    return "%s: %s" % (head, json.dumps(phases, sort_keys=True))


def _ghost_edge(job):
    def edges(line):
        head, rest = line.split(": ", 1)
        detail = json.loads(rest)
        detail["edges"].append(["Ghost._lock", "Pager.lock"])
        return "%s: %s" % (head, json.dumps(detail, sort_keys=True))
    meta = read_meta(os.path.join(job, "log-meta.txt"))
    count = len(meta["lock_edge_detail"]["edges"]) + 1
    _edit_meta("Lock edges:", edges)(job)
    _edit_meta("Locks:", _set("edges", count))(job)
    _edit_meta("Locks:", _set("tracked", 99))(job)


#: (name, doctoring, a message both checkers give or None)
DOCTORED = [
    ("termination", _edit_meta("Termination flag:", None),
     "log-meta.txt carries no 'Termination flag:'"),
    ("window", _drop_window,
     "log-meta.txt carries no start/end timestamps"),
    ("fault-trailer", _edit_table(_retrailer("faults", "num_failed", 3)),
     None),
    ("dead-letters", _dead_letter, None),
    ("cache-hits", _edit_table(_retrailer("cache", "num_hits", 999)),
     "tables count 999 completed cache hits"),
    ("cache-tracked", _edit_table(_retrailer("cache", "num_tracked", 999)),
     "cache trailer tracks 999 completions"),
    ("cache-inserts", _edit_meta("Cache:", _set("inserts", 999)),
     "cache_inserts=999 exceeds cache_misses"),
    ("cache-bytes", _edit_meta("Cache:", _set("bytes_resident", -1)),
     "negative cache_bytes_resident"),
    ("staging-waits", _edit_meta("Staging:", _set("acquire_waits", 999)),
     "staging_acquire_waits=999 exceeds staging_acquires"),
    ("staging-negative", _edit_meta("Staging:", _set("copied_batches", -1)),
     "negative staging_copied_batches"),
    ("pads", _edit_meta("Padding:", _set("pad_rows", 999)),
     "pad_rows=999 exceeds total_rows"),
    ("pad-trailer", _edit_table(_retrailer("padding", "pad_rows", 5)),
     "tables count pad_rows=5 but log-meta says 0"),
    ("ragged-rows", _edit_meta("Ragged:", _set("rows", 999)),
     "ragged_rows=999 exceeds emissions*pool_rows"),
    ("ragged-pads", _edit_meta("Padding:", _set("pad_rows", 1)),
     "pad_rows=1 on a fully ragged run"),
    ("pages-limbo", _edit_meta("Pages:", _set("limbo", 999)),
     "pages_limbo=999 exceeds pages_live"),
    ("feature-inserts", _edit_meta("Pages:", _set("feature_inserts", 999)),
     "pages_feature_inserts=999 != pages_feature_entries"),
    ("feature-gathers", _edit_meta("Pages:", _set("feature_gathers", 999)),
     "pages_feature_gathers=999 exceeds pages_feature_hits"),
    ("phases-line", _edit_meta("Phases:", _phases_mean), None),
    ("phases-trailer", _edit_table(_retrailer("phases", "n", 999)),
     "'# phases' trailer says n=999"),
    ("lock-edge", _ghost_edge,
     "observed lock-order edge Ghost._lock -> Pager.lock is not in the "
     "static RNB-C lock-order graph"),
]


@pytest.mark.parametrize("name,doctor,message", DOCTORED,
                         ids=[case[0] for case in DOCTORED])
def test_a_doctored_job_fails_both_checkers(served, tmp_path, name, doctor,
                                            message):
    job = str(tmp_path / "job")
    shutil.copytree(served.log_dir, job)
    doctor(job)
    theirs, their_parse_failed = jax_parse_utils.check_job_detail(job)
    ours, our_parse_failed = check_job_detail(job)
    assert theirs and ours, name
    assert not their_parse_failed and not our_parse_failed
    if message is not None:
        assert any(message in p for p in theirs), theirs
        assert any(message in p for p in ours), ours
    assert port_main([job]) == 1


def test_an_unreadable_table_is_a_parse_failure_in_both(served, tmp_path):
    job = str(tmp_path / "job")
    shutil.copytree(served.log_dir, job)
    _edit_table(_spoil_first_row)(job)
    theirs, their_parse_failed = jax_parse_utils.check_job_detail(job)
    ours, our_parse_failed = check_job_detail(job)
    assert their_parse_failed and our_parse_failed
    assert any("unparsable" in p for p in theirs)
    assert any("unparsable" in p for p in ours)
    assert port_main([job]) == 2


def test_an_unknown_stamp_column_is_flagged(served, tmp_path):
    job = str(tmp_path / "job")
    shutil.copytree(served.log_dir, job)
    _edit_table(lambda text: text.replace("enqueue_filename",
                                          "ghost_stamp", 1))(job)
    assert any("ghost_stamp" in p for p in check_job(job))
