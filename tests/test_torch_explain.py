"""The port's offline explanation tools held to the reference's scripts.

``rnb_tpu_torch.parse_utils`` (``parse_meta``, the request frames of
``get_data``/``get_data_from_all_logs``, ``decompose_latency``,
``dispatch_batch_sizes``, ``attribute_job``, ``--explain``, ``--stamps``),
``rnb_tpu_torch.tools.rnb_diff`` and ``rnb_tpu_torch.tools.latency_summary``
against ``scripts/parse_utils.py``, ``scripts/rnb_diff.py`` and
``scripts/latency_summary.py`` (imported through ``sys.path``, as
``tests/test_scripts.py`` does) on the same inputs: seeded samples, the
committed JAX-written pair ``logs/pr12-dct-ab/{dct,yuv420}``, synthetic
jobs written by the JAX package's ``TimeCardSummary`` (a two-stage and a
three-stage schema, merged segment cards) and two job directories the
port writes on the CPU from a narrowed copy of ``rnb-fused-yuv``
(``tests/torch_config_copies.py``) with critpath, trace, metrics and
whatif on, arm B adding a 5 ms latency fault at the runner step. Deltas,
CIs, component means and explanations agree within 1e-9 (most exactly);
then the three legs of ``tools/explain.py`` on the CPU.
"""

import io
import json
import math
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(REPO, "scripts") not in sys.path:
    sys.path.insert(0, os.path.join(REPO, "scripts"))

import latency_summary as ref_summary  # noqa: E402
import pandas as pd  # noqa: E402
import parse_utils as ref_pu  # noqa: E402
import rnb_diff as ref_diff  # noqa: E402
from rnb_tpu import telemetry as jax_telemetry  # noqa: E402
from rnb_tpu_torch import parse_utils  # noqa: E402
from rnb_tpu_torch.benchmark import run_benchmark  # noqa: E402
from rnb_tpu_torch.tools import explain, latency_summary, rnb_diff  # noqa
from torch_config_copies import narrowed  # noqa: E402

TOL = 1e-9
PR12 = os.path.join(REPO, "logs", "pr12-dct-ab")
PAIR = (os.path.join(PR12, "yuv420"), os.path.join(PR12, "dct"))
#: the port-written arms: a light Poisson rate, same seed
PORT_MI, PORT_VIDEOS, PORT_SEED = 100, 30, 7


# -- inputs -----------------------------------------------------------------

STAMPS = ("enqueue_filename", "runner0_start", "inference0_start",
          "inference0_finish", "runner1_start", "inference1_start",
          "inference1_finish")


def _write_job(log_base, job_id, keys, requests, mi, seed, fuse=1,
               args="namespace", last_ms=0.0, ledgers=True):
    """A job directory through the JAX package's writers: seeded stamps
    (requests fused ``fuse`` to a dispatch share their last finish, which
    ``last_ms`` delays; ``ledgers``: a fault and a cache line)."""
    rng = np.random.default_rng(seed)
    summary = jax_telemetry.TimeCardSummary()
    t = 1000.0
    for req in range(requests):
        card = jax_telemetry.TimeCard(req)
        at = t + req * 0.01 + np.cumsum(rng.exponential(0.004, len(keys)))
        card.timings.update(zip(keys, at.tolist()))
        card.timings[keys[-1]] = t + 0.5 + (req // fuse) * 0.02 \
            + last_ms / 1e3
        for step in range(sum(k.startswith("runner") for k in keys)):
            card.add_device("cpu%d" % step)
        summary.register(card)
    path = jax_telemetry.logname(job_id, "cpu1", 0, 0, base=log_base)
    with open(path, "w") as f:
        summary.save_full_report(f)
    with open(os.path.join(log_base, job_id, "log-meta.txt"), "w") as f:
        if args == "namespace":
            f.write("Args: Namespace(mean_interval_ms=%d, batch_size=1, "
                    "videos=%d, queue_size=500, config_file_path='x.json')\n"
                    % (mi, requests))
        else:
            f.write("Args: %s\n" % json.dumps(dict(
                config="x.json", mean_interval_ms=mi, num_videos=requests,
                queue_size=500, seed=seed, platform="cpu")))
        f.write("%f %f\n" % (t, t + 2.0))
        f.write("Termination flag: 0\n")
        if ledgers:
            f.write("Faults: num_failed=0 num_shed=1 num_retries=2\n")
            f.write("Cache: hits=3 misses=4 inserts=4 evictions=0 "
                    "coalesced=0 oversize=0 bytes_resident=9\n")
        f.write("Device: {\"name\": \"cpu\", \"platform\": \"cpu\"}\n")
        f.write("Pixel path: yuv420\n")
    return os.path.join(log_base, job_id)


def _merged_job(log_base, job_id, seed):
    """Three-segment cards merged by the JAX package's TimeCard (suffixed
    post-fork stamps), the aggregator's finish unsuffixed."""
    rng = np.random.default_rng(seed)
    summary = jax_telemetry.TimeCardSummary()
    for req in range(6):
        card = jax_telemetry.TimeCard(req)
        t = 2000.0 + req
        for key in STAMPS[:4]:
            t += float(rng.exponential(0.003))
            card.record(key, at=t)
        kids = [card.fork(i) for i in range(3)]
        for kid in kids:
            s = t
            for key in ("runner1_start", "inference1_start",
                        "inference1_finish"):
                s += float(rng.exponential(0.005))
                kid.record(key, at=s)
        merged = jax_telemetry.TimeCard.merge(kids)
        merged.record("runner2_start", at=t + 0.2)
        merged.record("inference2_start", at=t + 0.21)
        merged.record("inference2_finish", at=t + 0.25)
        summary.register(merged)
    path = jax_telemetry.logname(job_id, "cpu0", 0, 0, base=log_base)
    with open(path, "w") as f:
        summary.save_full_report(f)
    with open(os.path.join(log_base, job_id, "log-meta.txt"), "w") as f:
        f.write("Args: Namespace(mean_interval_ms=0, batch_size=1, "
                "videos=6, queue_size=500, config_file_path='s.json')\n")
        f.write("2000.0 2010.0\nTermination flag: 0\n")
    return os.path.join(log_base, job_id)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """A log base of four jobs of three schemas: {name: job dir}."""
    base = str(tmp_path_factory.mktemp("synthetic"))
    deeper = STAMPS + ("runner2_start", "inference2_start",
                       "inference2_finish")
    jobs = {
        "two-stage": _write_job(base, "two-stage", STAMPS, 12, 90, 1),
        "fused": _write_job(base, "fused", STAMPS, 14, 6, 2, fuse=3),
        "three-stage": _write_job(base, "three-stage", deeper, 9, 0, 3),
        "merged": _merged_job(base, "merged", 4),
    }
    # the port's Args form, in a log base of its own
    jobs["json-args"] = _write_job(
        str(tmp_path_factory.mktemp("json-args")), "json-args", deeper, 9,
        0, 3, args="json")
    return base, jobs


@pytest.fixture(scope="module")
def port_jobs(tmp_path_factory):
    """Arms A and B of a narrowed ``rnb-fused-yuv`` copy served by the
    port on the CPU: {"a": job dir, "b": job dir, "base": log base,
    "step": the runner step}."""
    out = str(tmp_path_factory.mktemp("port-jobs"))
    path = narrowed("rnb-fused-yuv", out)
    with open(path) as f:
        raw = json.load(f)
    raw.update(trace={"enabled": True, "sample_hz": 20},
               critpath={"enabled": True},
               metrics={"enabled": True, "interval_ms": 100},
               whatif={"enabled": True})
    with open(path, "w") as f:
        json.dump(raw, f)
    path_a, path_b, step = explain.attribution_copies(out, config=path)
    base = os.path.join(out, "logs")
    jobs = {"base": base, "step": step}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("RNB_TPU_DATA_ROOT", raising=False)
        mp.delenv("RNB_FAULT_PLAN", raising=False)
        for arm, config in (("a", path_a), ("b", path_b)):
            result = run_benchmark(config, mean_interval_ms=PORT_MI,
                                   num_videos=PORT_VIDEOS, log_base=base,
                                   print_progress=False, seed=PORT_SEED,
                                   platform="cpu")
            assert result.termination_flag == 0
            jobs[arm] = result.log_dir
    return jobs


def _job(which, synthetic, port_jobs):
    if which.startswith("pr12-"):
        return os.path.join(PR12, which[len("pr12-"):])
    if which.startswith("port-"):
        return port_jobs[which[len("port-"):]]
    return synthetic[1][which]


JOBS = ("pr12-dct", "pr12-yuv420", "two-stage", "fused", "three-stage",
        "merged", "port-a", "port-b")
#: the synthetic jobs all in one log base
SYNTHETIC = ("two-stage", "fused", "three-stage", "merged")


# -- parse_meta and the request frames ----------------------------------------

@pytest.mark.parametrize("which", ["pr12-dct", "two-stage", "merged"])
def test_parse_meta_equals_the_reference_s(which, synthetic, port_jobs):
    job = _job(which, synthetic, port_jobs)
    assert parse_utils.parse_meta(job) == ref_pu.parse_meta(job)


def test_the_port_s_json_args_read_under_the_reference_s_names(synthetic):
    meta = parse_utils.parse_meta(synthetic[1]["json-args"])
    assert (meta["mean_interval_ms"], meta["videos"], meta["queue_size"],
            meta["batch_size"], meta["config_file_path"]) == \
        (0, 9, 500, 1, "x.json")
    assert meta["num_shed"] == 1 and meta["cache_hits"] == 3
    assert meta["throughput_vps"] == pytest.approx(9 / 2.0)


def test_a_port_job_s_meta_carries_its_run(port_jobs):
    meta = parse_utils.parse_meta(port_jobs["a"])
    assert meta["mean_interval_ms"] == PORT_MI
    assert meta["videos"] == PORT_VIDEOS and meta["termination_flag"] == 0
    assert meta["critpath_requests"] > 0 and meta["whatif_calibrated"] == 1


def _assert_frame_equal(ours, theirs):
    """A port frame against a reference DataFrame: the same columns in
    the same order and the same values (NaN where the reference has
    NaN or None)."""
    assert list(ours) == list(theirs.columns)
    for col in theirs.columns:
        want = theirs[col].to_numpy()
        got = ours[col]
        assert len(got) == len(want), col
        if got.dtype == object or want.dtype == object:
            assert [None if (isinstance(v, float) and math.isnan(v))
                    else v for v in got] == \
                [None if (isinstance(v, float) and math.isnan(v))
                 else v for v in want], col
        else:
            np.testing.assert_allclose(got.astype(float),
                                       want.astype(float), rtol=0,
                                       atol=TOL, equal_nan=True)


def _drop_unread(ours, theirs):
    """The reference cannot read the port's JSON ``Args:`` line: its frame
    lacks the job's columns, and the rest must agree."""
    for key in parse_utils.JOB_COLUMNS:
        if key not in theirs.columns:
            ours.pop(key)


@pytest.mark.parametrize("which", JOBS + ("json-args",))
def test_the_request_frame_is_the_reference_s(which, synthetic, port_jobs):
    job = _job(which, synthetic, port_jobs)
    _meta, ours = parse_utils.get_data(job)
    _ref_meta, theirs = ref_pu.get_data(job)
    _drop_unread(ours, theirs)
    _assert_frame_equal(ours, theirs)


def test_every_job_of_a_log_base_unions_as_the_reference_s(synthetic):
    base, jobs = synthetic
    metas, ours = parse_utils.get_data_from_all_logs(base)
    ref_jobs, theirs = ref_pu.get_data_from_all_logs(base)
    assert [m["job_id"] for m in metas] == list(ref_jobs["job_id"])
    _assert_frame_equal(ours, theirs)
    assert parse_utils.get_data_from_all_logs(base, recursive=True)[0] \
        == metas


# -- decompose_latency, dispatch_batch_sizes, the summary ---------------------

@pytest.mark.parametrize("which", JOBS + ("json-args", "all-synthetic"))
def test_decompose_latency_equals_the_reference_s(which, synthetic,
                                                  port_jobs):
    if which == "all-synthetic":
        _m, ours = parse_utils.get_data_from_all_logs(synthetic[0])
        _j, theirs = ref_pu.get_data_from_all_logs(synthetic[0])
    else:
        job = _job(which, synthetic, port_jobs)
        ours, theirs = parse_utils.get_data(job)[1], ref_pu.get_data(job)[1]
        _drop_unread(ours, theirs)
    _assert_frame_equal(parse_utils.decompose_latency(ours),
                        ref_pu.decompose_latency(theirs))


@pytest.mark.parametrize("which", JOBS)
def test_dispatch_batch_sizes_equal_the_reference_s(which, synthetic,
                                                    port_jobs):
    job = _job(which, synthetic, port_jobs)
    ours, theirs = parse_utils.get_data(job)[1], ref_pu.get_data(job)[1]
    assert parse_utils.dispatch_batch_sizes(ours) == \
        ref_pu.dispatch_batch_sizes(theirs).to_dict()
    for step in (0, 1, 7):
        try:
            want = ref_pu.dispatch_batch_sizes(theirs, step=step).to_dict()
        except ValueError:
            with pytest.raises(ValueError):
                parse_utils.dispatch_batch_sizes(ours, step=step)
            continue
        assert parse_utils.dispatch_batch_sizes(ours, step=step) == want


def test_a_fused_job_recovers_its_dispatch_sizes(synthetic):
    _meta, frame = parse_utils.get_data(synthetic[1]["fused"])
    assert parse_utils.dispatch_batch_sizes(frame) == {2: 1, 3: 4}


def _assert_summary_rows(rows, grouped):
    assert [(r["job_id"], r["mean_interval_ms"]) for r in rows] == \
        list(zip(grouped["job_id"], grouped["mean_interval_ms"]))
    for row, (_i, ref_row) in zip(rows, grouped.iterrows()):
        for col, value in row["components"].items():
            want = ref_row[col]
            assert (math.isnan(value) and pd.isna(want)) or \
                abs(value - want) <= TOL, (row["job_id"], col)


@pytest.mark.parametrize("base", ["pr12", "synthetic"])
def test_the_summary_means_equal_the_reference_s(base, synthetic):
    log_base = PR12 if base == "pr12" else synthetic[0]
    _jobs, rows, components = latency_summary.summarize([log_base])
    _ref_jobs, grouped, _requests = ref_summary.summarize(log_base)
    assert components == [c for c in grouped.columns
                          if c not in ("job_id", "mean_interval_ms")]
    _assert_summary_rows(rows, grouped)


def test_the_summary_of_port_jobs_equals_the_reference_s_rule(port_jobs):
    """The reference's summary groups by the mean interval its reader
    cannot take from the port's JSON Args: its rule is applied to its own
    frame with that column added."""
    _jobs, rows, components = latency_summary.summarize(
        [port_jobs["base"]])
    frames = []
    for job in sorted((port_jobs["a"], port_jobs["b"])):
        _meta, df = ref_pu.get_data(job)
        df["mean_interval_ms"] = PORT_MI
        frames.append(df)
    requests = ref_pu.decompose_latency(pd.concat(frames,
                                                  ignore_index=True))
    cols = [c for c in requests.columns
            if c.startswith("gap:") or c in latency_summary.COMPONENTS]
    grouped = requests.groupby(["job_id", "mean_interval_ms"],
                               as_index=False)[cols].mean()
    assert components == cols and len(rows) == 2
    _assert_summary_rows(rows, grouped)
    for row in rows:
        sub = requests[requests["job_id"] == row["job_id"]]
        assert row["dispatch_batch_sizes"] == \
            ref_pu.dispatch_batch_sizes(sub).to_dict()


def test_the_summary_cli_prints_and_writes_the_numbers(synthetic, tmp_path,
                                                       capsys):
    out = str(tmp_path / "summary.json")
    assert latency_summary.main(["--log-base", synthetic[0],
                                 "--json", out]) == 0
    text = capsys.readouterr().out
    assert ref_summary.main(["--log-base", synthetic[0]]) == 0
    ref_text = capsys.readouterr().out
    totals = [ln for ln in text.splitlines() if "end-to-end mean" in ln]
    assert totals == [ln for ln in ref_text.splitlines()
                      if "end-to-end mean" in ln]
    assert all("nan" not in ln.lower() for ln in totals)
    assert len(totals) == len(SYNTHETIC)
    with open(out) as f:
        written = json.load(f)
    _jobs, rows, _components = latency_summary.summarize([synthetic[0]])
    assert [r["total_ms"] for r in written["rows"]] == \
        [r["total_ms"] for r in rows]


@pytest.mark.parametrize("layout", ["empty", "meta-only"])
def test_the_summary_of_nothing_exits_1(layout, tmp_path):
    if layout == "meta-only":
        job = tmp_path / "job"
        job.mkdir()
        (job / "log-meta.txt").write_text("Termination flag: 0\n")
    out = str(tmp_path / "s.json")
    assert latency_summary.main(["--log-base", str(tmp_path),
                                 "--json", out]) == 1
    assert ref_summary.main(["--log-base", str(tmp_path)]) == 1
    assert not os.path.exists(out)


# -- phase attribution and rnb_diff ---------------------------------------------

@pytest.mark.parametrize("which", ["pr12-dct", "two-stage", "merged",
                                   "port-a"])
def test_attribute_job_equals_the_reference_s(which, synthetic, port_jobs):
    job = _job(which, synthetic, port_jobs)
    for skips in (0, 3, None):
        assert parse_utils.attribute_job(job, skips) == \
            ref_pu.attribute_job(job, skips)
    path = parse_utils.timing_tables(job)[0]
    assert parse_utils.table_phase_samples(path, 2) == \
        ref_pu.table_phase_samples(path, 2)


@pytest.mark.parametrize("case", ["paired", "unpaired", "a-empty",
                                  "both-empty", "ci-90", "one-sample"])
def test_bootstrap_delta_is_the_reference_s(case):
    rng = np.random.default_rng(11)
    a = (rng.exponential(5.0, 40) + 1.0).tolist()
    b = (np.asarray(a) + rng.normal(0.5, 1.0, 40)).tolist()
    kwargs = dict(seed=20260804, n_boot=500)
    if case == "unpaired":
        b = b[:31]
    elif case == "a-empty":
        a = []
    elif case == "both-empty":
        a, b = [], []
    elif case == "ci-90":
        kwargs["ci"] = 90.0
    elif case == "one-sample":
        a, b = a[:1], b[:1]
    assert rnb_diff.bootstrap_delta(a, b, **kwargs) == \
        ref_diff.bootstrap_delta(a, b, **kwargs)


def _assert_reports_equal(ours, theirs, same_context=True):
    for key in ("ranking", "queue", "top", "verdict", "paired"):
        assert ours[key] == theirs[key], key
    assert set(ours["phases"]) == set(theirs["phases"])
    for phase, want in list(theirs["phases"].items()) + [
            ("e2e", theirs["e2e"])]:
        got = ours["e2e"] if phase == "e2e" else ours["phases"][phase]
        assert set(got) == set(want)
        for key, value in want.items():
            if isinstance(value, float):
                assert abs(got[key] - value) <= TOL, (phase, key)
            else:
                assert got[key] == value, (phase, key)
    if same_context:
        assert ours["context"] == theirs["context"]
        assert rnb_diff.report_lines(ours) == ref_diff.report_lines(theirs)


@pytest.mark.parametrize("pair,skips", [
    (("pr12-yuv420", "pr12-dct"), 0), (("pr12-dct", "pr12-yuv420"), 0),
    (("pr12-yuv420", "pr12-dct"), 2), (("two-stage", "three-stage"), 0),
    (("fused", "merged"), 1),
    (("port-a", "port-b"), 0), (("port-b", "port-a"), 3)])
def test_diff_jobs_is_the_reference_s(pair, skips, synthetic, port_jobs):
    a, b = (_job(w, synthetic, port_jobs) for w in pair)
    ours = rnb_diff.diff_jobs(a, b, num_skips=skips, n_boot=1000)
    theirs = ref_diff.diff_jobs(a, b, num_skips=skips, n_boot=1000)
    # the reference reads no context from the port's JSON Args
    _assert_reports_equal(ours, theirs,
                          same_context=not pair[0].startswith("port-"))


def test_the_committed_pair_names_decode(capsys):
    assert rnb_diff.main(list(PAIR)) == 0
    assert ref_diff.main(list(PAIR)) == 0
    ours, theirs = capsys.readouterr().out.split("rnb_diff: ")[1:]
    assert ours == theirs
    assert "verdict: decode -4.90 ms/req" in ours


def test_an_unreadable_job_exits_2(tmp_path, capsys):
    assert rnb_diff.main([str(tmp_path / "missing"), PAIR[0]]) == 2
    (tmp_path / "job").mkdir()
    (tmp_path / "job" / "log-meta.txt").write_text("Termination flag: 0\n")
    assert rnb_diff.main([str(tmp_path / "job"), PAIR[0]]) == 2
    assert ref_diff.main([str(tmp_path / "job"), PAIR[0]]) == 2
    assert "cannot diff" in capsys.readouterr().out


# -- --explain and --stamps -----------------------------------------------------

@pytest.mark.parametrize("which", ["pr12-dct", "pr12-yuv420", "two-stage",
                                   "merged", "port-a", "port-b"])
def test_explain_prints_the_reference_s_numbers(which, synthetic, port_jobs):
    job = _job(which, synthetic, port_jobs)
    ours, theirs = io.StringIO(), io.StringIO()
    assert parse_utils.print_explanation(job, ours) == \
        ref_pu.print_explanation(job, theirs)
    assert ours.getvalue() == theirs.getvalue()
    if which.startswith("port-"):
        assert "what-if (calibrated" in ours.getvalue()


@pytest.mark.parametrize("layout,code", [("empty", 1), ("short", 0)])
def test_explain_exit_codes_are_the_reference_s(layout, code, tmp_path,
                                                capsys):
    job = tmp_path / "job"
    job.mkdir()
    (job / "log-meta.txt").write_text("Termination flag: 0\n")
    if layout == "short":
        _write_job(str(tmp_path), "job", STAMPS, 3, 0, 5)
    assert parse_utils.main(["--explain", str(job)]) == code
    assert ref_pu.main(["--explain", str(job)]) == code
    out = capsys.readouterr().out
    assert ("no completed request decomposes" in out) == (code == 1)


def test_explain_and_check_compose(port_jobs, capsys):
    assert parse_utils.main(["--explain", "--check", port_jobs["a"]]) == 0
    out = capsys.readouterr().out
    assert "blocking-chain attribution" in out and '"log_dir"' in out


def _sections(text):
    """{section heading: the first word of each entry (every word of the
    content stamps' one line)}."""
    out = {}
    for block in text.split("\n\n"):
        lines = block.splitlines()
        heads = [ln for ln in lines if ln.startswith("## ")]
        if heads:
            entries = [ln for ln in lines if not ln.startswith("#")]
            out[heads[0]] = [w for ln in entries for w in (
                ln.split() if "Content" in heads[0] else ln.split()[:1])]
    return out


def test_stamps_print_the_port_s_registries_in_the_reference_s_layout(
        capsys):
    from rnb_tpu_torch.memledger import MEM_OWNER_REGISTRY
    from rnb_tpu_torch import telemetry
    assert parse_utils.main(["--stamps"]) == 0
    ours = capsys.readouterr().out
    ref_pu.print_stamp_registry()
    theirs = capsys.readouterr().out
    mine, ref = _sections(ours), _sections(theirs)
    assert [h.replace("rnb_tpu_torch", "rnb_tpu") for h in mine] == list(ref)
    registries = [
        [s.pattern for s in telemetry.STAMP_REGISTRY],
        list(telemetry.CONTENT_STAMPS),
        [s.pattern.split()[0] for s in telemetry.META_LINE_REGISTRY],
        [s.pattern for s in telemetry.TABLE_TRAILER_REGISTRY],
        [s.pattern for s in telemetry.TRACE_EVENT_REGISTRY],
        [s.pattern for s in telemetry.METRIC_REGISTRY],
        [s.name for s in MEM_OWNER_REGISTRY]]
    assert list(mine.values()) == registries
    # a series both packages declare is printed with the same kind and
    # source
    ref_metrics = {ln.split()[0]: ln.split()[1:3] for ln in
                   theirs.split("## Live-metric")[1].split("\n\n")[0]
                   .splitlines() if not ln.startswith("#")}
    shared = [s for s in telemetry.METRIC_REGISTRY
              if s.pattern in ref_metrics]
    assert len(shared) > 90
    for spec in shared:
        assert [spec.kind, spec.source] == ref_metrics[spec.pattern]


# -- the three legs of tools/explain.py on the CPU ---------------------------

def test_leg_1_explains_a_critpath_job(port_jobs):
    failures, leg = explain.leg_critpath(port_jobs["a"], io.StringIO())
    assert failures == []
    assert leg["explain_rc"] == 0 and leg["worst_residual_ms"] <= 1e-3


@pytest.fixture(scope="module")
def known_pair(tmp_path_factory):
    """Two same-seed jobs, B's runner service 5 ms longer on every
    request: the answer leg 3 must find (a served pair on the CPU is
    too noisy to hold to a 2.5-10 ms window; the card run holds it)."""
    base = str(tmp_path_factory.mktemp("known-pair"))
    return tuple(_write_job(base, arm, STAMPS, 40, 20, 9, fuse=2,
                            args="json", last_ms=ms, ledgers=False)
                 for arm, ms in (("a", 0), ("b", 5)))


def test_leg_3_names_the_injected_phase(known_pair):
    failures, report = explain.leg_attribution(*known_pair, "inference1")
    assert failures == []
    assert report["top"] == "inference1"
    assert report["phases"]["inference1"]["delta_ms"] == pytest.approx(5.0)


@pytest.mark.parametrize("case", ["another-phase", "self-diff",
                                  "out-of-range"])
def test_leg_3_fails_where_the_answer_is_not_found(case, known_pair):
    a, b = known_pair
    if case == "another-phase":
        failures, _r = explain.leg_attribution(a, b, "decode")
        assert any("names 'inference1'" in f for f in failures)
    elif case == "self-diff":
        failures, _r = explain.leg_attribution(a, a, "inference1")
        assert any("names None" in f for f in failures)
    else:
        failures, _r = explain.leg_attribution(a, b, "inference1",
                                               delta_range=(6.0, 10.0))
        assert any("outside [6, 10]" in f for f in failures)


def test_leg_3_runs_on_a_served_pair(port_jobs):
    """The leg over the port-written arms: the report is the reference's
    (above), and the self-diff of arm A finds nothing."""
    failures, report = explain.leg_attribution(
        port_jobs["a"], port_jobs["b"], "inference%d" % port_jobs["step"],
        delta_range=(-math.inf, math.inf))
    assert not any("self-diff" in f or "--check" in f for f in failures)
    assert "inference1" in report["ranking"]


@pytest.fixture(scope="module")
def r1_job(tmp_path_factory):
    """The r1 whatif copy of the scale-out pair served on the CPU, its
    emulated step-1 service cut to 100 ms: its job directory. Whether
    the model predicts the r4 copy's measured ratio is a question for
    the card (the smoke's leg 2): on a shared CPU the host part of the
    service, which the model counts as one serial resource, swings with
    the load."""
    out = str(tmp_path_factory.mktemp("scaleout"))
    path = explain.whatif_copy(out)
    with open(path) as f:
        raw = json.load(f)
    raw["fault_plan"]["faults"][0]["ms"] = 100
    with open(path, "w") as f:
        json.dump(raw, f)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("RNB_TPU_DATA_ROOT", raising=False)
        mp.delenv("RNB_FAULT_PLAN", raising=False)
        result = run_benchmark(
            path, mean_interval_ms=0, num_videos=6,
            queue_size=explain.LANES_QUEUE,
            log_base=os.path.join(out, "logs"), print_progress=False,
            seed=explain.LANES_SEED, platform="cpu")
    assert result.termination_flag == 0
    return result


def _predicted(job):
    from rnb_tpu_torch import whatif
    return whatif.calibrate_job(job).query(
        explain.REPLICAS_QUERY)["vps_ratio"]


@pytest.mark.parametrize("factor", [0.85, 1.0, 1.2])
def test_leg_2_holds_a_measured_ratio_within_25_percent(factor, r1_job):
    pred = _predicted(r1_job.log_dir)
    failures, leg = explain.leg_whatif(r1_job.log_dir, 2.0,
                                       2.0 * pred * factor)
    assert failures == [], leg
    assert leg["pred_ratio"] == pred
    assert leg["rel_err"] == pytest.approx(abs(1 - 1 / factor))


@pytest.mark.parametrize("factor", [0.7, 1.5])
def test_leg_2_fails_outside_25_percent(factor, r1_job):
    pred = _predicted(r1_job.log_dir)
    failures, _leg = explain.leg_whatif(r1_job.log_dir, 2.0,
                                        2.0 * pred * factor)
    assert len(failures) == 1 and "rel err" in failures[0]


def test_leg_2_fails_on_a_job_that_streamed_no_metrics(port_jobs,
                                                       tmp_path):
    job = tmp_path / "job"
    job.mkdir()
    for name in os.listdir(port_jobs["a"]):
        if name != "metrics.jsonl":
            src = os.path.join(port_jobs["a"], name)
            if os.path.isfile(src):
                (job / name).write_bytes(open(src, "rb").read())
    failures, leg = explain.leg_whatif(str(job), 1.0, 4.0)
    assert any("found nothing to model" in f for f in failures)
    assert leg["pred_ratio"] == 0.0
