"""The processes of ``tests/test_torch_launch.py``'s served launches.

Each runs as one process of a launch (``rnb_tpu_torch.tools.launch``:
the three ``RNB_TPU_*`` variables set), joins it, serves configs on the
CPU with ``run_benchmark`` (every process the whole config, the mesh
stage's members spanning the processes), saves what it saw with
``torch.save`` and leaves the launch (``distributed.shutdown``):

    python -m torch_launch_children CASE OUT_DIR ARGS_JSON

This module imports no jax.
"""

import json
import os
import sys
import time
import traceback

import torch


def _spied_runs(runs, out_dir):
    """Serve each of ``runs`` (dicts: ``config``, ``videos``, ``seed``,
    ``dtype``), recording for each the result, the outputs sink, and
    what the smoke's ``LogitsSpy`` records: every dispatch's request ids,
    logits and host waits, and the host waits of the stage's
    ``finalize``."""
    from chip_smoke import LogitsSpy
    from rnb_tpu_torch.benchmark import run_benchmark
    from rnb_tpu_torch.models.r2p1d import model
    shared = model.shared_network
    saved = []
    for run in runs:
        dtype = getattr(torch, run.get("dtype", "bfloat16"))
        model.shared_network = (
            lambda *a, **k: shared(*a, **dict(k, dtype=dtype)))
        sink = {}
        t0 = time.monotonic()
        try:
            with LogitsSpy() as spy:
                result = run_benchmark(
                    run["config"], mean_interval_ms=0,
                    num_videos=run["videos"],
                    log_base=os.path.join(out_dir, "logs"),
                    print_progress=False, seed=run.get("seed", 0),
                    platform="cpu", outputs_sink=sink)
        finally:
            model.shared_network = shared
        saved.append(dict(
            dispatches=spy.dispatches, logits=spy.logits,
            finalize_waits=spy.finalize_waits,
            seconds=time.monotonic() - t0,
            flag=int(result.termination_flag),
            completed=result.num_completed, log_dir=result.log_dir,
            compiles=result.compiles,
            sink={rid: (video, value) for rid, (video, value, _)
                  in sink.items()}))
    return saved


def served(rank, n, args):
    """The runs of ``args["runs"]``, then ``args["refused"]``: a config
    this process's ``load_config`` refuses (or not), and ``run_benchmark``
    of it in the processes that refuse it."""
    from rnb_tpu_torch.benchmark import run_benchmark
    from rnb_tpu_torch.config import load_config
    out = {"runs": _spied_runs(args.get("runs", []), args["out"])}
    if "refused" in args:
        try:
            load_config(args["refused"], "cpu")
            out["refused"] = None
        except ValueError as e:
            out["refused"] = str(e)
            try:
                run_benchmark(args["refused"], mean_interval_ms=0,
                              num_videos=1, log_base=os.path.join(
                                  args["out"], "refused"),
                              print_progress=False, platform="cpu")
                out["run_benchmark"] = None
            except ValueError as e:
                out["run_benchmark"] = str(e)
    return out


def diverged(rank, n, args):
    """One run with the ring's waits capped at ``args["cap_s"]``, a fault
    plan in the processes ``args["plan_in"]`` names only; the run must
    fail in every process, within the cap."""
    from rnb_tpu_torch.parallel import peers
    peers.set_wait_cap(args["cap_s"])
    if rank in args["plan_in"]:
        os.environ["RNB_FAULT_PLAN"] = json.dumps(args["plan"])
    (run,) = _spied_runs([args["run"]], args["out"])
    return run


CASES = {"served": served, "diverged": diverged}


def main(argv):
    case, out_dir = argv[0], argv[1]
    args = json.loads(argv[2])
    torch.set_num_threads(1)
    from rnb_tpu_torch.parallel import distributed
    assert distributed.maybe_initialize() is True
    rank, n = distributed.process_index(), distributed.process_count()
    try:
        result = CASES[case](rank, n, args)
    except Exception:  # saved for the test, which fails on it
        result = {"error": traceback.format_exc()}
    torch.save(result, os.path.join(out_dir, "result-%d.pt" % rank))
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
