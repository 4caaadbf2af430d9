"""The port's multi-device entry points (``rnb_tpu_torch.graft_entry``,
the counterpart of ``__graft_entry__.py``) on the CPU.

``entry`` is checked for the flagship's arguments on the CPU and for its
output's shape on the meta device (no full-width CPU forward: the card
runs that one, in ``chip_smoke.py``). ``dryrun_multichip`` runs the
reference's three parts with every member on the CPU, at 8 and 2
members as ``tests/test_graft_entry.py`` runs the reference's, printing
the reference's ``ok`` lines; its pipeline run's job directory passes
both packages' ``check_job``.
"""

import glob
import os

import pytest
import torch

from rnb_tpu_torch import graft_entry
from torch_job_checks import assert_both_checks_pass

torch.set_num_threads(2)


def test_entry_gives_the_flagship_arguments_on_the_cpu():
    forward, args = graft_entry.entry(device="cpu")
    (x,) = args
    assert callable(forward)
    assert tuple(x.shape) == (15, 8, 112, 112, 3)
    assert x.dtype == torch.bfloat16 and x.device == torch.device("cpu")


def test_entry_s_forward_gives_400_float32_logits_a_clip():
    forward, (x,) = graft_entry.entry(device="meta")
    logits = forward(x)
    assert tuple(logits.shape) == (15, 400)
    assert logits.dtype == torch.float32


def test_the_entry_points_need_a_card_or_an_explicit_device():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)


@pytest.mark.parametrize("n,dp,sp,pipeline", [(8, 4, 2, True),
                                              (2, 2, 1, False)])
def test_dryrun_multichip(n, dp, sp, pipeline, capsys, tmp_path):
    summary = graft_entry.dryrun_multichip(n, device="cpu",
                                           log_base=str(tmp_path))
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == ("dryrun_multichip(%d): ok (dp=%d, sp=%d, pp=True, "
                         "pipeline=%s)" % (n, dp, sp, pipeline))
    assert summary["dp"] == dp and summary["sp"] == sp and summary["pp"]
    jobs = glob.glob(os.path.join(str(tmp_path), "logs", "*", "log-meta.txt"))
    if not pipeline:
        assert summary["pipeline_vps"] is None and not jobs
        return
    assert summary["pipeline_vps"] > 0
    assert lines[-2].startswith("dryrun pipeline-run: ok (videos=7 over "
                                "dp=2 x sp=%d mesh, " % (n // 2))
    assert lines[-2].endswith("videos/s on cpu)")
    (job,) = jobs
    assert_both_checks_pass(os.path.dirname(job))
