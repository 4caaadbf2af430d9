"""Both packages' whole ``check_job`` on a job directory the port wrote.

The served runs of the port's test files call
:func:`assert_both_checks_pass` beside their own assertions: the
reference's ``scripts/parse_utils.check_job_detail`` reads the directory
as written, no line dropped, and finds no problem and no parse failure;
the port's :func:`rnb_tpu_torch.parse_utils.check_job` finds none either.
"""

import os
import sys

from rnb_tpu_torch.parse_utils import check_job

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(REPO, "scripts") not in sys.path:
    sys.path.insert(0, os.path.join(REPO, "scripts"))
import parse_utils as jax_parse_utils  # noqa: E402


def assert_both_checks_pass(log_dir):
    assert jax_parse_utils.check_job_detail(log_dir) == ([], False)
    assert check_job(log_dir) == []
