"""argparse value validators for the benchmark CLI.

Counterpart of ``rnb_tpu/arg_utils.py``, the port's own copy, whole:
``-mi`` takes :func:`nonnegative_int`, ``-b``, ``-v`` and ``-qs`` take
:func:`positive_int` (``rnb_tpu_torch.benchmark.main``).
"""

from __future__ import annotations

import argparse


def positive_int(value) -> int:
    ivalue = int(value)
    if ivalue <= 0:
        raise argparse.ArgumentTypeError(
            "%s is not a positive integer" % value)
    return ivalue


def nonnegative_int(value) -> int:
    ivalue = int(value)
    if ivalue < 0:
        raise argparse.ArgumentTypeError(
            "%s is not a non-negative integer" % value)
    return ivalue
