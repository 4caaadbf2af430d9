"""Multi-process runs: refused until a mesh spans processes.

Counterpart of ``rnb_tpu/parallel/distributed.py``, which initializes
``jax.distributed`` from three environment variables so that one
controller process a host joins the collectives of a global mesh:

  RNB_TPU_COORDINATOR   "host:port" of process 0
  RNB_TPU_NUM_PROCESSES total process count
  RNB_TPU_PROCESS_ID    this process's index

The port has no mesh across processes yet (its reduce over cards waits
for NCCL, ROADMAP.md queue 1 item 4), so a process group would have no
user, and processes launched with the variables would each run the
whole benchmark on their own. :func:`check_single_process` refuses such
a launch instead; a partial environment gets the reference's message.
"""

from __future__ import annotations

import os

ENV = ("RNB_TPU_COORDINATOR", "RNB_TPU_NUM_PROCESSES", "RNB_TPU_PROCESS_ID")


def check_single_process() -> None:
    """Return in single-process mode (none of the variables set, as the
    reference reads them); raise otherwise: the reference's error for a
    partial environment, "not yet ported" for a launch."""
    coordinator = os.environ.get("RNB_TPU_COORDINATOR")
    num_processes = int(os.environ.get("RNB_TPU_NUM_PROCESSES", "0")) or None
    process_id = os.environ.get("RNB_TPU_PROCESS_ID")
    if coordinator is None:
        if num_processes is not None or process_id is not None:
            raise RuntimeError(
                "RNB_TPU_NUM_PROCESSES/RNB_TPU_PROCESS_ID are set but "
                "RNB_TPU_COORDINATOR is not — refusing to fall back to "
                "single-process mode in a partially-configured "
                "multi-host launch")
        return
    raise NotImplementedError(
        "a multi-process run (RNB_TPU_COORDINATOR=%s) is not yet ported to "
        "rnb_tpu_torch: no mesh spans processes until the NCCL reduce is "
        "(ROADMAP.md, queue 1 item 4); unset %s to run in one process"
        % (coordinator, "/".join(ENV)))
