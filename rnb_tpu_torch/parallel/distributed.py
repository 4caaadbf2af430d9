"""Multi-process runs: the reference's API, in single-process mode.

Counterpart of ``rnb_tpu/parallel/distributed.py``, which initializes
``jax.distributed`` from three environment variables so that one
controller process a host joins the collectives of a global mesh:

  RNB_TPU_COORDINATOR   "host:port" of process 0
  RNB_TPU_NUM_PROCESSES total process count
  RNB_TPU_PROCESS_ID    this process's index

The port has no mesh across processes yet (its reduce over cards waits
for NCCL, ROADMAP.md queue 1 item 5), so a process group would have no
user, and processes launched with the variables would each run the
whole benchmark on their own. :func:`maybe_initialize` keeps the
reference's contract where it returns: ``False`` with none of the
variables set, the reference's error for a partial environment; a
launch with a coordinator raises "not yet ported". So every process is
the only one: :func:`process_count` is 1, :func:`process_index` 0, and
:func:`global_mesh` spans this process's cards.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

from rnb_tpu_torch.parallel.mesh import Mesh, build_mesh, visible_devices

ENV = ("RNB_TPU_COORDINATOR", "RNB_TPU_NUM_PROCESSES", "RNB_TPU_PROCESS_ID")


def maybe_initialize(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """``False`` in single-process mode (no coordinator, no process
    count, no process index, from the arguments or the variables, read
    as the reference reads them); raise otherwise: the reference's error
    for a partial environment, "not yet ported" for a launch."""
    coordinator = coordinator or os.environ.get("RNB_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("RNB_TPU_NUM_PROCESSES", "0")) \
            or None
    if process_id is None:
        pid = os.environ.get("RNB_TPU_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if coordinator is None:
        if num_processes is not None or process_id is not None:
            raise RuntimeError(
                "RNB_TPU_NUM_PROCESSES/RNB_TPU_PROCESS_ID are set but "
                "RNB_TPU_COORDINATOR is not — refusing to fall back to "
                "single-process mode in a partially-configured "
                "multi-host launch")
        return False
    raise NotImplementedError(
        "a multi-process run (RNB_TPU_COORDINATOR=%s) is not yet ported to "
        "rnb_tpu_torch: no mesh spans processes until the NCCL reduce is "
        "(ROADMAP.md, queue 1 item 5); unset %s to run in one process"
        % (coordinator, "/".join(ENV)))


def process_count() -> int:
    """The processes of the run: one, as no launch spans more."""
    return 1


def process_index() -> int:
    """This process's index among :func:`process_count`."""
    return 0


def is_primary() -> bool:
    """True on the process that should write logs / print summaries."""
    return process_index() == 0


def global_mesh(axis_names: Sequence[str] = ("dp", "sp"),
                axes: Optional[Dict[str, int]] = None) -> Mesh:
    """A mesh over every card of every participating process: this
    process's visible cards."""
    return build_mesh(visible_devices(), axes=axes, axis_names=axis_names)
