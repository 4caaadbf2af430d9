"""Multi-process runs: the reference's launch, over a gloo group.

Counterpart of ``rnb_tpu/parallel/distributed.py``, which initializes
``jax.distributed`` from three environment variables so that one
controller process a host joins the collectives of a global mesh:

  RNB_TPU_COORDINATOR   "host:port" of process 0
  RNB_TPU_NUM_PROCESSES total process count
  RNB_TPU_PROCESS_ID    this process's index

:func:`maybe_initialize` reads them as the reference does: ``False``
with none set, the reference's error for a partial environment, and
with a coordinator it joins a ``torch.distributed`` gloo group whose
TCP store process 0 serves at ``host:port`` (the address, the world
size and the rank given, as nothing on the machine names a cluster).
It is idempotent. The group is the control plane only: the ring's peers
exchange their memory handles through its store and meet at its
barriers (:mod:`rnb_tpu_torch.parallel.peers`); on CPU tensors the
ring's plain version sends and receives over it. It never carries
shard bytes that lie on a card: those go through the ring kernel
(``rnb_tpu_torch/ops/handoff_dma.py``).

Each process acts on one member of the global mesh, on the card
``process_index() % torch.cuda.device_count()`` (:func:`local_device`)
unless the caller names a device (the CPU, in the tests), so on a
machine with more cards process ``i`` takes card ``i``.
:func:`shutdown` closes the peers' memory, then the group.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from rnb_tpu_torch.parallel.mesh import (Member, Mesh, build_mesh,
                                         visible_devices)

ENV = ("RNB_TPU_COORDINATOR", "RNB_TPU_NUM_PROCESSES", "RNB_TPU_PROCESS_ID")

#: how long joining the group and a read of its store may wait
JOIN_TIMEOUT_S = 300.0


class Launch(NamedTuple):
    """The group this process joined: its store and its place in it."""
    count: int
    index: int
    store: object


_launch: Optional[Launch] = None


def _join(host: str, port: int, num_processes: int, process_id: int):
    """The TCP store at ``host:port`` (served by process 0) and the
    gloo group over it, each waiting :data:`JOIN_TIMEOUT_S` at most;
    returns the store."""
    import torch.distributed as dist
    timeout = datetime.timedelta(seconds=JOIN_TIMEOUT_S)
    store = dist.TCPStore(host, port, num_processes, process_id == 0,
                          timeout=timeout)
    dist.init_process_group("gloo", store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    return store


def maybe_initialize(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join the launch's gloo group when the multi-process variables (or
    arguments) are set. Returns True when running distributed (after
    joining), False in single-process mode; raises the reference's error
    for a partial environment. Idempotent."""
    global _launch
    if _launch is not None:
        return True
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
    if num_processes is None or process_id is None:
        # jax.distributed reads the two from a cluster's environment
        # (SLURM, a TPU pod); the port has none to read
        raise NotImplementedError(
            "a multi-process run (RNB_TPU_COORDINATOR=%s) without "
            "RNB_TPU_NUM_PROCESSES and RNB_TPU_PROCESS_ID is not yet ported "
            "to rnb_tpu_torch: it finds no cluster to read them from; set "
            "both" % coordinator)
    host, sep, port = coordinator.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError("RNB_TPU_COORDINATOR must be host:port, got %r"
                         % coordinator)
    num_processes, process_id = int(num_processes), int(process_id)
    if not 0 <= process_id < num_processes:
        raise ValueError("process %d of %d: RNB_TPU_PROCESS_ID must lie in "
                         "0..RNB_TPU_NUM_PROCESSES-1"
                         % (process_id, num_processes))
    store = _join(host, int(port), num_processes, process_id)
    _launch = Launch(num_processes, process_id, store)
    return True


def launch() -> Optional[Launch]:
    """The group this process joined, or None in one process."""
    return _launch


def shutdown() -> None:
    """Leave the launch, as every process of it must: close every ring's
    peer memory (handles closed, a barrier, then freed), then destroy
    the group. A no-op in one process."""
    global _launch
    if _launch is None:
        return
    from rnb_tpu_torch.parallel import peers
    try:
        peers.close_all()
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
        _launch = None


def process_count() -> int:
    """The processes of the run (1 without a launch)."""
    return 1 if _launch is None else _launch.count


def process_index() -> int:
    """This process's index among :func:`process_count`."""
    return 0 if _launch is None else _launch.index


def is_primary() -> bool:
    """True on the process that should write logs / print summaries."""
    return process_index() == 0


def local_device(process: Optional[int] = None) -> torch.device:
    """The card process ``process`` (by default this one) acts on:
    ``process % torch.cuda.device_count()``."""
    count = torch.cuda.device_count()
    if count < 1:
        raise RuntimeError("no CUDA card is visible: name a device for "
                           "the launch's members (device=)")
    return torch.device("cuda", (process_index() if process is None
                                 else process) % count)


def global_mesh(axis_names: Sequence[str] = ("dp", "sp"),
                axes: Optional[Dict[str, int]] = None,
                device: Optional[torch.device] = None) -> Mesh:
    """A mesh over every member of every participating process. In one
    process: this process's visible cards. In a launch: one member a
    process, process-major (the reference's ``jax.devices()`` order),
    process ``p``'s on ``device`` where given, else on
    :func:`local_device` ``(p)``."""
    if _launch is None:
        return build_mesh(visible_devices(), axes=axes,
                          axis_names=axis_names)
    members = [Member(p, torch.device(device) if device is not None
                      else local_device(p))
               for p in range(_launch.count)]
    return build_mesh(members, axes=axes, axis_names=axis_names)
