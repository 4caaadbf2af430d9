"""Device resolution: config device ids -> ``torch.device``.

Counterpart of ``rnb_tpu/devices.py``. A pipeline config places stage
groups on devices by index: ``d`` is ``cuda:d`` and ``-1`` is the
host CPU. A run on ``platform="cpu"`` (what the tests ask for) maps
every index to the CPU. A CUDA run on a machine with no card raises;
nothing falls back to the CPU on its own.

In a launch of several processes (``rnb_tpu_torch.parallel.
distributed``) an index ``d`` names global member ``d``, one a process,
process-major, as ``distributed.global_mesh`` and the reference's
``jax.devices()`` order them: process ``d`` acts on it (:attr:`DeviceSpec.
owner`), on its card ``distributed.local_device(d)``.

:func:`probe_busy_devices` is the reference's contention probe: a card
on which another process already holds memory when a run starts gets a
warning (never an abort).
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict, List, Optional, Tuple

import torch

from rnb_tpu_torch.parallel import distributed
from rnb_tpu_torch.parallel.mesh import Member

HOST_DEVICE_INDEX = -1
PLATFORMS = ("cuda", "cpu")


class DeviceResolutionError(RuntimeError):
    pass


def resolve_platform(platform: Optional[str]) -> str:
    """``None`` means the card; ``"cpu"`` must be asked for."""
    platform = platform or "cuda"
    if platform not in PLATFORMS:
        raise ValueError("platform must be one of %s, got %r"
                         % (PLATFORMS, platform))
    if platform == "cuda" and not torch.cuda.is_available():
        raise DeviceResolutionError(
            "no CUDA device is available; pass platform='cpu' "
            "(--platform cpu) to run on the CPU")
    return platform


class DeviceSpec:
    """One config device index on one platform, plus a log label."""

    def __init__(self, spec: int, platform: str = "cuda"):
        if not isinstance(spec, int):
            raise DeviceResolutionError(
                "device spec must be an int index (-1 = host), got %r"
                % (spec,))
        self.spec = spec
        self.platform = platform

    @property
    def is_host(self) -> bool:
        return self.spec == HOST_DEVICE_INDEX

    @property
    def owner(self) -> int:
        """The process that acts on this device: this one for the host
        and in one process; in a launch, process ``d`` for index ``d``
        (raises for an index past the launch's members)."""
        count = distributed.process_count()
        if self.is_host or count == 1:
            return distributed.process_index()
        if not 0 <= self.spec < count:
            raise DeviceResolutionError(
                "pipeline configuration names device %d but a launch of %d "
                "processes has %d members, one a process"
                % (self.spec, count, count))
        return self.spec

    def member(self) -> Member:
        """This device as a mesh member: its owner and its device."""
        return Member(self.owner, self.resolve())

    def resolve(self) -> torch.device:
        if self.is_host:
            return torch.device("cpu")
        owner = self.owner  # raises for an index past a launch's members
        if self.platform == "cpu":
            return torch.device("cpu")
        if distributed.process_count() > 1:
            return distributed.local_device(owner)
        count = torch.cuda.device_count()
        if not 0 <= self.spec < count:
            raise DeviceResolutionError(
                "pipeline configuration names device %d but only %d CUDA "
                "device(s) are visible" % (self.spec, count))
        return torch.device("cuda", self.spec)

    @property
    def label(self) -> str:
        """Stable string for TimeCard device trails and log names."""
        if self.is_host:
            return "host"
        return "%s:%d" % (self.platform, self.spec)

    def __repr__(self):
        return "DeviceSpec(%r, %r)" % (self.spec, self.platform)


#: memory another process may hold on a card before the run warns (the
#: reference's threshold; in a pid namespace the probe counts processes
#: instead, see :func:`other_processes`)
BUSY_BYTES_THRESHOLD = 16 * 1024 * 1024
#: seconds an ``nvidia-smi`` reading may take
SMI_TIMEOUT_S = 20


def _smi_rows(query: str, fields: str) -> List[List[str]]:
    """One ``nvidia-smi --query-<query>=<fields>`` reading: a row of
    stripped fields a line (no header, no units). ``nvidia-smi``
    answers one ``--query-*`` switch a call; ``-q -x``, which holds
    both, reads every field of every card and can take seconds."""
    out = subprocess.run(
        ["nvidia-smi", "--query-%s=%s" % (query, fields),
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=SMI_TIMEOUT_S, check=True).stdout
    return [[field.strip() for field in line.split(",")]
            for line in out.splitlines() if line.strip()]


def read_card_memory() -> Dict[int, dict]:
    """Per card index (``nvidia-smi``'s): its UUID, the MiB in use on
    it, and the compute processes on it as ``(pid, MiB)``; two
    readings, the cards' and the compute processes'."""
    cards = {int(index): {"uuid": uuid, "used_mib": float(used),
                          "apps": []}
             for index, uuid, used in _smi_rows("gpu",
                                                "index,uuid,memory.used")}
    by_uuid = {card["uuid"]: card for card in cards.values()}
    for uuid, pid, mib in _smi_rows("compute-apps",
                                    "gpu_uuid,pid,used_memory"):
        if uuid in by_uuid:
            by_uuid[uuid]["apps"].append((int(pid), float(mib)))
    return cards


def other_processes(card: dict, pid: int, own_context: bool
                    ) -> Tuple[int, Optional[float]]:
    """``(count, MiB)`` of the processes other than ``pid`` that hold
    memory on ``card`` (a :func:`read_card_memory` entry). Where the
    listed processes carry host pids, every one but ``pid`` counts with
    its own MiB. In a pid namespace ``nvidia-smi`` names no process by
    this process's pid (it may print one pid for all, each with the
    card's total): then each listed process beyond this one's own
    context (``own_context``) is another, and their MiB is None — not
    separable from this process's own. ``torch.cuda.mem_get_info`` is no
    help either: it counts this process's context, several hundred MiB,
    as used."""
    apps = card["apps"]
    if any(app_pid == pid for app_pid, _ in apps):
        others = [mib for app_pid, mib in apps if app_pid != pid]
        return len(others), sum(others)
    count = max(len(apps) - int(own_context), 0)
    if count and not own_context:
        return count, card["used_mib"]
    return count, None


def probe_busy_devices(specs: List[DeviceSpec]) -> List[str]:
    """Best-effort "device already in use" warnings, one per card that
    another process holds more than ``BUSY_BYTES_THRESHOLD`` on before
    this run allocates. The reference refused to start then; like the
    JAX package, the port warns: a shared card serves slower, not
    wrongly. Host and CPU devices are never probed, and a card that
    cannot be read (no ``nvidia-smi``) is skipped. In a pid namespace
    (``nvidia-smi`` listing no process under this one's pid) no MiB is
    separable from this process's own, so the threshold cannot apply:
    any other process on the card warns."""
    indices = sorted({spec.spec for spec in specs
                      if not spec.is_host and spec.platform == "cuda"})
    if not indices:
        return []
    try:
        cards = read_card_memory()
    except (OSError, ValueError, TypeError, subprocess.SubprocessError):
        return []
    own_context = torch.cuda.is_initialized()
    warnings = []
    for index in indices:
        card = cards.get(index)
        if card is None:
            continue
        count, mib = other_processes(card, os.getpid(), own_context)
        if not count or (mib is not None
                         and mib * 2 ** 20 <= BUSY_BYTES_THRESHOLD):
            continue
        held = ("%.1f MiB" % mib if mib is not None else
                "memory (%.1f MiB in use on the card in all)"
                % card["used_mib"])
        warnings.append(
            "device cuda:%d: %d other process(es) already hold %s before "
            "this job allocated anything — the card is shared; expect "
            "degraded and noisy throughput" % (index, count, held))
    return warnings
