"""Device resolution: config device ids -> ``torch.device``.

Counterpart of ``rnb_tpu/devices.py``. A pipeline config places stage
groups on devices by index: ``d`` is ``cuda:d`` and ``-1`` is the
host CPU. A run on ``platform="cpu"`` (what the tests ask for) maps
every index to the CPU. A CUDA run on a machine with no card raises;
nothing falls back to the CPU on its own.

:func:`probe_busy_devices` is the reference's contention probe: a card
on which another process already holds memory when a run starts gets a
warning (never an abort).
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict, List, Optional, Tuple
from xml.etree import ElementTree

import torch

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

    def resolve(self) -> torch.device:
        if self.is_host or self.platform == "cpu":
            return torch.device("cpu")
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
#: seconds the ``nvidia-smi`` reading may take
SMI_TIMEOUT_S = 20


def _smi_xml() -> str:
    """One ``nvidia-smi -q -x`` reading: every card with its memory and
    its processes. ``nvidia-smi`` answers one ``--query-*`` switch a
    call and refuses ``-d`` with ``-x``, so this is the one call that
    holds both."""
    return subprocess.run(
        ["nvidia-smi", "-q", "-x"], capture_output=True, text=True,
        timeout=SMI_TIMEOUT_S, check=True).stdout


def _mib(text: Optional[str]) -> float:
    """``"582 MiB"`` -> 582.0 (ValueError on anything else)."""
    return float((text or "").split(" ")[0])


def read_card_memory() -> Dict[int, dict]:
    """Per card index (``nvidia-smi``'s order): its UUID, the MiB in use
    on it, and the compute processes on it as ``(pid, MiB)``."""
    cards = {}
    for index, gpu in enumerate(ElementTree.fromstring(_smi_xml())
                                .findall("gpu")):
        cards[index] = {
            "uuid": gpu.findtext("uuid"),
            "used_mib": _mib(gpu.findtext("fb_memory_usage/used")),
            "apps": [(int(app.findtext("pid")),
                      _mib(app.findtext("used_memory")))
                     for app in gpu.findall("processes/process_info")
                     if "C" in (app.findtext("type") or "C")]}
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
    except (OSError, ValueError, TypeError, subprocess.SubprocessError,
            ElementTree.ParseError):
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
