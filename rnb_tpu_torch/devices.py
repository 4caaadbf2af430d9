"""Device resolution: config device ids -> ``torch.device``.

Counterpart of ``rnb_tpu/devices.py``. A pipeline config places stage
groups on devices by index: ``d`` is ``cuda:d`` and ``-1`` is the
host CPU. A run on ``platform="cpu"`` (what the tests ask for) maps
every index to the CPU. A CUDA run on a machine with no card raises;
nothing falls back to the CPU on its own.
"""

from __future__ import annotations

from typing import Optional

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
