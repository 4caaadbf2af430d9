"""Pipeline configuration: the repo's JSON configs, read by the port.

Counterpart of ``rnb_tpu/config.py``. The port reads the same config
files, unchanged: every class path's ``rnb_tpu.`` prefix becomes
``rnb_tpu_torch.``. It accepts exactly the keys of the paths it has
ported and raises a clear "not yet ported" error on any other key — a
key is never silently ignored. Device ``d`` maps to ``cuda:d`` (every
device to the CPU on ``platform="cpu"``) and ``-1`` to the host.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from rnb_tpu_torch.devices import DeviceSpec, resolve_platform

REFERENCE_PREFIX = "rnb_tpu."
PORT_PREFIX = "rnb_tpu_torch."

#: comments are allowed wherever a key is
COMMENT_KEY = "_comment"
ROOT_KEYS = frozenset({"video_path_iterator", "pipeline", "ragged"})
RAGGED_KEYS = frozenset({"enabled", "pool_rows"})
STEP_KEYS = frozenset({"model", "queue_groups", "num_shared_tensors"})
GROUP_KEYS = frozenset({"devices", "out_queues", "in_queue"})
#: model keys per ported stage class (the step's kwargs)
MODEL_KEYS = {
    "R2P1DFusingLoader": frozenset({
        "max_clips", "row_buckets", "fuse", "max_hold_ms", "pixel_path",
        "staging_slots", "transfer_async"}),
    "R2P1DRunner": frozenset({
        "start_index", "end_index", "max_rows", "row_buckets",
        "pixel_path", "ragged_chunk_rows", "layer_sizes", "num_classes"}),
}
#: the one pixel path ported so far
PIXEL_PATHS = ("yuv420",)
#: ring slots per producer when a step omits num_shared_tensors
DEFAULT_NUM_SHARED_TENSORS = 10


class ConfigError(ValueError):
    pass


def _not_ported(what: str) -> ConfigError:
    return ConfigError("%s is not yet ported to rnb_tpu_torch" % what)


def port_class_path(path: str) -> str:
    """``rnb_tpu.x.Y`` -> ``rnb_tpu_torch.x.Y``; other paths as they are
    (the class loader then rejects them)."""
    if not isinstance(path, str):
        raise ConfigError("expected a class-path string, got %r" % (path,))
    if path.startswith(REFERENCE_PREFIX):
        return PORT_PREFIX + path[len(REFERENCE_PREFIX):]
    return path


def _check_keys(raw: dict, allowed, where: str) -> None:
    if not isinstance(raw, dict):
        raise ConfigError("%s must be an object, got %r" % (where, raw))
    for key in raw:
        if key != COMMENT_KEY and key not in allowed:
            raise _not_ported("%s key %r" % (where, key))


@dataclasses.dataclass
class GroupConfig:
    devices: List[DeviceSpec]
    out_queues: List[int]
    in_queue: Optional[int]


@dataclasses.dataclass
class StepConfig:
    model: str
    groups: List[GroupConfig]
    num_shared_tensors: int
    #: the step's model keys, passed to the stage's constructor
    kwargs: Dict[str, Any]


@dataclasses.dataclass
class PipelineConfig:
    video_path_iterator: str
    steps: List[StepConfig]
    ragged: Optional[dict]
    platform: str

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    @property
    def num_runners(self) -> int:
        return sum(len(g.devices) for s in self.steps for g in s.groups)


def parse_config(raw: dict, platform: Optional[str] = None
                 ) -> PipelineConfig:
    """Validate a config dict and build the port's view of it."""
    platform = resolve_platform(platform)
    _check_keys(raw, ROOT_KEYS, "root")
    if "video_path_iterator" not in raw or "pipeline" not in raw:
        raise ConfigError("config needs 'video_path_iterator' and "
                          "'pipeline'")
    ragged = raw.get("ragged")
    if ragged is not None:
        _check_keys(ragged, RAGGED_KEYS, "ragged")
    steps = []
    pipeline = raw["pipeline"]
    if not isinstance(pipeline, list) or not pipeline:
        raise ConfigError("'pipeline' must be a non-empty list of steps")
    for step_idx, step_raw in enumerate(pipeline):
        where = "step %d" % step_idx
        model = port_class_path(step_raw.get("model") if isinstance(
            step_raw, dict) else step_raw)
        class_name = model.rpartition(".")[2]
        if class_name not in MODEL_KEYS:
            raise _not_ported("%s model %r" % (where, step_raw["model"]))
        _check_keys(step_raw, STEP_KEYS | MODEL_KEYS[class_name], where)
        kwargs = {k: v for k, v in step_raw.items()
                  if k in MODEL_KEYS[class_name]}
        pixel_path = kwargs.get("pixel_path", "rgb")
        if pixel_path not in PIXEL_PATHS:
            raise _not_ported("%s pixel_path %r" % (where, pixel_path))
        groups = []
        for group_raw in step_raw.get("queue_groups", ()):
            _check_keys(group_raw, GROUP_KEYS, where + " queue group")
            devices = group_raw.get("devices")
            if not devices:
                raise ConfigError("%s: every queue group needs devices"
                                  % where)
            groups.append(GroupConfig(
                devices=[DeviceSpec(d, platform) for d in devices],
                out_queues=[int(q) for q in group_raw.get("out_queues",
                                                          ())],
                in_queue=group_raw.get("in_queue")))
        if not groups:
            raise ConfigError("%s needs at least one queue group" % where)
        is_final = step_idx == len(pipeline) - 1
        for group in groups:
            if not is_final and not group.out_queues:
                raise ConfigError("%s: a non-final group needs "
                                  "out_queues" % where)
            if step_idx > 0 and group.in_queue is None:
                raise ConfigError("%s: a consumer group needs in_queue"
                                  % where)
        slots = int(step_raw.get("num_shared_tensors",
                                 DEFAULT_NUM_SHARED_TENSORS))
        if slots < 1:
            raise ConfigError("%s: num_shared_tensors must be >= 1" % where)
        steps.append(StepConfig(model=model, groups=groups,
                                num_shared_tensors=slots, kwargs=kwargs))
    return PipelineConfig(
        video_path_iterator=port_class_path(raw["video_path_iterator"]),
        steps=steps, ragged=ragged, platform=platform)


def load_config(path: str, platform: Optional[str] = None
                ) -> PipelineConfig:
    with open(path) as f:
        raw = json.load(f)
    return parse_config(raw, platform)
