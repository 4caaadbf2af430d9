"""Pipeline configuration: the repo's JSON configs, read by the port.

Counterpart of ``rnb_tpu/config.py``. The port reads the same config
files, unchanged: every class path's ``rnb_tpu.`` prefix becomes
``rnb_tpu_torch.``. It accepts exactly the keys of the paths it has
ported and raises a clear "not yet ported" error on any other key — a
key is never silently ignored. A step's model keys may also stand on
one of its queue groups, whose value then wins for that group (the
reference's rule: ``configs/rnb-1chip.json`` gives each ``Batcher``
group its own ``batch``). Device ``d`` maps to ``cuda:d`` (every
device to the CPU on ``platform="cpu"``) and ``-1`` to the host.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from rnb_tpu_torch.devices import DeviceSpec, resolve_platform
from rnb_tpu_torch.selector import DEFAULT_QUEUE_SELECTOR

REFERENCE_PREFIX = "rnb_tpu."
PORT_PREFIX = "rnb_tpu_torch."

#: comments are allowed wherever a key is
COMMENT_KEY = "_comment"
ROOT_KEYS = frozenset({"video_path_iterator", "pipeline", "ragged",
                       "popularity", "pager"})
RAGGED_KEYS = frozenset({"enabled", "pool_rows"})
POPULARITY_KEYS = frozenset({"dist", "s", "universe"})
PAGER_KEYS = frozenset({"enabled", "page_rows", "pool_mb", "feature_cache"})
STEP_KEYS = frozenset({"model", "queue_groups", "num_shared_tensors"})
GROUP_KEYS = frozenset({"devices", "out_queues", "in_queue",
                        "queue_selector"})
_LOADER_KEYS = frozenset({
    "max_clips", "consecutive_frames", "num_clips_population", "weights",
    "num_warmups", "row_buckets", "prefetch", "pixel_path", "cache_mb",
    "dct_coeffs_per_frame"})
_RUNNER_KEYS = frozenset({
    "start_index", "end_index", "max_rows", "consecutive_frames",
    "num_warmups", "row_buckets", "pixel_path", "ragged_chunk_rows",
    "layer_sizes", "num_classes", "dct_coeffs_per_frame"})
#: model keys per ported stage class (the step's kwargs)
MODEL_KEYS = {
    "R2P1DLoader": _LOADER_KEYS,
    "R2P1DFusingLoader": frozenset({
        "max_clips", "row_buckets", "fuse", "max_hold_ms", "pixel_path",
        "staging_slots", "transfer_async", "dct_coeffs_per_frame",
        "cache_mb"}),
    "R2P1DRunner": _RUNNER_KEYS,
    # the single step hands its keys to the embedded loader and runner
    "R2P1DSingleStep": _LOADER_KEYS | frozenset({"layer_sizes",
                                                 "num_classes"}),
    "Batcher": frozenset({
        "batch", "shapes", "max_rows", "consecutive_frames", "frame_hw",
        "row_buckets"}),
}
#: the selectors a group may name (``ReplicaSelector`` waits for
#: replica lanes)
QUEUE_SELECTORS = frozenset({"RoundRobinSelector", "LargeSmallSelector"})
#: the pixel paths ported so far
PIXEL_PATHS = ("rgb", "yuv420", "dct")
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
    #: class path of the selector routing over ``out_queues``
    queue_selector: str = DEFAULT_QUEUE_SELECTOR
    #: model keys given on the group: they override the step's
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StepConfig:
    model: str
    groups: List[GroupConfig]
    num_shared_tensors: int
    #: the step's model keys, passed to the stage's constructor
    kwargs: Dict[str, Any]

    def kwargs_for_group(self, group_idx: int) -> Dict[str, Any]:
        """Constructor kwargs of one group's instances: the step's
        model keys, overridden by the group's."""
        merged = dict(self.kwargs)
        merged.update(self.groups[group_idx].kwargs)
        return merged


@dataclasses.dataclass
class PipelineConfig:
    video_path_iterator: str
    steps: List[StepConfig]
    ragged: Optional[dict]
    platform: str
    #: the request-popularity spec ({"dist": "zipf", "s", "universe"})
    popularity: Optional[dict] = None
    #: the page allocator's settings (root ``pager`` key)
    pager: Optional[dict] = None

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    @property
    def num_runners(self) -> int:
        return sum(len(g.devices) for s in self.steps for g in s.groups)


def _is_number(value) -> bool:
    return isinstance(value, (int, float)) and not isinstance(value, bool)


def _check_popularity(popularity) -> None:
    """The reference's rules (rnb_tpu/config.py, root ``popularity``)."""
    _check_keys(popularity, POPULARITY_KEYS, "popularity")
    if popularity.get("dist", "zipf") != "zipf":
        raise ConfigError("'popularity.dist' must be \"zipf\" (the one "
                          "supported distribution), got %r"
                          % (popularity.get("dist"),))
    s = popularity.get("s", 1.0)
    if not _is_number(s) or s < 0:
        raise ConfigError("'popularity.s' must be a non-negative number, "
                          "got %r" % (s,))
    universe = popularity.get("universe")
    if universe is not None and (not isinstance(universe, int)
                                 or isinstance(universe, bool)
                                 or universe < 1):
        raise ConfigError("'popularity.universe' must be a positive "
                          "integer, got %r" % (universe,))


def _check_pager(pager, ragged) -> None:
    """The reference's rules (rnb_tpu/config.py, root ``pager``),
    including that paged gathers need the ragged pool."""
    _check_keys(pager, PAGER_KEYS, "pager")
    if not isinstance(pager.get("enabled", True), bool):
        raise ConfigError("'pager.enabled' must be a boolean")
    page_rows = pager.get("page_rows")
    if page_rows is not None and (not isinstance(page_rows, int)
                                  or isinstance(page_rows, bool)
                                  or page_rows < 1):
        raise ConfigError("'pager.page_rows' must be a positive integer "
                          "(rows per fixed-size page), got %r"
                          % (page_rows,))
    pool_mb = pager.get("pool_mb")
    if pool_mb is not None and (not _is_number(pool_mb) or pool_mb <= 0):
        raise ConfigError("'pager.pool_mb' must be a positive number, "
                          "got %r" % (pool_mb,))
    if not isinstance(pager.get("feature_cache", False), bool):
        raise ConfigError("'pager.feature_cache' must be a boolean")
    if pager.get("enabled", True) and not (
            isinstance(ragged, dict) and ragged.get("enabled", True)):
        raise ConfigError("'pager' requires 'ragged': paged cache hits "
                          "gather into the ragged row pool at its one "
                          "shape")


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
    popularity = raw.get("popularity")
    if popularity is not None:
        _check_popularity(popularity)
    pager = raw.get("pager")
    if pager is not None:
        _check_pager(pager, ragged)
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
            _check_keys(group_raw, GROUP_KEYS | MODEL_KEYS[class_name],
                        where + " queue group")
            devices = group_raw.get("devices")
            if not devices:
                raise ConfigError("%s: every queue group needs devices"
                                  % where)
            selector = port_class_path(group_raw.get(
                "queue_selector", DEFAULT_QUEUE_SELECTOR))
            if selector.rpartition(".")[2] not in QUEUE_SELECTORS:
                raise _not_ported("%s queue_selector %r"
                                  % (where, group_raw["queue_selector"]))
            group_kwargs = {k: v for k, v in group_raw.items()
                            if k in MODEL_KEYS[class_name]}
            if group_kwargs.get("pixel_path", "rgb") not in PIXEL_PATHS:
                raise _not_ported("%s pixel_path %r"
                                  % (where, group_kwargs["pixel_path"]))
            groups.append(GroupConfig(
                devices=[DeviceSpec(d, platform) for d in devices],
                out_queues=[int(q) for q in group_raw.get("out_queues",
                                                          ())],
                in_queue=group_raw.get("in_queue"),
                queue_selector=selector, kwargs=group_kwargs))
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
            if is_final and group.out_queues:
                raise ConfigError("%s: the last step may not declare "
                                  "out_queues" % where)
        if step_idx > 0:
            # this step's in queues are exactly the previous step's out
            # queues
            fed = {q for g in steps[-1].groups for q in g.out_queues}
            read = {g.in_queue for g in groups}
            if fed != read:
                raise ConfigError(
                    "output queues of step %d %s do not match input "
                    "queues of step %d %s" % (step_idx - 1, sorted(fed),
                                              step_idx, sorted(read)))
        slots = int(step_raw.get("num_shared_tensors",
                                 DEFAULT_NUM_SHARED_TENSORS))
        if slots < 1:
            raise ConfigError("%s: num_shared_tensors must be >= 1" % where)
        steps.append(StepConfig(model=model, groups=groups,
                                num_shared_tensors=slots, kwargs=kwargs))
    return PipelineConfig(
        video_path_iterator=port_class_path(raw["video_path_iterator"]),
        steps=steps, ragged=ragged, platform=platform,
        popularity=popularity, pager=pager)


def load_config(path: str, platform: Optional[str] = None
                ) -> PipelineConfig:
    with open(path) as f:
        raw = json.load(f)
    return parse_config(raw, platform)
