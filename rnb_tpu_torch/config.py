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

The reference's rules on ``num_segments`` (a step's fan-out into row
segments), on the root ``trace``, ``metrics``, ``critpath``,
``autotune``, ``devobs``, ``whatif`` and ``operator`` keys, on the
fault-containment root keys (``overload_policy``, ``fault_containment``,
``fault_plan``, ``deadline``), on the network edge's ``netedge`` key and
its lane board's ``health`` key (with the edge's cross-key rules: two or
more steps, no segmented step 0, no ``trace``, no ``ragged``) and on a
step's ``autotune`` opt-out and retry budget
(``max_retries``, ``retry_backoff_ms``) are kept with the reference's own
messages. So is the step-level ``shard`` key (intra-stage sharding,
rnb_tpu_torch.parallel.shardplan): each queue group keeps its first
device, and the ring travels to the runner as ``shard_devices``
(``DeviceSpec`` s), ``shard_degree``, ``shard_axis`` and
``shard_hbm_budget_mb``. A mesh step's (``R2P1DMeshRunner``)
``mesh_devices`` become ``DeviceSpec`` s the same way, and the loader's
``raw_output`` is read with it.

The loaders' ``fallback_decode_threads`` (the numpy/PIL decode pool's
width), ``staging_slots`` and ``transfer_async`` are read with the
reference's type rules and messages; so are a step's ``async_dispatch``
(its executor stamps ``inference{i}_finish`` at dispatch instead of
waiting for the card), a queue group's ``gpus`` (the reference's alias
of ``devices``; ``devices`` wins where both stand) and the root
``lint: {"lock_witness": bool}`` key (the runtime lock-order witness,
:mod:`rnb_tpu_torch.lockwitness`).

Replica lanes (the reference's rules and messages): a step's
``replicas: N`` key, or an apply-mode root ``placement`` plan naming it,
expands the step's one queue group into N lane groups, each with a fresh
lane queue and an equal slice of the device list
(:func:`rnb_tpu_torch.parallel.mesh.carve_replicas`), and rewires the
upstream producers onto the lanes with ``ReplicaSelector`` in place of
the default selector. The step's ``hedge_ms`` and the root ``handoff``
and ``placement`` keys are read with it. Sharding composes
replica-major: each lane's slice becomes its ring.
"""

from __future__ import annotations

import copy
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
                       "popularity", "pager", "trace", "metrics",
                       "critpath", "autotune", "overload_policy",
                       "fault_containment", "fault_plan", "deadline",
                       "devobs", "whatif", "operator", "health",
                       "netedge", "handoff", "placement", "lint"})
TRACE_KEYS = ("enabled", "sample_hz", "max_events")
#: the reference's key lists, in its order (its messages print them)
METRICS_KEYS = ["enabled", "interval_ms", "flight_recorder"]
FLIGHT_RECORDER_KEYS = ["enabled", "ring_events", "max_dumps",
                        "burn_threshold", "shed_spike_per_s",
                        "queue_saturation", "cooldown_s"]
CRITPATH_KEYS = ["enabled"]
WHATIF_KEYS = ["enabled"]
OPERATOR_KEYS = ["enabled", "port", "allow_actions", "sample_hz"]
DEVOBS_KEYS = ["enabled", "capture_window_ms", "capture_on_trigger",
               "max_captures", "capture_max_ops", "watermark_mb",
               "sample_hz"]
DEADLINE_KEYS = ["enabled", "budget_ms"]
HEALTH_KEYS = ["enabled", "suspect_after_ms", "open_after_ms",
               "probe_interval_ms"]
HANDOFF_KEYS = ["enabled", "mode"]
LINT_KEYS = ["lock_witness"]
PLACEMENT_KEYS = ["enabled", "mode", "plan"]
NETEDGE_KEYS = ["enabled", "listen", "connect", "beat_ms", "io_timeout_ms",
                "max_retries", "backoff_ms", "resend_window", "spawn"]
AUTOTUNE_KEYS = ["enabled", "slo_ms", "ewma_alpha", "min_hold_ms",
                 "max_hold_ms", "buckets"]
RAGGED_KEYS = frozenset({"enabled", "pool_rows"})
POPULARITY_KEYS = frozenset({"dist", "s", "universe"})
PAGER_KEYS = frozenset({"enabled", "page_rows", "pool_mb", "feature_cache"})
STEP_KEYS = frozenset({"model", "queue_groups", "num_shared_tensors",
                       "num_segments", "autotune", "max_retries",
                       "retry_backoff_ms", "shard", "replicas",
                       "hedge_ms", "async_dispatch"})
#: keys a step-level 'shard' object may carry, in the reference's order
SHARD_KEYWORDS = ["degree", "axis", "hbm_budget_mb"]
#: the runner's kwargs ``_expand_shard`` puts on each queue group
SHARD_GROUP_KEYS = frozenset({"shard_devices", "shard_degree",
                              "shard_axis", "shard_hbm_budget_mb"})
GROUP_KEYS = frozenset({"devices", "out_queues", "in_queue",
                        "queue_selector"})
_LOADER_KEYS = frozenset({
    "max_clips", "consecutive_frames", "num_clips_population", "weights",
    "num_warmups", "row_buckets", "prefetch", "pixel_path", "cache_mb",
    "dct_coeffs_per_frame", "raw_output", "staging_slots", "transfer_async",
    "fallback_decode_threads"})
_RUNNER_KEYS = frozenset({
    "start_index", "end_index", "max_rows", "consecutive_frames",
    "num_warmups", "row_buckets", "pixel_path", "ragged_chunk_rows",
    "layer_sizes", "num_classes", "dct_coeffs_per_frame",
    "factored_shortcut", "ckpt_path"}) | SHARD_GROUP_KEYS
#: model keys per ported stage class (the step's kwargs)
MODEL_KEYS = {
    "R2P1DLoader": _LOADER_KEYS,
    "R2P1DFusingLoader": frozenset({
        "max_clips", "row_buckets", "fuse", "depth", "max_hold_ms",
        "consecutive_frames", "num_clips_population", "weights",
        "num_warmups",
        "pixel_path", "staging_slots", "transfer_async",
        "dct_coeffs_per_frame", "cache_mb", "fallback_decode_threads",
        # refused by the stage with the reference's message: its window
        # is ``depth``
        "prefetch"}),
    "R2P1DRunner": _RUNNER_KEYS,
    # the single step hands its keys to the embedded loader and runner
    "R2P1DSingleStep": _LOADER_KEYS | frozenset({
        "layer_sizes", "num_classes", "ckpt_path", "factored_shortcut"}),
    "Batcher": frozenset({
        "batch", "shapes", "max_rows", "consecutive_frames", "frame_hw",
        "row_buckets"}),
    "R2P1DAggregator": frozenset({"aggregate"}),
    "R2P1DMeshRunner": frozenset({
        "mesh_devices", "dp", "max_clips", "consecutive_frames",
        "num_classes", "layer_sizes", "num_warmups", "max_inflight",
        "sync_preds", "factored_shortcut", "pixel_path", "ckpt_path"}),
}
#: the selectors a group may name
QUEUE_SELECTORS = frozenset({"RoundRobinSelector", "LargeSmallSelector",
                             "ReplicaSelector"})
#: the selector replica expansion puts on the producers of a replicated
#: step in place of the default (least-loaded routing)
REPLICA_QUEUE_SELECTOR = "rnb_tpu_torch.selector.ReplicaSelector"
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
    #: segments each published item is split into (runner.split_segments)
    num_segments: int = 1
    #: False opts the step out of the root ``autotune`` controller
    autotune: bool = True
    #: the retry budget for transient errors escaping the step's model
    #: call (rnb_tpu_torch.faults): up to ``max_retries`` re-attempts,
    #: ``retry_backoff_ms`` apart; 0 fails on the first transient
    max_retries: int = 0
    retry_backoff_ms: float = 10.0
    #: a replica-expanded step's lane queue indices, in lane order (None
    #: on a step without replica lanes)
    replica_queues: Optional[tuple] = None
    #: the hedge threshold for dispatches into this replica step (a
    #: positive millisecond count or "p95x"); None: no hedging
    hedge_ms: Optional[object] = None
    #: True: the step's executor does not wait for its device work
    #: before the ``inference{i}_finish`` stamp (the reference's
    #: ``sync_outputs=False``)
    async_dispatch: bool = False

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
    #: the tracing settings (root ``trace`` key; rnb_tpu_torch.trace)
    trace: Optional[dict] = None
    #: the live-metrics plane's settings (root ``metrics`` key)
    metrics: Optional[dict] = None
    #: critical-path extraction (root ``critpath`` key)
    critpath: Optional[dict] = None
    #: the device observability plane (root ``devobs`` key;
    #: rnb_tpu_torch.devobs)
    devobs: Optional[dict] = None
    #: the calibrated what-if model at teardown (root ``whatif`` key;
    #: rnb_tpu_torch.whatif)
    whatif: Optional[dict] = None
    #: the operator plane's HTTP server and stack sampler (root
    #: ``operator`` key; rnb_tpu_torch.statusz)
    operator: Optional[dict] = None
    #: the load-adaptive batching controller (root ``autotune`` key)
    autotune: Optional[dict] = None
    #: "abort" (a full queue stops the run) or "shed" (the new request
    #: is dropped, counted, and the run goes on)
    overload_policy: str = "abort"
    #: False keeps the strict semantics: even a classified error aborts
    fault_containment: bool = True
    #: the injection schedule (rnb_tpu_torch.faults.FaultPlan's spec)
    fault_plan: Optional[dict] = None
    #: deadline propagation (root ``deadline`` key; rnb_tpu_torch.health)
    deadline: Optional[dict] = None
    #: the lane health board's thresholds (root ``health`` key;
    #: rnb_tpu_torch.health): read by each replica step's board and the
    #: network edge's
    health: Optional[dict] = None
    #: the network ingest edge (root ``netedge`` key;
    #: rnb_tpu_torch.netedge): when enabled, a peer process serves step 0
    #: over TCP with a local fallback behind a lane health board
    netedge: Optional[dict] = None
    #: the edge contract of every consumer take (root ``handoff`` key;
    #: rnb_tpu_torch.handoff)
    handoff: Optional[dict] = None
    #: the measured-cost planner (root ``placement`` key;
    #: rnb_tpu_torch.placement); an apply-mode plan was expanded into
    #: replica lanes at parse time
    placement: Optional[dict] = None
    #: the runtime arms of the lint analyzers (root ``lint`` key):
    #: ``lock_witness`` true arms rnb_tpu_torch.lockwitness for the run
    lint: Optional[dict] = None
    #: the config dict as read (the devobs config walks read it)
    raw: Optional[dict] = None

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    @property
    def num_runners(self) -> int:
        return sum(len(g.devices) for s in self.steps for g in s.groups)

    def all_devices(self) -> List[DeviceSpec]:
        """Every device the pipeline places work on: each group's, and
        a ring's or a mesh's members."""
        devices = []
        for step in self.steps:
            for group_idx, group in enumerate(step.groups):
                kwargs = step.kwargs_for_group(group_idx)
                devices.extend(group.devices)
                devices.extend(kwargs.get("shard_devices") or ())
                devices.extend(kwargs.get("mesh_devices") or ())
        return devices


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


def _expect(cond: bool, message: str) -> None:
    if not cond:
        raise ConfigError(message)


def _check_trace(trace) -> None:
    """The reference's rules (rnb_tpu/config.py, root ``trace``)."""
    _expect(isinstance(trace, dict), "'trace' must be an object")
    unknown = sorted(set(trace) - set(TRACE_KEYS))
    _expect(not unknown, "'trace' has unknown key(s) %s — keys are %s"
            % (unknown, list(TRACE_KEYS)))
    _expect(isinstance(trace.get("enabled", True), bool),
            "'trace.enabled' must be a boolean")
    sample_hz = trace.get("sample_hz", 20.0)
    _expect(_is_number(sample_hz) and sample_hz >= 0,
            "'trace.sample_hz' must be a non-negative number (0 disables "
            "the occupancy sampler), got %r" % (sample_hz,))
    max_events = trace.get("max_events", 200000)
    _expect(isinstance(max_events, int)
            and not isinstance(max_events, bool) and max_events >= 1,
            "'trace.max_events' must be a positive integer, got %r"
            % (max_events,))


def _is_positive(value) -> bool:
    return _is_number(value) and value > 0


def _check_metrics(metrics) -> None:
    """The reference's rules (rnb_tpu/config.py, root ``metrics``)."""
    _expect(isinstance(metrics, dict), "'metrics' must be an object")
    unknown = sorted(set(metrics) - set(METRICS_KEYS))
    _expect(not unknown, "'metrics' has unknown key(s) %s — keys are %s"
            % (unknown, METRICS_KEYS))
    _expect(isinstance(metrics.get("enabled", True), bool),
            "'metrics.enabled' must be a boolean")
    interval = metrics.get("interval_ms", 250.0)
    _expect(_is_positive(interval),
            "'metrics.interval_ms' must be a positive number, got %r"
            % (interval,))
    fr = metrics.get("flight_recorder")
    if fr is None or isinstance(fr, bool):
        return
    _expect(isinstance(fr, dict),
            "'metrics.flight_recorder' must be a boolean or an object")
    unknown = sorted(set(fr) - set(FLIGHT_RECORDER_KEYS))
    _expect(not unknown, "'metrics.flight_recorder' has unknown key(s) %s "
            "— keys are %s" % (unknown, FLIGHT_RECORDER_KEYS))
    _expect(isinstance(fr.get("enabled", True), bool),
            "'metrics.flight_recorder.enabled' must be a boolean")
    for key in ("ring_events", "max_dumps"):
        val = fr.get(key)
        _expect(val is None or (isinstance(val, int)
                                and not isinstance(val, bool) and val >= 1),
                "'metrics.flight_recorder.%s' must be a positive integer, "
                "got %r" % (key, val))
    for key in ("burn_threshold", "shed_spike_per_s", "cooldown_s"):
        val = fr.get(key)
        _expect(val is None or _is_positive(val),
                "'metrics.flight_recorder.%s' must be a positive number, "
                "got %r" % (key, val))
    sat = fr.get("queue_saturation")
    _expect(sat is None or (_is_number(sat) and 0 < sat <= 1),
            "'metrics.flight_recorder.queue_saturation' must be a "
            "fraction in (0, 1], got %r" % (sat,))


def _check_critpath(critpath) -> None:
    """The reference's rules (rnb_tpu/config.py, root ``critpath``)."""
    _expect(isinstance(critpath, dict), "'critpath' must be an object")
    unknown = sorted(set(critpath) - set(CRITPATH_KEYS))
    _expect(not unknown, "'critpath' has unknown key(s) %s — keys are %s"
            % (unknown, CRITPATH_KEYS))
    _expect(isinstance(critpath.get("enabled", True), bool),
            "'critpath.enabled' must be a boolean")


def _check_whatif(whatif, metrics) -> None:
    """The reference's rules (rnb_tpu/config.py, root ``whatif``): the
    model calibrates from the metrics plane's service histograms."""
    _expect(isinstance(whatif, dict), "'whatif' must be an object")
    unknown = sorted(set(whatif) - set(WHATIF_KEYS))
    _expect(not unknown, "'whatif' has unknown key(s) %s — keys are %s"
            % (unknown, WHATIF_KEYS))
    _expect(isinstance(whatif.get("enabled", True), bool),
            "'whatif.enabled' must be a boolean")
    if whatif.get("enabled", True):
        _expect(isinstance(metrics, dict) and metrics.get("enabled", True),
                "'whatif' requires an enabled root 'metrics' key — the "
                "per-stage service histograms streamed to metrics.jsonl "
                "are the calibration data")


def _check_operator(operator) -> None:
    """The reference's rules (rnb_tpu/config.py, root ``operator``)."""
    _expect(isinstance(operator, dict), "'operator' must be an object")
    unknown = sorted(set(operator) - set(OPERATOR_KEYS))
    _expect(not unknown, "'operator' has unknown key(s) %s — keys are %s"
            % (unknown, OPERATOR_KEYS))
    _expect(isinstance(operator.get("enabled", True), bool),
            "'operator.enabled' must be a boolean")
    _expect(isinstance(operator.get("allow_actions", False), bool),
            "'operator.allow_actions' must be a boolean (false keeps POST "
            "/flight and /capture 403-gated)")
    port = operator.get("port", 0)
    _expect(isinstance(port, int) and not isinstance(port, bool)
            and 0 <= port <= 65535,
            "'operator.port' must be an integer in [0, 65535] (0 binds an "
            "ephemeral port, recorded in operator.json), got %r" % (port,))
    sample_hz = operator.get("sample_hz")
    _expect(sample_hz is None or (_is_number(sample_hz) and sample_hz >= 0),
            "'operator.sample_hz' must be a non-negative number (0 disables "
            "the wall-clock stack sampler), got %r" % (sample_hz,))


def _check_devobs(devobs) -> None:
    """The reference's rules (rnb_tpu/config.py, root ``devobs``)."""
    _expect(isinstance(devobs, dict), "'devobs' must be an object")
    unknown = sorted(set(devobs) - set(DEVOBS_KEYS))
    _expect(not unknown, "'devobs' has unknown key(s) %s — keys are %s"
            % (unknown, DEVOBS_KEYS))
    _expect(isinstance(devobs.get("enabled", True), bool),
            "'devobs.enabled' must be a boolean")
    _expect(isinstance(devobs.get("capture_on_trigger", True), bool),
            "'devobs.capture_on_trigger' must be a boolean")
    window = devobs.get("capture_window_ms")
    _expect(window is None or (_is_number(window) and window >= 0),
            "'devobs.capture_window_ms' must be a non-negative number (0 "
            "disables the configured window; forced/trigger captures still "
            "run), got %r" % (window,))
    for key in ("max_captures", "capture_max_ops"):
        val = devobs.get(key)
        _expect(val is None or (isinstance(val, int)
                                and not isinstance(val, bool) and val >= 1),
                "'devobs.%s' must be a positive integer, got %r"
                % (key, val))
    for key in ("watermark_mb", "sample_hz"):
        val = devobs.get(key)
        _expect(val is None or _is_positive(val),
                "'devobs.%s' must be a positive number, got %r"
                % (key, val))


def _check_autotune(autotune) -> None:
    """The reference's rules (rnb_tpu/config.py, root ``autotune``)."""
    _expect(isinstance(autotune, dict), "'autotune' must be an object")
    unknown = sorted(set(autotune) - set(AUTOTUNE_KEYS))
    _expect(not unknown, "'autotune' has unknown key(s) %s — keys are %s"
            % (unknown, AUTOTUNE_KEYS))
    _expect(isinstance(autotune.get("enabled", True), bool),
            "'autotune.enabled' must be a boolean")

    def number(key, default, minimum, strict=False):
        val = autotune.get(key, default)
        _expect(_is_number(val)
                and (val > minimum if strict else val >= minimum),
                "'autotune.%s' must be a number %s %g, got %r"
                % (key, ">" if strict else ">=", minimum, val))
        return float(val)

    number("slo_ms", 50.0, 0, strict=True)
    alpha = number("ewma_alpha", 0.2, 0, strict=True)
    _expect(alpha <= 1.0, "'autotune.ewma_alpha' must be in (0, 1], got %r"
            % (alpha,))
    min_hold = number("min_hold_ms", 0.5, 0)
    max_hold = number("max_hold_ms", max(min_hold, 50.0), 0)
    _expect(max_hold >= min_hold,
            "'autotune.max_hold_ms' (%g) must be >= "
            "'autotune.min_hold_ms' (%g)" % (max_hold, min_hold))
    buckets = autotune.get("buckets")
    _expect(buckets is None
            or (isinstance(buckets, list) and buckets
                and all(isinstance(b, int) and not isinstance(b, bool)
                        and b >= 1 for b in buckets)
                and len(set(buckets)) == len(buckets)),
            "'autotune.buckets' must be a non-empty list of distinct "
            "positive row counts, got %r" % (buckets,))


def _check_deadline(deadline) -> None:
    """The reference's rules (rnb_tpu/config.py, root ``deadline``)."""
    _expect(isinstance(deadline, dict), "'deadline' must be an object")
    unknown = sorted(set(deadline) - set(DEADLINE_KEYS))
    _expect(not unknown, "'deadline' has unknown key(s) %s — keys are %s"
            % (unknown, DEADLINE_KEYS))
    _expect(isinstance(deadline.get("enabled", True), bool),
            "'deadline.enabled' must be a boolean")
    budget = deadline.get("budget_ms")
    _expect(budget is None or (_is_number(budget) and budget > 0),
            "'deadline.budget_ms' must be a positive number (defaults to "
            "autotune.slo_ms when autotune is configured), got %r"
            % (budget,))


def _check_health(health) -> None:
    """The reference's rules (rnb_tpu/config.py, root ``health``)."""
    _expect(isinstance(health, dict), "'health' must be an object")
    unknown = sorted(set(health) - set(HEALTH_KEYS))
    _expect(not unknown, "'health' has unknown key(s) %s — keys are %s"
            % (unknown, HEALTH_KEYS))
    _expect(isinstance(health.get("enabled", True), bool),
            "'health.enabled' must be a boolean")
    for key in ("suspect_after_ms", "open_after_ms", "probe_interval_ms"):
        val = health.get(key)
        _expect(val is None or _is_positive(val),
                "'health.%s' must be a positive number, got %r" % (key, val))
    if health.get("enabled", True):
        # the runtime's defaulting: thresholds that invert fail here
        from rnb_tpu_torch.health import HealthSettings
        try:
            HealthSettings.from_config(health)
        except ValueError as e:
            raise ConfigError("invalid 'health': %s" % e) from e


def _check_netedge(netedge) -> None:
    """The reference's rules (rnb_tpu/config.py, root ``netedge``)."""
    _expect(isinstance(netedge, dict), "'netedge' must be an object")
    unknown = sorted(set(netedge) - set(NETEDGE_KEYS))
    _expect(not unknown, "'netedge' has unknown key(s) %s — keys are %s"
            % (unknown, NETEDGE_KEYS))
    _expect(isinstance(netedge.get("enabled", True), bool),
            "'netedge.enabled' must be a boolean")
    _expect(isinstance(netedge.get("spawn", False), bool),
            "'netedge.spawn' must be a boolean")
    for key in ("listen", "connect"):
        val = netedge.get(key)
        _expect(val is None or isinstance(val, str),
                "'netedge.%s' must be a host:port string, got %r"
                % (key, val))
    for key in ("beat_ms", "io_timeout_ms", "backoff_ms"):
        val = netedge.get(key)
        _expect(val is None or (_is_number(val) and val >= 0),
                "'netedge.%s' must be a non-negative number, got %r"
                % (key, val))
    for key in ("max_retries", "resend_window"):
        val = netedge.get(key)
        _expect(val is None or (isinstance(val, int)
                                and not isinstance(val, bool) and val >= 1),
                "'netedge.%s' must be a positive integer, got %r"
                % (key, val))
    if netedge.get("enabled", True):
        # the runtime's defaulting: a timeout shorter than the beat, or
        # neither connect nor spawn, fails here
        from rnb_tpu_torch.netedge import NetEdgeSettings
        try:
            NetEdgeSettings.from_config(netedge)
        except ValueError as e:
            raise ConfigError("invalid 'netedge': %s" % e) from e


def _check_netedge_pipeline(steps, raw) -> None:
    """The reference's cross-key rules of an enabled edge: the peer
    serves step 0 and the receiver injects into step 1's input edge, so
    the remote and local emissions must be interchangeable."""
    _expect(len(steps) >= 2,
            "'netedge' needs at least 2 pipeline steps: the peer serves "
            "step 0 remotely and injects into step 1's input edge")
    _expect(steps[0].num_segments == 1,
            "'netedge' cannot serve a segmented step 0: the remote path "
            "bypasses the runner's segment split")
    trace = raw.get("trace")
    _expect(not (isinstance(trace, dict) and trace.get("enabled", True)),
            "'netedge' cannot be combined with 'trace': remote emissions "
            "lack the trace-mode decode stamps, so the per-request timing "
            "tables would mix two schemas")
    ragged = raw.get("ragged")
    _expect(not (isinstance(ragged, dict) and ragged.get("enabled", True)),
            "'netedge' cannot be combined with 'ragged': the peer's "
            "row-pool accounting dies with the peer")
    _expect(all(s.replica_queues is None for s in steps),
            "'netedge' cannot be combined with replica-expanded steps (or "
            "hedging/apply-mode placement): injected remote emissions "
            "bypass the replica in-flight depth accounting")


def _check_handoff(handoff) -> None:
    """The reference's rules (rnb_tpu/config.py, root ``handoff``)."""
    _expect(isinstance(handoff, dict), "'handoff' must be an object")
    unknown = sorted(set(handoff) - set(HANDOFF_KEYS))
    _expect(not unknown, "'handoff' has unknown key(s) %s — keys are %s"
            % (unknown, HANDOFF_KEYS))
    _expect(isinstance(handoff.get("enabled", True), bool),
            "'handoff.enabled' must be a boolean")
    mode = handoff.get("mode", "device")
    _expect(mode in ("device", "host"),
            "'handoff.mode' must be \"device\" (device-resident edges) or "
            "\"host\" (the explicit host round-trip baseline arm), got %r"
            % (mode,))


def _check_lint(lint) -> None:
    """The reference's rules (rnb_tpu/config.py, root ``lint``)."""
    _expect(isinstance(lint, dict), "'lint' must be an object")
    unknown = sorted(set(lint) - set(LINT_KEYS))
    _expect(not unknown, "'lint' has unknown key(s) %s — keys are %s"
            % (unknown, LINT_KEYS))
    _expect(isinstance(lint.get("lock_witness", False), bool),
            "'lint.lock_witness' must be a boolean")


def _alias_gpus(pipeline: list) -> list:
    """A queue group's ``gpus`` list is the reference's alias of
    ``devices``: it becomes ``devices`` where the group has none, and is
    dropped where it has (``devices`` wins, as in the reference). Returns
    a copy when a group names ``gpus``; the input is never changed."""
    def named(group):
        return isinstance(group, dict) and "gpus" in group
    if not any(named(g) for step in pipeline if isinstance(step, dict)
               for g in step.get("queue_groups") or []):
        return pipeline
    pipeline = copy.deepcopy(pipeline)
    for step in pipeline:
        if not isinstance(step, dict):
            continue
        for group in step.get("queue_groups") or []:
            if named(group):
                gpus = group.pop("gpus")
                group.setdefault("devices", gpus)
    return pipeline


def _check_loader_knobs(step_raw: dict, step_idx: int) -> None:
    """The reference's parse-time types of the transfer-pipeline and
    fallback-pool knobs, with its messages."""
    where = "pipeline step %d" % step_idx
    staging_slots = step_raw.get("staging_slots")
    _expect(staging_slots is None
            or (isinstance(staging_slots, int)
                and not isinstance(staging_slots, bool)
                and staging_slots >= 0),
            "%s: 'staging_slots' must be a non-negative integer (0 "
            "disables zero-copy staging), got %r" % (where, staging_slots))
    transfer_async = step_raw.get("transfer_async")
    _expect(transfer_async is None or isinstance(transfer_async, bool),
            "%s: 'transfer_async' must be a boolean, got %r"
            % (where, transfer_async))
    threads = step_raw.get("fallback_decode_threads")
    _expect(threads is None
            or (isinstance(threads, int) and not isinstance(threads, bool)
                and threads >= 1),
            "%s: 'fallback_decode_threads' must be a positive integer, "
            "got %r" % (where, threads))


def _check_placement(placement, num_steps: int) -> None:
    """The reference's rules (rnb_tpu/config.py, root ``placement``): an
    apply-mode plan names ``step<i>`` replica counts inside the
    pipeline."""
    _expect(isinstance(placement, dict), "'placement' must be an object")
    unknown = sorted(set(placement) - set(PLACEMENT_KEYS))
    _expect(not unknown, "'placement' has unknown key(s) %s — keys are %s"
            % (unknown, PLACEMENT_KEYS))
    _expect(isinstance(placement.get("enabled", True), bool),
            "'placement.enabled' must be a boolean")
    mode = placement.get("mode", "plan")
    _expect(mode in ("plan", "apply"),
            "'placement.mode' must be \"plan\" (report the measured-cost "
            "plan) or \"apply\" (apply 'plan' replica counts at launch), "
            "got %r" % (mode,))
    plan = placement.get("plan")
    if mode == "apply":
        _expect(isinstance(plan, dict) and plan,
                "'placement.mode' \"apply\" needs a non-empty 'plan' "
                "object ({\"step<i>\": replicas})")
    if plan is None:
        return
    _expect(isinstance(plan, dict), "'placement.plan' must be an object")
    for key, val in plan.items():
        _expect(isinstance(key, str) and key.startswith("step")
                and key[4:].isdigit() and int(key[4:]) < num_steps,
                "'placement.plan' keys must be \"step<i>\" with i inside "
                "the pipeline (0..%d), got %r" % (num_steps - 1, key))
        _expect(isinstance(val, int) and not isinstance(val, bool)
                and val >= 1,
                "'placement.plan.%s' must be a positive integer replica "
                "count, got %r" % (key, val))


def _expand_replicas(pipeline: list, placement) -> tuple:
    """The reference's replica expansion (rnb_tpu/config.py
    ``_expand_replicas``), with its messages: every step declaring
    ``replicas: N`` (or named by an apply-mode placement plan; the step's
    own key wins) becomes N queue groups, one a lane, each with a fresh
    lane queue and an equal contiguous slice of the step's devices; the
    upstream producers' out queue becomes the lane queues, routed by
    ``ReplicaSelector`` where they named the default selector. ``N == 1``
    is validated and changes nothing. Returns ``(pipeline, {step_idx:
    lane queue indices})``; the input is never changed."""
    from rnb_tpu_torch.parallel.mesh import carve_replicas
    plan: Dict[int, int] = {}
    if isinstance(placement, dict) and placement.get("enabled", True) \
            and placement.get("mode", "plan") == "apply":
        for key, val in (placement.get("plan") or {}).items():
            plan[int(key[4:])] = int(val)
    wants: Dict[int, Any] = {}
    for step_idx, step in enumerate(pipeline):
        if not isinstance(step, dict):
            continue
        n = step.get("replicas")
        if n is None:
            n = plan.get(step_idx)
        if n is not None:
            wants[step_idx] = n
    for step_idx, n in wants.items():
        _expect(isinstance(n, int) and not isinstance(n, bool) and n >= 1,
                "pipeline step %d: 'replicas' must be a positive integer, "
                "got %r" % (step_idx, n))
    if not wants:
        return pipeline, {}
    pipeline = copy.deepcopy(pipeline)
    used = set()
    for step in pipeline:
        if not isinstance(step, dict):
            continue
        for group in step.get("queue_groups") or []:
            if not isinstance(group, dict):
                continue
            if isinstance(group.get("in_queue"), int):
                used.add(group["in_queue"])
            used.update(q for q in group.get("out_queues") or []
                        if isinstance(q, int))
    next_q = max(used) + 1 if used else 0
    replica_queues: Dict[int, tuple] = {}
    for step_idx in sorted(wants):
        n = wants[step_idx]
        step = pipeline[step_idx]
        step.pop("replicas", None)
        where = "pipeline step %d" % step_idx
        _expect(step_idx > 0,
                "%s: 'replicas' needs a routable in_queue; the first step "
                "reads the shared filename queue — replicate it by listing "
                "more devices instead" % where)
        _expect(step.get("num_segments", 1) == 1,
                "%s: 'replicas' cannot be combined with 'num_segments' > 1 "
                "(segment siblings must reach one aggregator, which "
                "per-replica lanes cannot guarantee)" % where)
        groups = step.get("queue_groups")
        _expect(isinstance(groups, list) and len(groups) == 1
                and isinstance(groups[0], dict),
                "%s: 'replicas' requires exactly one queue group to expand"
                % where)
        group = groups[0]
        _expect("devices" in group,
                "%s, queue group 0 needs a 'devices' list" % where)
        devices = group["devices"]
        _expect(isinstance(devices, list) and devices
                and len(devices) % n == 0,
                "%s: 'replicas'=%d must evenly divide the %d-entry device "
                "list — each replica owns an equal sub-mesh"
                % (where, n, len(devices) if isinstance(devices, list)
                   else 0))
        orig_in = group.get("in_queue")
        _expect(isinstance(orig_in, int),
                "%s, queue group 0 needs an integer 'in_queue'" % where)
        if n == 1:
            continue
        lanes = list(range(next_q, next_q + n))
        next_q += n
        new_groups = []
        for lane, sub_mesh in zip(lanes, carve_replicas(devices, n)):
            lane_group = copy.deepcopy(group)
            lane_group["devices"] = sub_mesh
            lane_group["in_queue"] = lane
            new_groups.append(lane_group)
        step["queue_groups"] = new_groups
        rewired = False
        for up in pipeline[step_idx - 1].get("queue_groups") or []:
            if not isinstance(up, dict):
                continue
            outs = list(up.get("out_queues") or [])
            if orig_in not in outs:
                continue
            pos = outs.index(orig_in)
            up["out_queues"] = outs[:pos] + lanes + outs[pos + 1:]
            if port_class_path(up.get("queue_selector",
                                      DEFAULT_QUEUE_SELECTOR)) \
                    == DEFAULT_QUEUE_SELECTOR:
                up["queue_selector"] = REPLICA_QUEUE_SELECTOR
            rewired = True
        _expect(rewired,
                "%s: no upstream queue group names out-queue %d, so the "
                "replica lanes cannot be wired" % (where, orig_in))
        replica_queues[step_idx] = tuple(lanes)
    return pipeline, replica_queues


def _check_hedge(step_raw: dict, step_idx: int, replica_queues: dict):
    """A step's ``hedge_ms`` under the reference's rules and messages:
    a positive millisecond count or ``"p95x"``, on a replica step."""
    hedge_ms = step_raw.get("hedge_ms")
    if hedge_ms is None:
        return None
    where = "pipeline step %d" % step_idx
    _expect(hedge_ms == "p95x" or _is_positive(hedge_ms),
            "%s: 'hedge_ms' must be a positive millisecond count or "
            "\"p95x\", got %r" % (where, hedge_ms))
    _expect(replica_queues.get(step_idx) is not None,
            "%s: 'hedge_ms' needs replica lanes to re-dispatch onto — "
            "declare 'replicas' >= 2 on this step" % where)
    return hedge_ms


def _check_fault_plan(fault_plan, num_steps: int) -> None:
    """The reference's rule: the plan's structure, and its step indices
    against this pipeline (a typo'd step would never fire)."""
    from rnb_tpu_torch.faults import FaultPlan
    try:
        FaultPlan(fault_plan).check_steps(num_steps)
    except ValueError as e:
        raise ConfigError("invalid 'fault_plan': %s" % e) from e


def _check_retries(step_raw: dict, step_idx: int):
    """A step's ``(max_retries, retry_backoff_ms)`` under the reference's
    rules and messages."""
    where = "pipeline step %d" % step_idx
    max_retries = step_raw.get("max_retries", 0)
    _expect(isinstance(max_retries, int) and max_retries >= 0,
            "%s: 'max_retries' must be a non-negative integer" % where)
    backoff = step_raw.get("retry_backoff_ms", 10.0)
    _expect(isinstance(backoff, (int, float)) and backoff >= 0,
            "%s: 'retry_backoff_ms' must be a non-negative number" % where)
    return int(max_retries), float(backoff)


def _check_num_segments(step_raw: dict, step_idx: int,
                        final: bool) -> int:
    """A step's ``num_segments``, under the reference's rules and
    messages: a positive integer, not on the last step, not with
    ``row_buckets`` (each bucket would split into unwarmed segment
    shapes), and no more segments than the producer's credits
    (``num_shared_tensors``): every segment holds one until its
    consumer takes it."""
    where = "pipeline step %d" % step_idx
    num_segments = step_raw.get("num_segments", 1)
    _expect(isinstance(num_segments, int) and num_segments >= 1,
            "%s: 'num_segments' must be a positive integer" % where)
    _expect(not (final and num_segments != 1),
            "the last step may not have multiple segments")
    _expect(not (num_segments > 1 and "row_buckets" in step_raw),
            "%s: 'row_buckets' cannot be combined with 'num_segments' > 1"
            % where)
    slots = step_raw.get("num_shared_tensors")
    effective = DEFAULT_NUM_SHARED_TENSORS if slots is None else slots
    _expect(num_segments <= effective,
            "%s: 'num_segments' (%d) exceeds the shared-tensor ring size "
            "(%d%s) — the producer would deadlock waiting on a slot it "
            "has not yet published; raise 'num_shared_tensors'"
            % (where, num_segments, effective,
               "" if slots is not None else ", the default"))
    return num_segments


def _expand_shard(pipeline: list) -> list:
    """The reference's rule for the step-level ``shard: {degree, axis,
    hbm_budget_mb}`` key, with its messages: each queue group lists
    exactly ``degree`` devices, none the host, and keeps the first as
    its one instance's; the whole ring goes to the stage as
    ``shard_devices`` beside ``shard_degree``, ``shard_axis`` and, when
    set, ``shard_hbm_budget_mb``. Returns a copy when a step declares
    ``shard``; the input is never changed."""
    if not any(isinstance(step, dict) and step.get("shard") is not None
               for step in pipeline):
        return pipeline
    pipeline = copy.deepcopy(pipeline)
    for step_idx, step in enumerate(pipeline):
        if not isinstance(step, dict):
            continue
        shard = step.get("shard")
        if shard is None:
            continue
        where = "pipeline step %d" % step_idx
        _expect(isinstance(shard, dict),
                "%s: 'shard' must be an object" % where)
        unknown = sorted(set(shard) - set(SHARD_KEYWORDS))
        _expect(not unknown,
                "%s: 'shard' has unknown key(s) %s — keys are %s"
                % (where, unknown, SHARD_KEYWORDS))
        degree = shard.get("degree")
        _expect(isinstance(degree, int) and not isinstance(degree, bool)
                and degree >= 1,
                "%s: 'shard.degree' must be a positive integer, got %r"
                % (where, degree))
        axis = shard.get("axis", "tp")
        _expect(isinstance(axis, str) and axis,
                "%s: 'shard.axis' must be a non-empty string, got %r"
                % (where, axis))
        budget = shard.get("hbm_budget_mb")
        _expect(budget is None
                or (isinstance(budget, (int, float))
                    and not isinstance(budget, bool) and budget > 0),
                "%s: 'shard.hbm_budget_mb' must be a positive number, "
                "got %r" % (where, budget))
        _expect(step.get("num_segments", 1) == 1,
                "%s: 'shard' cannot be combined with 'num_segments' > 1 "
                "(segment siblings would each need their own ring)" % where)
        for group_idx, group in enumerate(step.get("queue_groups") or []):
            gwhere = "%s, queue group %d" % (where, group_idx)
            _expect(isinstance(group, dict), "%s must be an object" % gwhere)
            _expect("devices" in group, "%s needs a 'devices' list" % gwhere)
            devices = group["devices"]
            _expect(isinstance(devices, list) and len(devices) == degree,
                    "%s: 'shard.degree'=%d needs exactly that many devices "
                    "per lane (got %d) — with 'replicas' the step's device "
                    "list must total replicas x degree"
                    % (gwhere, degree,
                       len(devices) if isinstance(devices, list) else 0))
            _expect(all(d != -1 for d in devices),
                    "%s: 'shard' rings cannot include the host (-1)"
                    % gwhere)
            # one primary device, one executor instance; the ring rides
            # to the stage as its kwargs
            group["devices"] = devices[:1]
            group["shard_devices"] = list(devices)
            group["shard_degree"] = degree
            group["shard_axis"] = axis
            if budget is not None:
                group["shard_hbm_budget_mb"] = budget
    return pipeline


def _mesh_devices(kwargs: dict, platform: str, where: str) -> None:
    """A mesh stage's ``mesh_devices`` indices become ``DeviceSpec`` s,
    as a ring's ``shard_devices`` do."""
    if "mesh_devices" not in kwargs:
        return
    devices = kwargs["mesh_devices"]
    _expect(isinstance(devices, list) and devices and all(
        isinstance(d, int) and not isinstance(d, bool) and d >= 0
        for d in devices),
        "%s: 'mesh_devices' must be a non-empty list of device indices, "
        "got %r" % (where, devices))
    kwargs["mesh_devices"] = [DeviceSpec(d, platform) for d in devices]


def parse_config(raw: dict, platform: Optional[str] = None
                 ) -> PipelineConfig:
    """Validate a config dict and build the port's view of it."""
    platform = resolve_platform(platform)
    _check_keys(raw, ROOT_KEYS, "root")
    if "video_path_iterator" not in raw or "pipeline" not in raw:
        raise ConfigError("config needs 'video_path_iterator' and "
                          "'pipeline'")
    overload_policy = raw.get("overload_policy", "abort")
    _expect(overload_policy in ("abort", "shed"),
            "'overload_policy' must be \"abort\" or \"shed\", got %r"
            % (overload_policy,))
    fault_containment = raw.get("fault_containment", True)
    _expect(isinstance(fault_containment, bool),
            "'fault_containment' must be a boolean")
    trace = raw.get("trace")
    if trace is not None:
        _check_trace(trace)
    for key, check in (("deadline", _check_deadline),
                       ("lint", _check_lint),
                       ("handoff", _check_handoff),
                       ("health", _check_health),
                       ("netedge", _check_netedge),
                       ("metrics", _check_metrics),
                       ("critpath", _check_critpath),
                       ("devobs", _check_devobs),
                       ("autotune", _check_autotune),
                       ("operator", _check_operator)):
        if raw.get(key) is not None:
            check(raw[key])
    if raw.get("whatif") is not None:
        _check_whatif(raw["whatif"], raw.get("metrics"))
    ragged = raw.get("ragged")
    if ragged is not None:
        _check_keys(ragged, RAGGED_KEYS, "ragged")
        if ragged.get("enabled", True):
            # the pool is one dispatch shape; segments would need a
            # pool shape each
            _expect(all(step.get("num_segments", 1) == 1
                        for step in raw["pipeline"]
                        if isinstance(step, dict)),
                    "'ragged' cannot be combined with 'num_segments' > 1: "
                    "the pool is one fixed dispatch shape")
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
    placement = raw.get("placement")
    if placement is not None:
        _check_placement(placement, len(pipeline))
    fault_plan = raw.get("fault_plan")
    if fault_plan is not None:
        _check_fault_plan(fault_plan, len(pipeline))
    # the expanded form is the one topology everything below checks and
    # builds; sharding composes replica-major
    pipeline = _alias_gpus(pipeline)
    pipeline, replica_queues = _expand_replicas(pipeline, placement)
    pipeline = _expand_shard(pipeline)
    for step_idx, step_raw in enumerate(pipeline):
        where = "step %d" % step_idx
        model = port_class_path(step_raw.get("model") if isinstance(
            step_raw, dict) else step_raw)
        class_name = model.rpartition(".")[2]
        if class_name not in MODEL_KEYS:
            raise _not_ported("%s model %r" % (where, step_raw["model"]))
        if step_raw.get("shard") is not None and class_name != "R2P1DRunner":
            raise ConfigError("%s: 'shard' needs a stage that declares a "
                              "partition (R2P1DRunner), not %s"
                              % (where, class_name))
        _check_keys(step_raw, STEP_KEYS | MODEL_KEYS[class_name], where)
        _check_loader_knobs(step_raw, step_idx)
        kwargs = {k: v for k, v in step_raw.items()
                  if k in MODEL_KEYS[class_name]}
        _mesh_devices(kwargs, platform, where)
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
            if "shard_devices" in group_kwargs:
                group_kwargs["shard_devices"] = [
                    DeviceSpec(d, platform)
                    for d in group_kwargs["shard_devices"]]
            _mesh_devices(group_kwargs, platform, where + " queue group")
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
        step_autotune = step_raw.get("autotune", True)
        _expect(isinstance(step_autotune, bool),
                "pipeline step %d: 'autotune' must be a boolean (false "
                "opts the step out of the root autotune controller)"
                % step_idx)
        max_retries, retry_backoff_ms = _check_retries(step_raw, step_idx)
        async_dispatch = step_raw.get("async_dispatch", False)
        _expect(isinstance(async_dispatch, bool),
                "pipeline step %d: 'async_dispatch' must be a boolean"
                % step_idx)
        _expect(not (async_dispatch and not is_final
                     and replica_queues.get(step_idx) is not None),
                "pipeline step %d: 'async_dispatch' on a replica step "
                "that feeds another step is refused: each lane serves on "
                "a CUDA stream of its own, and the next step's stream "
                "would read its outputs unordered; set it on the step "
                "before the lanes or on a final lane step" % step_idx)
        slots = int(step_raw.get("num_shared_tensors",
                                 DEFAULT_NUM_SHARED_TENSORS))
        if slots < 1:
            raise ConfigError("%s: num_shared_tensors must be >= 1" % where)
        steps.append(StepConfig(
            model=model, groups=groups, num_shared_tensors=slots,
            kwargs=kwargs,
            num_segments=_check_num_segments(step_raw, step_idx, is_final),
            autotune=step_autotune, max_retries=max_retries,
            retry_backoff_ms=retry_backoff_ms,
            replica_queues=replica_queues.get(step_idx),
            hedge_ms=_check_hedge(step_raw, step_idx, replica_queues),
            async_dispatch=async_dispatch))
    netedge = raw.get("netedge")
    if netedge is not None and netedge.get("enabled", True):
        _check_netedge_pipeline(steps, raw)
    return PipelineConfig(
        video_path_iterator=port_class_path(raw["video_path_iterator"]),
        steps=steps, ragged=ragged, platform=platform,
        popularity=popularity, pager=pager, trace=trace,
        metrics=raw.get("metrics"), critpath=raw.get("critpath"),
        devobs=raw.get("devobs"), whatif=raw.get("whatif"),
        operator=raw.get("operator"), autotune=raw.get("autotune"),
        overload_policy=overload_policy,
        fault_containment=fault_containment, fault_plan=fault_plan,
        deadline=raw.get("deadline"), health=raw.get("health"),
        netedge=netedge, handoff=raw.get("handoff"), placement=placement,
        lint=raw.get("lint"), raw=raw)


def load_config(path: str, platform: Optional[str] = None
                ) -> PipelineConfig:
    with open(path) as f:
        raw = json.load(f)
    return parse_config(raw, platform)
