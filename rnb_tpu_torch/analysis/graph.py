"""Static pipeline graph checker: reject broken configs pre-launch.

Counterpart of ``rnb_tpu/analysis/graph.py`` over the port: a config is
read by the port's own reader (:func:`rnb_tpu_torch.config.load_config`,
which maps the ``rnb_tpu.`` class prefix onto ``rnb_tpu_torch.``) on the
CPU platform, and its classes are the port's stages.

Loads any pipeline config (shipped or user), resolves every class it
names, and propagates the stages' *declared* PaddedBatch metadata —
max shapes (``output_shape_for`` / ``input_shape_for``), dtypes
(``output_dtype_for`` / ``input_dtype_for``) and row-bucket sets —
step-to-step along the queue wiring, with no device, no dataset and no
stage construction: a config that would abort (or capture a new graph)
minutes into a run on the card is rejected in milliseconds instead.

Rules
-----
* ``RNB-G001`` config-parse: the config fails schema validation
  (rnb_tpu_torch.config) — covers queue wiring, fault-plan step ranges,
  popularity keys, segment/ring arithmetic.
* ``RNB-G002`` unresolvable-class: a ``model`` /
  ``video_path_iterator`` / ``queue_selector`` class path does not
  import or the module lacks the class.
* ``RNB-G003`` shape-mismatch: a producer group's declared (and
  segment-shrunk) output shapes cannot feed a wired consumer group's
  declared input shapes (tensor count, trailing dims, or a row axis
  exceeding the consumer's capacity).
* ``RNB-G004`` selector-arity: a group's queue selector rejects its
  out-queue count (e.g. LargeSmallSelector on != 2 queues).
* ``RNB-G005`` unconsumed-config-key: a step/group extra key is not a
  named constructor parameter of the stage class (its MRO union plus
  declared ``FORWARDS_CONFIG_TO`` targets) — the open kwargs
  passthrough would silently swallow the typo.
* ``RNB-G006`` bucket-mismatch: the row-count set a producer group can
  emit is not covered by the consumer's warmed bucket set — every
  uncovered bucket is a new signature (a capture) inside the measured
  window. Consumers with ``REPACKS_ROWS`` (Batcher) accept any
  upstream buckets and are skipped. Also covers the ``autotune`` root
  key: an ``autotune.buckets`` restriction naming a row bucket some
  participating stage (``SUPPORTS_AUTOTUNE``, not opted out via the
  step's ``"autotune": false``) never warms — the controller refuses
  it at launch precisely because a chosen un-warmed bucket would be a
  mid-run recompile, and this rule rejects it statically.
* ``RNB-G007`` invalid-cache-mb: a ``cache_mb`` value the stage would
  reject at construction (non-numeric or negative; 0 disables).
* ``RNB-G008`` dtype-mismatch: producer output dtype and consumer
  input dtype are both declared and differ (e.g. a yuv420 loader wired
  into an rgb network stage).
* ``RNB-G009`` ragged-pool-mismatch: the root ``ragged`` key's
  ``pool_rows`` does not equal a participating stage's declared max
  row axis — the pool is the stage's ONE compiled shape, so a
  different capacity would silently change every declared wire shape
  and warmup signature (the stage constructor rejects it at launch;
  this rule rejects it statically).
* ``RNB-G010`` shard-spec: a step's ``shard`` key is unusable as
  declared — the model class declares no partition spec
  (``SUPPORTS_SHARD``), the degree does not divide every declared
  output-channel width of the stage's layer range
  (rnb_tpu_torch.parallel.shardplan.validate_degree — a non-dividing degree
  cannot slice the weights), or the expanded shard rings oversubscribe
  the step's mesh (a device appearing twice in one ring, or shared
  between two replica lanes' rings). The stage constructor rejects the
  first two at launch; this rule rejects all three statically.

Ragged interplay: with the root ``ragged`` key enabled, participating
stages ship exactly one shape (the pool) with a ``rows_valid`` count, so the RNB-G006 bucket-coverage check and the
``autotune.buckets`` warmed-subset check relax — any row count up to
the pool capacity is dispatchable without a recompile, and configured
``row_buckets`` are only the counterfactual pad rule the
``pad_rows_eliminated`` counter is measured against.
"""

from __future__ import annotations

import functools
import inspect
import os
from typing import Any, Dict, List, Optional

from rnb_tpu_torch.analysis.findings import Finding
from rnb_tpu_torch.config import (ConfigError, ShardSpecError,
                                  UnconsumedKeyError, UnresolvedClassError,
                                  load_config)
from rnb_tpu_torch.control import get_segmented_shapes
from rnb_tpu_torch.parallel.shardplan import validate_degree
from rnb_tpu_torch.stage import normalize_row_buckets
from rnb_tpu_torch.utils.class_utils import load_class

#: configs are read as on the CPU: no device is resolved or touched
PLATFORM = "cpu"

#: the port's reader refuses at parse time some configs the reference's
#: accepts and refuses only at construction: each such refusal is filed
#: under the rule the reference's checker gives it
PARSE_RULES = ((UnresolvedClassError, "RNB-G002"),
               (UnconsumedKeyError, "RNB-G005"),
               (ShardSpecError, "RNB-G010"))


def _rel(path: str, root: str) -> str:
    """Repo-relative finding path — the stable half of the baseline
    key; paths outside ``root`` stay absolute rather than dotted."""
    rel = os.path.relpath(path, root)
    return path if rel.startswith("..") else rel.replace(os.sep, "/")


def _resolve(class_path: str, rel: str, anchor: str,
             findings: List[Finding]):
    """load_class with an RNB-G002 finding instead of an exception."""
    try:
        return load_class(class_path)
    except Exception as e:
        findings.append(Finding(
            "RNB-G002", rel, 0, anchor,
            "cannot resolve class %r: %s" % (class_path, e)))
        return None


@functools.lru_cache(maxsize=None)
def consumed_config_keys(cls) -> frozenset:
    """Named constructor parameters a stage class actually consumes:
    the union over its MRO plus any classes it declares forwarding its
    open kwargs to (``FORWARDS_CONFIG_TO``)."""
    keys: set = set()
    stack = [cls]
    seen = set()
    while stack:
        c = stack.pop()
        if c in seen:
            continue
        seen.add(c)
        for base in getattr(c, "__mro__", ()):
            init = base.__dict__.get("__init__")
            if init is None:
                continue
            try:
                sig = inspect.signature(init)
            except (TypeError, ValueError):
                continue
            for name, param in sig.parameters.items():
                if param.kind in (param.POSITIONAL_OR_KEYWORD,
                                  param.KEYWORD_ONLY):
                    keys.add(name)
        stack.extend(getattr(c, "FORWARDS_CONFIG_TO", ()))
    keys.discard("self")
    keys.discard("device")
    return frozenset(keys)


def _declared(cls, method: str, kwargs: Dict[str, Any], rel: str,
              anchor: str, findings: List[Finding],
              sentinel=None):
    """Call a static declaration classmethod, turning an exception
    (the stage statically rejects these kwargs) into a finding under
    the rule family the declaration belongs to."""
    try:
        return getattr(cls, method)(**kwargs)
    except Exception as e:
        rule = "RNB-G008" if "dtype" in method else "RNB-G003"
        findings.append(Finding(
            rule, rel, 0, anchor,
            "%s.%s rejects the configured kwargs: %s"
            % (cls.__name__, method, e)))
        return sentinel


def _emission_rows(shapes, row_buckets, rel: str, anchor: str,
                   findings: List[Finding]) -> Optional[set]:
    """The set of row counts (axis 0 of tensor 0) a group can emit."""
    max_rows = int(shapes[0][0])
    if not row_buckets:
        return {max_rows}
    try:
        return set(normalize_row_buckets(row_buckets, max_rows,
                                         "declared max rows"))
    except Exception as e:
        findings.append(Finding("RNB-G006", rel, 0, anchor,
                                "invalid row_buckets: %s" % e))
        return None


def check_config(path: str, root: str = ".") -> List[Finding]:
    """All graph findings for one config file."""
    rel = _rel(path, root)
    try:
        config = load_config(path, platform=PLATFORM)
    except ConfigError as e:
        rule = next((rule for error, rule in PARSE_RULES
                     if isinstance(e, error)), "RNB-G001")
        return [Finding(rule, rel, 0, "parse", str(e))]
    findings: List[Finding] = []
    _resolve(config.video_path_iterator, rel, "video_path_iterator",
             findings)

    classes = []
    for step_idx, step in enumerate(config.steps):
        classes.append(_resolve(step.model, rel, "step%d" % step_idx,
                                findings))

    # per-group local checks: selector arity, unconsumed keys, cache_mb
    for step_idx, (step, cls) in enumerate(zip(config.steps, classes)):
        for group_idx, group in enumerate(step.groups):
            anchor = "step%d.group%d" % (step_idx, group_idx)
            kwargs = step.kwargs_for_group(group_idx)

            if group.out_queues:
                sel_cls = _resolve(group.queue_selector, rel, anchor,
                                   findings)
                if sel_cls is not None:
                    try:
                        sel_cls(len(group.out_queues))
                    except Exception as e:
                        findings.append(Finding(
                            "RNB-G004", rel, 0, anchor,
                            "queue selector %s rejects %d out-queue(s): "
                            "%s" % (group.queue_selector,
                                    len(group.out_queues), e)))

            if "cache_mb" in kwargs:
                cache_mb = kwargs["cache_mb"]
                if (not isinstance(cache_mb, (int, float))
                        or isinstance(cache_mb, bool) or cache_mb < 0):
                    findings.append(Finding(
                        "RNB-G007", rel, 0, anchor,
                        "'cache_mb' must be a non-negative number "
                        "(0 disables caching), got %r" % (cache_mb,)))

            if cls is not None:
                # shard_* keys are parse-time wiring from the step's
                # 'shard' object, not user config — a class that can't
                # consume them is RNB-G010's finding, not a typo
                unknown = sorted(
                    k for k in kwargs
                    if k not in consumed_config_keys(cls)
                    and not k.startswith("_")
                    and k not in ("shard_devices", "shard_degree",
                                  "shard_axis", "shard_hbm_budget_mb"))
                for key in unknown:
                    findings.append(Finding(
                        "RNB-G005", rel, 0, "%s.%s" % (anchor, key),
                        "config key %r is not a constructor parameter "
                        "of %s — the open kwargs passthrough would "
                        "silently drop it" % (key, cls.__name__)))

    # ragged row-pool dispatch (root 'ragged' key,
    # rnb_tpu_torch.ops.ragged): an explicit pool_rows must equal every
    # participating stage's declared max row axis — the same invariant
    # resolve_pool_rows enforces at construction, checked statically
    ragged_cfg = config.ragged
    ragged_on = ragged_cfg is not None and ragged_cfg.get("enabled",
                                                          True)
    if ragged_on and ragged_cfg.get("pool_rows") is not None:
        pool_rows = int(ragged_cfg["pool_rows"])
        for step_idx, (step, cls) in enumerate(zip(config.steps,
                                                   classes)):
            if cls is None or not getattr(cls, "SUPPORTS_RAGGED",
                                          False):
                continue
            for group_idx, group in enumerate(step.groups):
                anchor = "step%d.group%d.ragged" % (step_idx,
                                                    group_idx)
                kwargs = step.kwargs_for_group(group_idx)
                shapes = _declared(cls, "output_shape_for", kwargs,
                                   rel, anchor, findings)
                if shapes is None:
                    # final-style stages declare via input_shape_for
                    shapes = _declared(cls, "input_shape_for", kwargs,
                                       rel, anchor, findings)
                if not shapes:
                    continue
                declared_max = int(tuple(shapes[0])[0])
                if pool_rows != declared_max:
                    findings.append(Finding(
                        "RNB-G009", rel, 0, anchor,
                        "'ragged.pool_rows'=%d does not match %s's "
                        "declared max row axis %d — the pool is the "
                        "stage's one compiled shape, so its capacity "
                        "must equal the declared max"
                        % (pool_rows, cls.__name__, declared_max)))

    # intra-stage sharding (step 'shard' key,
    # rnb_tpu_torch.parallel.shardplan): the declared degree must have a
    # partition spec to act on (SUPPORTS_SHARD), must divide every
    # declared output-channel width of the stage's layer range, and
    # the expanded rings must not oversubscribe the step's mesh —
    # the constructor-time gates, checked statically
    for step_idx, (step, cls) in enumerate(zip(config.steps, classes)):
        seen_ring_devices: set = set()
        for group_idx, group in enumerate(step.groups):
            kwargs = step.kwargs_for_group(group_idx)
            degree = kwargs.get("shard_degree")
            if degree is None:
                continue
            anchor = "step%d.group%d.shard" % (step_idx, group_idx)
            if cls is not None and not getattr(cls, "SUPPORTS_SHARD",
                                               False):
                findings.append(Finding(
                    "RNB-G010", rel, 0, anchor,
                    "'shard' on a %s step, but the class declares no "
                    "partition spec (SUPPORTS_SHARD) — no parameter "
                    "axis is declared shardable, so the degree has "
                    "nothing to slice" % cls.__name__))
                continue
            if cls is not None:
                try:
                    sig = inspect.signature(cls.__init__)
                except (TypeError, ValueError):
                    sig = None

                def _resolved_kwarg(name, fallback):
                    if name in kwargs:
                        return kwargs[name]
                    if sig is not None:
                        param = sig.parameters.get(name)
                        if param is not None and param.default \
                                is not inspect.Parameter.empty:
                            return param.default
                    return fallback
                try:
                    validate_degree(
                        int(degree),
                        int(_resolved_kwarg("start_index", 1)),
                        int(_resolved_kwarg("end_index", 5)),
                        int(_resolved_kwarg("num_classes", 400)))
                except ValueError as e:
                    findings.append(Finding(
                        "RNB-G010", rel, 0, anchor, str(e)))
            ring = list(kwargs.get("shard_devices") or [])
            if len(set(ring)) != len(ring):
                findings.append(Finding(
                    "RNB-G010", rel, 0, anchor,
                    "shard ring %s lists a device more than once — a "
                    "degree-%s ring needs that many DISTINCT devices"
                    % (ring, degree)))
            overlap = sorted(set(ring) & seen_ring_devices)
            if overlap:
                findings.append(Finding(
                    "RNB-G010", rel, 0, anchor,
                    "shard ring %s shares device(s) %s with another "
                    "replica lane of the same step — lanes' rings "
                    "oversubscribe the step's mesh"
                    % (ring, overlap)))
            seen_ring_devices.update(ring)

    # load-adaptive batching (root 'autotune' key,
    # rnb_tpu_torch.autotune):
    # an autotune.buckets restriction must stay inside each
    # participating stage's warmed bucket set — the same invariant
    # BatchController.for_stage enforces at launch, checked statically.
    # Under ragged dispatch the warmed set is continuous (1..pool), so
    # any restriction within the declared max passes.
    autotune = config.autotune
    if autotune is not None and autotune.get("enabled", True) \
            and autotune.get("buckets"):
        restricted = set(int(b) for b in autotune["buckets"])
        for step_idx, (step, cls) in enumerate(zip(config.steps,
                                                   classes)):
            if cls is None or not step.autotune \
                    or not getattr(cls, "SUPPORTS_AUTOTUNE", False):
                continue
            for group_idx, group in enumerate(step.groups):
                anchor = "step%d.group%d.autotune" % (step_idx,
                                                      group_idx)
                kwargs = step.kwargs_for_group(group_idx)
                shapes = _declared(cls, "output_shape_for", kwargs,
                                   rel, anchor, findings)
                if not shapes:
                    continue
                if ragged_on and getattr(cls, "SUPPORTS_RAGGED",
                                         False):
                    # ragged stage: one compiled pool shape serves
                    # every row count up to its capacity, so the
                    # controller's candidate set is continuous
                    warmed = set(range(
                        1, int(tuple(shapes[0])[0]) + 1))
                else:
                    warmed = _emission_rows(
                        tuple(map(tuple, shapes)),
                        kwargs.get("row_buckets"), rel, anchor,
                        findings)
                if warmed is None:
                    continue
                missing = sorted(restricted - warmed)
                if missing:
                    findings.append(Finding(
                        "RNB-G006", rel, 0, anchor,
                        "'autotune.buckets' %s name row bucket(s) %s "
                        "that %s never warms (warmed: %s) — an "
                        "autotune decision for one would be a silent "
                        "mid-run recompile, so the controller rejects "
                        "this config at launch"
                        % (sorted(restricted), missing, cls.__name__,
                           sorted(warmed))))

    # step-to-step metadata propagation along the queue wiring
    for step_idx in range(1, config.num_steps):
        p_step, c_step = config.steps[step_idx - 1], config.steps[step_idx]
        p_cls, c_cls = classes[step_idx - 1], classes[step_idx]
        if p_cls is None or c_cls is None:
            continue
        for cg_idx, cgroup in enumerate(c_step.groups):
            ckwargs = c_step.kwargs_for_group(cg_idx)
            c_anchor = "step%d.group%d" % (step_idx, cg_idx)
            cin = _declared(c_cls, "input_shape_for", ckwargs, rel,
                            c_anchor, findings)
            cdtype = _declared(c_cls, "input_dtype_for", ckwargs, rel,
                               c_anchor, findings)
            for pg_idx, pgroup in enumerate(p_step.groups):
                if cgroup.in_queue not in pgroup.out_queues:
                    continue
                pkwargs = p_step.kwargs_for_group(pg_idx)
                edge = "step%d.group%d->step%d.group%d" % (
                    step_idx - 1, pg_idx, step_idx, cg_idx)
                pout = _declared(p_cls, "output_shape_for", pkwargs, rel,
                                 edge, findings)
                pdtype = _declared(p_cls, "output_dtype_for", pkwargs,
                                   rel, edge, findings)
                _check_edge(rel, edge, p_cls, c_cls, pkwargs, ckwargs,
                            p_step.num_segments, pout, pdtype,
                            cin, cdtype, findings, ragged_on)
    return findings


def _check_edge(rel: str, edge: str, p_cls, c_cls,
                pkwargs: Dict[str, Any], ckwargs: Dict[str, Any],
                num_segments: int,
                pout, pdtype, cin, cdtype,
                findings: List[Finding],
                ragged_on: bool = False) -> None:
    """Shape/dtype/bucket compatibility of one wired producer-group ->
    consumer-group edge."""
    if cin is None:
        return  # consumer declares no tensor expectations
    if pout is None:
        findings.append(Finding(
            "RNB-G003", rel, 0, edge,
            "%s declares no tensor outputs but %s expects input "
            "shapes %r" % (p_cls.__name__, c_cls.__name__, cin)))
        return
    pout = tuple(map(tuple, pout))
    cin = tuple(map(tuple, cin))
    try:
        seg_out = get_segmented_shapes(pout, num_segments)
    except ValueError as e:
        findings.append(Finding("RNB-G003", rel, 0, edge, str(e)))
        return
    if len(seg_out) != len(cin):
        findings.append(Finding(
            "RNB-G003", rel, 0, edge,
            "%s emits %d tensor(s) %r but %s expects %d %r"
            % (p_cls.__name__, len(seg_out), seg_out, c_cls.__name__,
               len(cin), cin)))
        return
    for idx, (got, want) in enumerate(zip(seg_out, cin)):
        if (len(got) != len(want) or tuple(got[1:]) != tuple(want[1:])
                or got[0] > want[0]):
            findings.append(Finding(
                "RNB-G003", rel, 0, edge,
                "output %d declares %r but the consumer expects %r "
                "(row axis may be smaller, never larger; trailing "
                "dims must match exactly)" % (idx, got, want)))
    if pdtype is not None and cdtype is not None and pdtype != cdtype:
        findings.append(Finding(
            "RNB-G008", rel, 0, edge,
            "%s emits dtype %s but %s expects %s"
            % (p_cls.__name__, pdtype, c_cls.__name__, cdtype)))

    # row-bucket coverage: every row count the producer can emit must
    # be a shape the consumer warmed/compiled, or the first occurrence
    # is a silent recompile inside the measured window
    if getattr(c_cls, "REPACKS_ROWS", False):
        return
    if ragged_on and getattr(p_cls, "SUPPORTS_RAGGED", False):
        # ragged producer: every emission ships the ONE pool shape
        # (its declared max); any configured row_buckets are the
        # counterfactual pad rule, never shipped shapes
        emission = {int(seg_out[0][0])}
    else:
        emission = _emission_rows(seg_out, pkwargs.get("row_buckets")
                                  if num_segments <= 1 else None,
                                  rel, edge, findings)
    if emission is None:
        return
    # the consumer's warmed set: its configured row_buckets when the
    # class consumes them, else the single declared input max. A
    # RAGGED consumer warms exactly its pool (the declared max) —
    # any configured row_buckets are only the counterfactual pad
    # rule — so a producer pool smaller than the consumer's is a
    # mid-run recompile this check must catch (e.g. loader
    # max_clips=15 feeding a runner max_rows=30 under an omitted
    # ragged.pool_rows: both resolve their own declared max)
    c_max = int(cin[0][0])
    warmed = {c_max}
    if not (ragged_on and getattr(c_cls, "SUPPORTS_RAGGED", False)) \
            and ("row_buckets" in consumed_config_keys(c_cls)
                 and ckwargs.get("row_buckets")):
        try:
            warmed = set(normalize_row_buckets(
                ckwargs["row_buckets"], c_max, "declared input max"))
        except Exception as e:
            findings.append(Finding("RNB-G006", rel, 0, edge,
                                    "invalid consumer row_buckets: %s"
                                    % e))
            return
    uncovered = sorted(emission - warmed)
    if uncovered:
        findings.append(Finding(
            "RNB-G006", rel, 0, edge,
            "producer can emit row counts %s the consumer never "
            "warmed (warmed: %s) — each is a silent recompile in the "
            "measured window; align 'row_buckets'/'max_rows' across "
            "the edge" % (uncovered, sorted(warmed))))


def check_configs(paths: List[str], root: str = ".") -> List[Finding]:
    findings: List[Finding] = []
    for path in paths:
        findings.extend(check_config(path, root))
    return findings
