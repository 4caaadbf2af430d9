"""Telemetry schema checker: stamps, log-meta lines, trailers, counters.

Counterpart of ``rnb_tpu/analysis/schema.py`` over the port: the
registries are :mod:`rnb_tpu_torch.telemetry`'s, the writers the port's
modules, and the reader the port's own :mod:`rnb_tpu_torch.parse_utils`.
This checker extracts what the package *actually writes* (every ``TimeCard.record`` stamp,
every content-stamp attribute, every ``log-meta.txt`` line prefix,
every ``# <kind>`` table trailer, every ``key=value`` counter in the
Faults:/Cache: lines) and cross-checks it against the declared
registries in :mod:`rnb_tpu_torch.telemetry` AND against what
``rnb_tpu_torch/parse_utils.py`` parses — so a stamp can never again
silently vanish from reports.

Rules
-----
* ``RNB-T001`` unregistered-stamp: a ``.record("...")`` site writes a
  stamp pattern the ``STAMP_REGISTRY`` does not declare.
* ``RNB-T002`` unparsed-stamp: a registered stamp pattern that
  ``rnb_tpu_torch/parse_utils.py`` never references — it would be recorded
  but invisible to every report.
* ``RNB-T003`` dead-registry-entry: a registered stamp/meta-line/
  trailer that no code path writes anymore.
* ``RNB-T004`` unregistered-meta-or-trailer: a log-meta line prefix or
  table-trailer kind written somewhere but missing from its registry.
* ``RNB-T005`` unparsed-meta-or-trailer: a registered meta-line prefix
  or trailer kind ``parse_utils`` never checks for.
* ``RNB-T006`` result-field-drift: a ``key=value`` counter written to
  the Faults:/Cache:/Staging:/Autotune:/Trace:/Ragged:/Handoff:/
  Padding:/Compute:/Memory:/Critpath:/Whatif:/Operator:/Stacks:
  log-meta lines with no matching ``BenchmarkResult`` field (or vice
  versa for those counter families; dict-valued fields — bucket
  counts, per-edge overflows, compile signatures, warmup seconds —
  ride their own JSON meta lines and are exempt).
* ``RNB-T007`` unregistered-content-stamp: an attribute stamped onto a
  TimeCard (``time_card.x = ...``) that is neither a core TimeCard
  attribute nor declared in ``CONTENT_STAMPS`` — it would silently
  fail to survive fork/merge. Attributes in ``TRANSIENT_STAMPS`` are
  also accepted: those are DECLARED single-owner carriers (live page
  pins, insert obligations) that must NOT be copied onto a fork.
* ``RNB-T008`` unregistered-trace-event: a ``trace.span`` /
  ``trace.instant`` / ``trace.counter`` / ``trace.name`` site emits an
  event name ``TRACE_EVENT_REGISTRY`` does not declare (the reverse —
  a registered event no site emits — is an RNB-T003 dead entry).
* ``RNB-T009`` unregistered-metric: a ``metrics.counter`` /
  ``metrics.gauge`` / ``metrics.observe`` / ``metrics.mark`` /
  ``metrics.name`` site emits a series name ``METRIC_REGISTRY`` does
  not declare (mirror of RNB-T008 for the live-metrics plane; the
  reverse — a ``site``-sourced registry entry with no remaining call
  site — is an RNB-T003 dead entry; ``bridge``/``poll``/``derived``
  entries have no call sites by design and are exempt).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from rnb_tpu_torch.analysis.findings import (Finding, package_py_files,
                                             parse_py)
from rnb_tpu_torch.telemetry import (CONTENT_STAMPS, META_LINE_REGISTRY,
                                     METRIC_REGISTRY, STAMP_REGISTRY,
                                     TABLE_TRAILER_REGISTRY,
                                     TRACE_EVENT_REGISTRY, TRANSIENT_STAMPS)

#: repo-relative homes of the registries and of the reader, for the
#: findings that point at them
TELEMETRY_REL = "rnb_tpu_torch/telemetry.py"
PARSE_UTILS_REL = "rnb_tpu_torch/parse_utils.py"

#: core TimeCard attributes (assignments to these are state, not
#: content stamps)
TIMECARD_ATTRS = {"timings", "id", "sub_id", "num_parent_timings",
                  "devices", "status", "failure_reason"}

#: local variable names treated as TimeCard receivers at stamp sites
TIMECARD_NAMES = {"time_card", "tc", "card", "in_card", "out_card",
                  "merged", "child"}

#: bare-function stamp recorders whose SECOND argument is the stamp
#: key (card-first calling convention)
STAMP_WRAPPERS = {"_record_clamped"}

#: modules whose span/instant/counter/name calls emit trace events
#: (rnb_tpu_torch.trace imported as either name)
TRACE_MODULE_NAMES = {"trace", "trace_mod"}

#: rnb_tpu_torch.trace entry points that take an event name first
TRACE_CALL_ATTRS = {"span", "instant", "counter", "name"}

#: modules whose counter/gauge/observe/mark/name calls emit live
#: metrics (rnb_tpu_torch.metrics imported as either name)
METRIC_MODULE_NAMES = {"metrics", "metrics_mod"}

#: rnb_tpu_torch.metrics entry points that take a series name first
METRIC_CALL_ATTRS = {"counter", "gauge", "observe", "mark", "name"}

_FMT_PLACEHOLDER = re.compile(r"%[0-9.]*[sdf]")


def _pattern_of(value: str) -> str:
    """Normalize a %-format stamp literal to a registry pattern."""
    return _FMT_PLACEHOLDER.sub("{step}", value)


_BRACE_FIELD = re.compile(r"\{[^{}]*\}")


def _fmt_string(node) -> Optional[str]:
    """The string template behind an expression, whatever formatting
    idiom wrote it: a constant, the left side of ``"..." % args``, an
    f-string (interpolations become ``{step}``), or
    ``"...".format(...)``. A site the checker cannot see is a site
    that drifts, so every literal-bearing shape must resolve."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
        return _fmt_string(node.left)
    if isinstance(node, ast.JoinedStr):
        parts = []
        for value in node.values:
            if isinstance(value, ast.Constant) \
                    and isinstance(value.value, str):
                parts.append(value.value)
            else:
                parts.append("{step}")
        return "".join(parts)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "format":
        literal = _fmt_string(node.func.value)
        if literal is not None:
            return _BRACE_FIELD.sub("{step}", literal)
    return None


_parse = parse_py


def _rel(path: str, root: str) -> str:
    return os.path.relpath(path, root).replace(os.sep, "/")


def _bindings(tree) -> Tuple[Dict[str, List[str]], Dict[str, List[str]]]:
    """Names bound to a string template anywhere in a module, and names
    bound to a dict literal of string values: a stamp key hoisted out of
    a hot loop (``key_start = "inference%d_start" % step``) or looked up
    in a table of templates is still a site the checker must see."""
    names: Dict[str, List[str]] = {}
    tables: Dict[str, List[str]] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        literal = _fmt_string(node.value)
        if literal is not None:
            names.setdefault(name, []).append(literal)
        elif isinstance(node.value, ast.Dict) and node.value.values \
                and all(isinstance(v, ast.Constant)
                        and isinstance(v.value, str)
                        for v in node.value.values):
            tables[name] = [v.value for v in node.value.values]
    return names, tables


def _templates(node, bindings) -> List[str]:
    """The string templates a key expression can take: a literal form
    (:func:`_fmt_string`), a name bound to one, or a lookup in a table
    of them (``TABLE[k] % step``)."""
    names, tables = bindings
    literal = _fmt_string(node)
    if literal is not None:
        return [literal]
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
        node = node.left
    if isinstance(node, ast.Name):
        return list(names.get(node.id, ()))
    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name):
        return list(tables.get(node.value.id, ()))
    return []


def _code_literals(src: str) -> List[str]:
    """String constants in ``src`` excluding docstrings — the 'does
    the parser reference this name' checks must not be satisfied by a
    comment or docstring mention of a stamp (deleting the parsing code
    while leaving the docstring would otherwise stay green). Snippets
    that do not parse fall back to whole-source matching."""
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return [src]
    doc_ids = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = getattr(node, "body", [])
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                doc_ids.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in doc_ids]


# -- extraction -------------------------------------------------------

def extract_stamps(py_paths: Sequence[str], root: str = "."
                   ) -> List[Tuple[str, int, str]]:
    """Every literal/%-format stamp recorded anywhere, through a name or
    a table bound to templates too (:func:`_templates`):
    -> [(relpath, line, pattern)]. Keys that resolve to no template (the
    TimeCardList fan-out re-recording a parameter) are skipped."""
    out = []
    for path in py_paths:
        rel = _rel(path, root)
        tree = _parse(path)
        bindings = _bindings(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            key = None
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "record" and node.args:
                key = node.args[0]
            elif isinstance(node.func, ast.Name) \
                    and node.func.id in STAMP_WRAPPERS \
                    and len(node.args) >= 2:
                # stamp-recording helpers take (card, key, ...): the
                # clamped phase-refinement recorder must stay visible
                # to the registry cross-check or its stamps would read
                # as dead entries
                key = node.args[1]
            if key is not None:
                out.extend((rel, node.lineno, _pattern_of(literal))
                           for literal in _templates(key, bindings))
    return out


def extract_content_stamps(py_paths: Sequence[str], root: str = "."
                           ) -> List[Tuple[str, int, str]]:
    """Attribute assignments onto TimeCard-named receivers:
    -> [(relpath, line, attr)]."""
    out = []
    for path in py_paths:
        rel = _rel(path, root)
        for node in ast.walk(_parse(path)):
            if not isinstance(node, ast.Assign):
                continue
            for target in node.targets:
                if isinstance(target, ast.Attribute) \
                        and isinstance(target.value, ast.Name) \
                        and target.value.id in TIMECARD_NAMES:
                    out.append((rel, node.lineno, target.attr))
    return out


def extract_meta_prefixes(benchmark_path: str, root: str = "."
                          ) -> List[Tuple[str, int, str]]:
    """``<Prefix>:`` log-meta line prefixes written via ``.write()``
    in the launcher: -> [(relpath, line, prefix-with-colon)]."""
    rel = _rel(benchmark_path, root)
    out = []
    prefix_re = re.compile(r"^([A-Z][A-Za-z0-9_ ]*:)\s")
    for node in ast.walk(_parse(benchmark_path)):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "write" and node.args:
            literal = _fmt_string(node.args[0])
            if literal is None:
                continue
            m = prefix_re.match(literal)
            if m:
                out.append((rel, node.lineno, m.group(1)))
    return out


def extract_trailer_kinds(telemetry_path: str, root: str = "."
                          ) -> List[Tuple[str, int, str]]:
    """``# <kind>`` table-trailer kinds appearing as string literals in
    the telemetry module: -> [(relpath, line, kind)]."""
    rel = _rel(telemetry_path, root)
    out = []
    kind_re = re.compile(r"^# (\w+)[ \n]")
    for node in ast.walk(_parse(telemetry_path)):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            m = kind_re.match(node.value)
            if m:
                out.append((rel, getattr(node, "lineno", 0), m.group(1)))
    return out


#: counter-carrying log-meta lines and the BenchmarkResult field
#: prefix their ``key=value`` tokens map to (the same mapping
#: parse_utils applies when flattening the meta dict)
COUNTER_LINE_PREFIXES = {"Faults:": "", "Cache:": "cache_",
                         "Staging:": "staging_",
                         "Autotune:": "autotune_",
                         "Trace:": "trace_",
                         "Ragged:": "ragged_",
                         "Shard:": "shard_",
                         "Handoff:": "handoff_",
                         "Padding:": "",
                         "Health:": "health_",
                         "Deadline:": "deadline_",
                         "Hedge:": "hedges_",
                         "Metrics:": "metrics_",
                         "Slo:": "slo_",
                         "Compute:": "compute_",
                         "Memory:": "memory_",
                         "Critpath:": "critpath_",
                         "Whatif:": "whatif_",
                         "Operator:": "operator_",
                         "Stacks:": "stacks_",
                         "Net:": "net_",
                         "Net errors:": "net_err_",
                         "Locks:": "locks_"}

#: verbatim-named counter fields (prefix "") the reverse RNB-T006
#: direction holds to a meta-line counter — the Faults: trio plus the
#: Padding: line's fields
VERBATIM_COUNTER_FIELDS = ("num_failed", "num_shed", "num_retries",
                           "pad_rows", "total_rows", "pad_emissions")


def extract_meta_counter_keys(benchmark_path: str) -> Dict[str, Set[str]]:
    """``key=value`` counter names inside the Faults:/Cache:/Staging:
    log-meta format strings: -> {"Faults:": {...}, ...}."""
    keys: Dict[str, Set[str]] = {}
    key_re = re.compile(r"(\w+)=%")
    for node in ast.walk(_parse(benchmark_path)):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "write" and node.args:
            literal = _fmt_string(node.args[0])
            if literal is None:
                continue
            for prefix in COUNTER_LINE_PREFIXES:
                if literal.startswith(prefix):
                    keys.setdefault(prefix, set()).update(
                        key_re.findall(literal))
    return keys


def extract_metric_names(py_paths: Sequence[str], root: str = "."
                         ) -> List[Tuple[str, int, str]]:
    """Every literal series name passed to a live-metrics entry point
    (``metrics.counter(...)`` / ``.gauge`` / ``.observe`` / ``.mark``
    / ``.name``): -> [(relpath, line, pattern)]. Prebuilt names
    flowing through variables are covered at their ``metrics.name``
    build site, exactly like the trace extractor."""
    out = []
    for path in py_paths:
        rel = _rel(path, root)
        for node in ast.walk(_parse(path)):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in METRIC_CALL_ATTRS \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id in METRIC_MODULE_NAMES \
                    and node.args:
                literal = _fmt_string(node.args[0])
                if literal is not None:
                    out.append((rel, node.lineno, _pattern_of(literal)))
    return out


def extract_trace_events(py_paths: Sequence[str], root: str = "."
                         ) -> List[Tuple[str, int, str]]:
    """Every literal event name passed to a tracing entry point
    (``trace.span(...)`` / ``.instant`` / ``.counter`` / ``.name``):
    -> [(relpath, line, pattern)]. Prebuilt names flowing through
    variables are covered at their ``trace.name`` build site."""
    out = []
    for path in py_paths:
        rel = _rel(path, root)
        for node in ast.walk(_parse(path)):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in TRACE_CALL_ATTRS \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id in TRACE_MODULE_NAMES \
                    and node.args:
                literal = _fmt_string(node.args[0])
                if literal is not None:
                    out.append((rel, node.lineno, _pattern_of(literal)))
    return out


# -- checks -----------------------------------------------------------

def check_stamps(py_paths: Sequence[str], parse_utils_src: str,
                 root: str = ".", registry=STAMP_REGISTRY
                 ) -> List[Finding]:
    findings: List[Finding] = []
    sites = extract_stamps(py_paths, root)
    registered = {spec.pattern for spec in registry}
    for rel, line, pattern in sites:
        if pattern not in registered:
            findings.append(Finding(
                "RNB-T001", rel, line, pattern,
                "stamp %r is not declared in telemetry.STAMP_REGISTRY "
                "— register it (and teach parse_utils) or remove the "
                "site" % pattern))
    produced = {pattern for _, _, pattern in sites}
    literals = _code_literals(parse_utils_src)
    for spec in registry:
        if spec.pattern not in produced:
            findings.append(Finding(
                "RNB-T003", TELEMETRY_REL, 0, spec.pattern,
                "registered stamp %r has no remaining record() site"
                % spec.pattern))
        concrete = spec.pattern.replace("{step}", "0")
        # the reader spells a template with %d ("inference%d_finish")
        if not any(concrete in lit or spec.pattern in _pattern_of(lit)
                   for lit in literals):
            findings.append(Finding(
                "RNB-T002", PARSE_UTILS_REL, 0, spec.pattern,
                "registered stamp %r is never referenced by "
                "parse_utils code — it would vanish from every report"
                % spec.pattern))
    return findings


def check_content_stamps(py_paths: Sequence[str], root: str = ".",
                         content=CONTENT_STAMPS) -> List[Finding]:
    findings: List[Finding] = []
    allowed = TIMECARD_ATTRS | set(content) | set(TRANSIENT_STAMPS)
    for rel, line, attr in extract_content_stamps(py_paths, root):
        if attr not in allowed:
            findings.append(Finding(
                "RNB-T007", rel, line, attr,
                "attribute %r stamped onto a TimeCard is not in "
                "telemetry.CONTENT_STAMPS — it would not survive "
                "fork/merge" % attr))
    return findings


def check_meta_lines(benchmark_path: str, parse_utils_src: str,
                     root: str = ".", registry=META_LINE_REGISTRY
                     ) -> List[Finding]:
    findings: List[Finding] = []
    written = extract_meta_prefixes(benchmark_path, root)
    registered = {spec.pattern for spec in registry}
    for rel, line, prefix in written:
        if prefix not in registered:
            findings.append(Finding(
                "RNB-T004", rel, line, prefix,
                "log-meta line %r is not declared in "
                "telemetry.META_LINE_REGISTRY" % prefix))
    produced = {p for _, _, p in written}
    literals = _code_literals(parse_utils_src)
    for spec in registry:
        if spec.pattern not in produced:
            findings.append(Finding(
                "RNB-T003", TELEMETRY_REL, 0, spec.pattern,
                "registered log-meta line %r is never written"
                % spec.pattern))
        # the reader keys a line by its head, the prefix less its colon
        head = spec.pattern[:-1]
        if not any(spec.pattern in lit or lit == head for lit in literals):
            findings.append(Finding(
                "RNB-T005", PARSE_UTILS_REL, 0, spec.pattern,
                "registered log-meta line %r is never parsed by "
                "parse_utils code" % spec.pattern))
    return findings


def check_trailers(telemetry_path: str, parse_utils_src: str,
                   root: str = ".", registry=TABLE_TRAILER_REGISTRY
                   ) -> List[Finding]:
    findings: List[Finding] = []
    written = extract_trailer_kinds(telemetry_path, root)
    registered = {spec.pattern for spec in registry}
    for rel, line, kind in written:
        if kind not in registered:
            findings.append(Finding(
                "RNB-T004", rel, line, kind,
                "table trailer kind %r is not declared in "
                "telemetry.TABLE_TRAILER_REGISTRY" % kind))
    produced = {k for _, _, k in written}
    literals = _code_literals(parse_utils_src)
    for spec in registry:
        if spec.pattern not in produced:
            findings.append(Finding(
                "RNB-T003", TELEMETRY_REL, 0, spec.pattern,
                "registered trailer kind %r is never written"
                % spec.pattern))
        if spec.pattern not in literals:
            findings.append(Finding(
                "RNB-T005", PARSE_UTILS_REL, 0, spec.pattern,
                "registered trailer kind %r is never consumed by "
                "parse_utils code" % spec.pattern))
    return findings


def check_trace_events(py_paths: Sequence[str], root: str = ".",
                       registry=TRACE_EVENT_REGISTRY) -> List[Finding]:
    """RNB-T008 both ways: every emitted trace event name must be
    declared in ``telemetry.TRACE_EVENT_REGISTRY``, and every declared
    event must still have an emitting site (else RNB-T003) — so the
    trace.json vocabulary can neither drift silently nor rot."""
    findings: List[Finding] = []
    sites = extract_trace_events(py_paths, root)
    registered = {spec.pattern for spec in registry}
    for rel, line, pattern in sites:
        if pattern not in registered:
            findings.append(Finding(
                "RNB-T008", rel, line, pattern,
                "trace event %r is not declared in "
                "telemetry.TRACE_EVENT_REGISTRY — register it or "
                "remove the instrumentation site" % pattern))
    produced = {pattern for _, _, pattern in sites}
    for spec in registry:
        if spec.pattern not in produced:
            findings.append(Finding(
                "RNB-T003", TELEMETRY_REL, 0, spec.pattern,
                "registered trace event %r has no remaining "
                "instrumentation site" % spec.pattern))
    return findings


def check_metric_names(py_paths: Sequence[str], root: str = ".",
                       registry=METRIC_REGISTRY) -> List[Finding]:
    """RNB-T009 both ways: every series name a
    ``metrics.counter/gauge/observe/mark/name`` site emits must be
    declared in ``telemetry.METRIC_REGISTRY``, and every declared
    ``site``-sourced series must still have an emitting site (else
    RNB-T003). ``bridge``/``poll``/``derived`` entries are fed from
    trace events, snapshot polls or registry internals — no call site
    exists by design, so only the forward direction applies to them
    (the runtime registry separately rejects undeclared names)."""
    findings: List[Finding] = []
    sites = extract_metric_names(py_paths, root)
    registered = {spec.pattern for spec in registry}
    for rel, line, pattern in sites:
        if pattern not in registered:
            findings.append(Finding(
                "RNB-T009", rel, line, pattern,
                "metric %r is not declared in "
                "telemetry.METRIC_REGISTRY — register it (with its "
                "kind and source) or remove the call site" % pattern))
    produced = {pattern for _, _, pattern in sites}
    for spec in registry:
        if getattr(spec, "source", "site") == "site" \
                and spec.pattern not in produced:
            findings.append(Finding(
                "RNB-T003", TELEMETRY_REL, 0, spec.pattern,
                "registered site-sourced metric %r has no remaining "
                "call site" % spec.pattern))
    return findings


def check_benchmark_result(benchmark_path: str, root: str = "."
                           ) -> List[Finding]:
    """Every counter written to the Faults:/Cache: log-meta lines must
    be a BenchmarkResult field (Faults: verbatim; Cache: with the
    ``cache_`` prefix — the same mapping parse_utils applies)."""
    import dataclasses

    from rnb_tpu_torch.benchmark import BenchmarkResult
    rel = _rel(benchmark_path, root)
    fields = {f.name for f in dataclasses.fields(BenchmarkResult)}
    findings: List[Finding] = []
    written = extract_meta_counter_keys(benchmark_path)
    mapped: Set[str] = set()
    for prefix, keys in sorted(written.items()):
        for key in sorted(keys):
            field = COUNTER_LINE_PREFIXES[prefix] + key
            mapped.add(field)
            if field not in fields:
                findings.append(Finding(
                    "RNB-T006", rel, 0, field,
                    "%s line writes %r but BenchmarkResult has no %r "
                    "field — programmatic callers cannot see the "
                    "counter the log records" % (prefix, key, field)))
    # reverse direction for the same counter families: a result field
    # nothing writes to the meta line is invisible to offline parsing
    # (parse_utils reads log-meta, not BenchmarkResult). Dict-valued
    # fields (bucket counts, per-edge overflows) ride their own JSON
    # meta lines, not key=value counters, so they are exempt here —
    # recognized by their shared default_factory, not by spelling of
    # the annotation (which `dict[...]`/`Mapping[...]` would break).
    dict_fields = {f.name for f in dataclasses.fields(BenchmarkResult)
                   if f.default_factory is dict}
    for field in sorted(fields - dict_fields):
        if field in VERBATIM_COUNTER_FIELDS \
                or field.startswith("cache_") \
                or field.startswith("staging_") \
                or field.startswith("autotune_") \
                or field.startswith("trace_") \
                or field.startswith("ragged_") \
                or field.startswith("shard_") \
                or field.startswith("handoff_") \
                or field.startswith("health_") \
                or field.startswith("deadline_") \
                or field.startswith("hedges_") \
                or field.startswith("metrics_") \
                or field.startswith("slo_") \
                or field.startswith("compute_") \
                or field.startswith("memory_") \
                or field.startswith("critpath_") \
                or field.startswith("whatif_") \
                or field.startswith("operator_") \
                or field.startswith("stacks_") \
                or field.startswith("net_") \
                or field.startswith("locks_"):
            if field not in mapped:
                findings.append(Finding(
                    "RNB-T006", rel, 0, field,
                    "BenchmarkResult.%s has no matching counter in "
                    "the Faults:/Cache:/Staging: log-meta lines — "
                    "offline parsing cannot recover it" % field))
    return findings


def check_repo(root: str = ".") -> List[Finding]:
    """The full schema-checker family over one repo checkout."""
    package = os.path.join(root, "rnb_tpu_torch")
    parse_utils = os.path.join(package, "parse_utils.py")
    benchmark = os.path.join(package, "benchmark.py")
    telemetry = os.path.join(package, "telemetry.py")
    with open(parse_utils) as f:
        parse_src = f.read()
    py_files = package_py_files(package)
    findings = []
    findings.extend(check_stamps(py_files, parse_src, root))
    findings.extend(check_content_stamps(py_files, root))
    findings.extend(check_meta_lines(benchmark, parse_src, root))
    findings.extend(check_trailers(telemetry, parse_src, root))
    findings.extend(check_trace_events(py_files, root))
    findings.extend(check_metric_names(py_files, root))
    findings.extend(check_benchmark_result(benchmark, root))
    return findings
