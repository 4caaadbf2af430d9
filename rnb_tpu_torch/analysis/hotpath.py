"""Hot-path AST lint: host-sync and import hygiene, statically.

Counterpart of ``rnb_tpu/analysis/hotpath.py`` over ``rnb_tpu_torch/``.
The rules that name JAX's calls take their PyTorch form: a CUDA graph's
captured body in place of a jitted one, the card's syncs and host reads
in place of ``block_until_ready`` and ``np.asarray``, ``.to(device)``
in place of ``device_put``.

What counts as *hot*: the executor's thread entry
(``rnb_tpu_torch/runner.py::runner``) and every stage-contract entry
point — ``__call__``, ``submit``, ``complete``, ``poll``, ``select`` —
plus everything reachable from them through same-module
``self.method()`` / bare-function calls (an intra-module call graph;
cross-module calls are out of scope and covered by linting the callee's
own module).

Rules
-----
* ``RNB-H001`` graph-host-sync: a host sync or host read (``.item()``,
  ``.cpu()``, ``.numpy()``, ``.tolist()``, ``torch.cuda.synchronize``,
  ``float()``/``int()`` of a tensor, ``time.*``, ``print``) inside a
  body captured into a CUDA graph — the block under
  ``torch.cuda.graph(...)`` and the same-module functions it calls. A
  capture records device work only: a sync there raises, and a host
  value is read once at capture and replayed stale forever after.
* ``RNB-H002`` hot-import: an ``import`` statement inside a hot
  function — per-request interpreter import machinery; hoist to the
  module top.
* ``RNB-H003`` transfer-in-loop: a host-to-device move (``.to(<a
  device>)``, ``.cuda()``, ``torch.as_tensor(..., device=...)``, or
  ``copy_`` from a host tensor) inside a ``for`` / ``while`` loop or a
  comprehension of a hot function — per-item transfers serialize on
  transfer latency; batch first, transfer once.
* ``RNB-H004`` fault-nondeterminism: wall-clock (``time.time``) or
  unseeded RNG (``random.*``, ``np.random.*``, ``datetime.now``) in
  deterministic fault-injection code (``faults.py`` and any
  ``*FaultPlan*`` class) — injection schedules must be reproducible.
* ``RNB-H005`` ring-write-before-shed: within one function, a write
  into an ``output_ring`` slot at a line preceding the shed decision
  (``_shed_item``) — a written-but-never-signalled slot deadlocks the
  producer on the next wrap-around.
* ``RNB-H006`` host-sync-in-hot-path: ``.synchronize()``, ``.item()``,
  ``.cpu()``, ``.tolist()``, or ``float()``/``int()`` of a tensor in a
  hot function — each waits for the card's queue up to it. A
  deliberate sync belongs in the baseline with its justification,
  everything else is a stall of the executor thread.
* ``RNB-H007`` bucket-alloc-per-emission: ``np.empty``/``np.zeros`` of
  a bucket/batch shape (an argument referencing a ``_batch_shape``-style
  helper) in a hot function — decode into a
  :class:`rnb_tpu_torch.staging.StagingPool` slot instead, and baseline
  the copy fallback with its justification.
* ``RNB-H008`` host-materialization-on-device-edge: ``.cpu()``,
  ``.numpy()`` or ``.tolist()`` inside a device-resident handoff path —
  a ``*Handoff*`` class method (or a module-level function of a
  ``handoff*.py`` module) whose name has no ``host`` component. The
  device-resident edge (:mod:`rnb_tpu_torch.handoff`) promises zero
  host-hop bytes; route the call through a ``*host*``-named method or
  fix it.
* ``RNB-H009`` unbounded-blocking-wait: a no-argument ``.get()`` /
  ``.wait()`` / ``.acquire()`` / ``.result()`` call without a
  ``timeout`` keyword in a hot path (or any ``wait`` method), and a
  socket verb with no ``settimeout``/``gettimeout`` in its function —
  a consumer blocked forever on a dead producer hangs the drain path
  past every containment mechanism.
* ``RNB-H010`` device-alloc-per-emission: ``torch.empty``/``zeros``/
  ``ones``/``full`` with a ``device=`` and a stage-declared shape in a
  hot function outside ``rnb_tpu_torch/pager.py`` — the device twin of
  RNB-H007. A fresh pool-shaped device tensor per emission churns the
  caching allocator the page allocator (:mod:`rnb_tpu_torch.pager`)
  exists to avoid; allocate once at stage init and reuse, or baseline a
  deliberate fallback with its justification.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from rnb_tpu_torch.analysis.findings import (Finding, package_py_files,
                                             parse_py)

#: stage-contract entry points — hot by definition
HOT_ROOT_METHODS = {"__call__", "submit", "complete", "poll", "select"}

#: module-level functions that are hot loops, keyed by path suffix
EXTRA_HOT_ROOTS = {"rnb_tpu_torch/runner.py": {"runner"}}

#: receivers recognized as the numpy module
_NP_NAMES = {"np", "numpy"}

#: zero-argument tensor methods that read the card's result back to the
#: host — each waits for the queue up to it
_HOST_READS = {"item", "cpu", "tolist"}


def _qual(owner: Optional[str], name: str) -> str:
    return "%s.%s" % (owner, name) if owner else name


def _chain(node) -> Tuple[str, ...]:
    """``a.b.c`` -> ("a", "b", "c"); () for non-name chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _is_graph_capture(node) -> bool:
    """``torch.cuda.graph(...)`` (or ``cuda.graph(...)``)."""
    return isinstance(node, ast.Call) \
        and _chain(node.func)[-2:] == ("cuda", "graph")


class _ModuleIndex(ast.NodeVisitor):
    """Collect defs, class structure and CUDA-graph capture blocks."""

    def __init__(self):
        self.functions: Dict[str, ast.AST] = {}   # qualname -> def node
        self.class_bases: Dict[str, List[str]] = {}
        self.class_methods: Dict[str, Set[str]] = {}
        #: (qualname of the enclosing def, the ``with`` node)
        self.captures: List[Tuple[str, ast.With]] = []
        self._class: Optional[str] = None
        self._stack: List[str] = []  # enclosing function names
        self._quals: List[str] = []  # enclosing function qualnames

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        prev, self._class = self._class, node.name
        self.class_bases[node.name] = [
            b.id if isinstance(b, ast.Name) else
            b.attr if isinstance(b, ast.Attribute) else ""
            for b in node.bases]
        self.class_methods[node.name] = set()
        self.generic_visit(node)
        self._class = prev

    def _visit_def(self, node) -> None:
        qual = _qual(self._class,
                     ".".join(self._stack + [node.name]))
        if qual in self.functions:
            # same-name defs (e.g. per-branch closures): keep each
            # registered so every variant gets linted. The suffix is an
            # occurrence ordinal — stable for baselining (no line
            # numbers, no '#' which baseline syntax reserves for
            # justifications)
            ordinal = 2
            while "%s~%d" % (qual, ordinal) in self.functions:
                ordinal += 1
            qual = "%s~%d" % (qual, ordinal)
        self.functions[qual] = node
        if self._class is not None and not self._stack:
            self.class_methods[self._class].add(node.name)
        self._stack.append(node.name)
        self._quals.append(qual)
        self.generic_visit(node)
        self._quals.pop()
        self._stack.pop()

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    def visit_With(self, node: ast.With) -> None:
        if self._quals and any(_is_graph_capture(item.context_expr)
                               for item in node.items):
            self.captures.append((self._quals[-1], node))
        self.generic_visit(node)


def _own_walk(node):
    """ast.walk over a function's OWN statements, not descending into
    nested function defs — nested defs are registered under their own
    qualname and linted there, so one call site yields one finding
    with one stable anchor (never a parent+closure duplicate)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        sub = stack.pop()
        yield sub
        if not isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(ast.iter_child_nodes(sub))


def _attr_chain_has(node, names: Set[str]) -> bool:
    """Does any Name/attr component of an expression match ``names``?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in names:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in names:
            return True
    return False


def _method_owner(index: _ModuleIndex, cls: str, method: str
                  ) -> Optional[str]:
    """Resolve ``self.method`` against a class and its in-module
    ancestors; -> owning class name or None."""
    seen = set()
    stack = [cls]
    while stack:
        c = stack.pop()
        if c in seen or c not in index.class_methods:
            continue
        seen.add(c)
        if method in index.class_methods[c]:
            return c
        stack.extend(index.class_bases.get(c, ()))
    return None


def _callees(index: _ModuleIndex, qual: Optional[str], node) -> List[str]:
    """Same-module functions ``node``'s calls resolve to: ``self.m()``
    against the class of ``qual``, bare names against module defs."""
    cls = qual.split(".", 1)[0] if qual and "." in qual else None
    out = []
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        f = sub.func
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id == "self" and cls is not None):
            owner = _method_owner(index, cls, f.attr)
            if owner is not None:
                out.append(_qual(owner, f.attr))
        elif isinstance(f, ast.Name) and f.id in index.functions:
            out.append(f.id)
    return out


def _hot_set(index: _ModuleIndex, rel: str) -> Set[str]:
    """Qualnames reachable from the hot roots via the intra-module
    call graph."""
    roots: List[str] = []
    for cls, methods in index.class_methods.items():
        for m in methods & HOT_ROOT_METHODS:
            roots.append(_qual(cls, m))
    for suffix, names in EXTRA_HOT_ROOTS.items():
        if rel.endswith(suffix):
            roots.extend(n for n in names if n in index.functions)
    hot: Set[str] = set()
    stack = list(roots)
    while stack:
        qual = stack.pop()
        if qual in hot or qual not in index.functions:
            continue
        hot.add(qual)
        # closures of a hot function run on the same hot path; they
        # are linted under their own qualname (one finding per site)
        prefix = qual + "."
        stack.extend(q for q in index.functions
                     if q.startswith(prefix))
        stack.extend(_callees(index, qual, index.functions[qual]))
    return hot


#: attribute accesses that make an int()/float() argument static
#: metadata (a host value already) rather than a tensor's
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "numel", "nbytes",
                 "element_size", "dim"}

def _is_tensor_expr(node) -> bool:
    """Does an int()/float() argument read a tensor's value? It names
    ``torch`` (the reference's rule names ``jax``/``jnp``)."""
    return _attr_chain_has(node, {"torch"})


def _host_sync_kind(node: ast.Call) -> Optional[str]:
    """Classify one call as a sync with the card, or None."""
    f = node.func
    if isinstance(f, ast.Attribute) and not node.args:
        if f.attr == "synchronize":
            return ".synchronize()"
        if f.attr in _HOST_READS:
            return ".%s()" % f.attr
    if isinstance(f, ast.Name) and f.id in ("float", "int") \
            and len(node.args) == 1:
        arg = node.args[0]
        if not _attr_chain_has(arg, _STATIC_ATTRS) and _is_tensor_expr(arg):
            return "%s() of a tensor" % f.id
    return None


def _captured_sync_kind(node: ast.Call) -> Optional[str]:
    """Classify one call inside a captured body, or None (RNB-H001)."""
    kind = _host_sync_kind(node)
    if kind is not None:
        return kind
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr == "numpy" and not node.args:
        return ".numpy()"
    if isinstance(f, ast.Name) and f.id == "print":
        return "print()"
    if isinstance(f, ast.Name) and f.id in ("float", "int") and node.args \
            and not all(_attr_chain_has(a, _STATIC_ATTRS)
                        for a in node.args):
        # int(x.shape[0]) & friends are host shape arithmetic, legal in
        # a capture; any other value may be a tensor's
        return "%s()" % f.id
    chain = _chain(f)
    if len(chain) == 2 and chain[0] == "time":
        return "time.%s()" % chain[1]
    return None


def _lint_captured(rel: str, index: _ModuleIndex,
                   findings: List[Finding]) -> Set[str]:
    """RNB-H001 over every ``torch.cuda.graph`` block and the
    same-module functions it reaches; -> the captured qualnames."""
    seen_sites: Set[int] = set()
    captured: Set[str] = set()

    def lint(qual: str, nodes) -> None:
        for top in nodes:
            for sub in [top] + list(_own_walk(top)):
                if not isinstance(sub, ast.Call) or id(sub) in seen_sites:
                    continue
                kind = _captured_sync_kind(sub)
                if kind is None:
                    continue
                seen_sites.add(id(sub))
                findings.append(Finding(
                    "RNB-H001", rel, sub.lineno, qual,
                    "%s inside a body captured into a CUDA graph — a sync "
                    "breaks the capture, a host value replays stale"
                    % kind))

    stack: List[str] = []
    for qual, with_node in index.captures:
        lint(qual, with_node.body)
        for stmt in with_node.body:
            stack.extend(_callees(index, qual, stmt))
    while stack:
        qual = stack.pop()
        if qual in captured or qual not in index.functions:
            continue
        captured.add(qual)
        node = index.functions[qual]
        lint(qual, node.body)
        stack.extend(_callees(index, qual, node))
    return captured


#: every looping construct a per-item transfer can hide in
_LOOP_NODES = (ast.For, ast.AsyncFor, ast.While, ast.ListComp,
               ast.SetComp, ast.DictComp, ast.GeneratorExp)

#: helper names whose result is a bucket/batch shape — an allocation
#: over one of these on a hot path is per-emission (RNB-H007, H010)
_BATCH_SHAPE_HELPERS = {"_batch_shape", "batch_shape", "bucket_shape",
                        "_wire_batch_shape"}

#: names that mark a ``copy_`` source as host memory (RNB-H003)
_HOST_SOURCE_MARKS = {"from_numpy", "numpy", "np", "host", "pinned",
                      "cpu"}


def _names_a_device(node) -> bool:
    """Is a ``.to()`` argument a device (not a dtype)?"""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith(("cuda", "cpu"))
    for sub in ast.walk(node):
        name = sub.id if isinstance(sub, ast.Name) else \
            sub.attr if isinstance(sub, ast.Attribute) else ""
        if "device" in name.lower() or name == "cuda":
            return True
    return False


def _transfer_kind(node: ast.Call) -> Optional[str]:
    """Classify one call as a host-to-device move, or None (RNB-H003)."""
    f = node.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr == "cuda":
        return ".cuda()"
    if f.attr == "to" and (any(_names_a_device(a) for a in node.args)
                           or any(kw.arg == "device"
                                  for kw in node.keywords)):
        return ".to(<a device>)"
    if f.attr in ("as_tensor", "tensor") \
            and _chain(f.value) == ("torch",) \
            and any(kw.arg == "device" for kw in node.keywords):
        return "torch.%s(..., device=...)" % f.attr
    if f.attr == "copy_" and node.args \
            and _attr_chain_has(node.args[0], _HOST_SOURCE_MARKS):
        return "copy_() from a host tensor"
    return None


def _bucket_alloc_kind(node: ast.Call) -> Optional[str]:
    """Classify one call as a bucket-shaped host allocation, or None."""
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in ("empty", "zeros") \
            and isinstance(f.value, ast.Name) \
            and f.value.id in _NP_NAMES and node.args:
        if _attr_chain_has(node.args[0], _BATCH_SHAPE_HELPERS):
            return "np.%s() of a bucket shape" % f.attr
    return None


#: the one module whose pool-shaped device allocation IS the design —
#: the page allocator's arena slab (rnb_tpu_torch.pager)
_H010_EXEMPT_BASENAMES = {"pager.py"}


def _device_alloc_kind(node: ast.Call) -> Optional[str]:
    """Classify one call as a pool/bucket-shaped DEVICE allocation
    (RNB-H010), or None: ``torch.empty/zeros/ones/full`` with a
    ``device=`` whose shape comes from a stage-declared shape helper."""
    f = node.func
    if isinstance(f, ast.Attribute) \
            and f.attr in ("empty", "zeros", "ones", "full") \
            and _chain(f.value) == ("torch",) and node.args \
            and any(kw.arg == "device" for kw in node.keywords) \
            and _attr_chain_has(node.args[0], _BATCH_SHAPE_HELPERS):
        return "torch.%s() of a stage-declared shape" % f.attr
    return None


def _lint_hot_body(rel: str, qual: str, node,
                   findings: List[Finding]) -> None:
    loop_spans: List[Tuple[int, int]] = []
    for sub in _own_walk(node):
        if isinstance(sub, _LOOP_NODES):
            loop_spans.append((sub.lineno,
                               max(getattr(sub, "end_lineno", sub.lineno),
                                   sub.lineno)))

    def in_loop(lineno: int) -> bool:
        # inclusive bounds: one-line `for ...: x.to(dev)` bodies and
        # comprehension headers are still per-item transfers
        return any(lo <= lineno <= hi for lo, hi in loop_spans)

    for sub in _own_walk(node):
        if isinstance(sub, (ast.Import, ast.ImportFrom)):
            findings.append(Finding(
                "RNB-H002", rel, sub.lineno, qual,
                "import inside a per-request hot path — hoist to the "
                "module top"))
        elif isinstance(sub, ast.Call):
            move = _transfer_kind(sub)
            if move is not None and in_loop(sub.lineno):
                findings.append(Finding(
                    "RNB-H003", rel, sub.lineno, qual,
                    "%s inside a loop on a hot path — per-item transfers "
                    "serialize; batch first, transfer once" % move))
            kind = _host_sync_kind(sub)
            if kind is not None:
                findings.append(Finding(
                    "RNB-H006", rel, sub.lineno, qual,
                    "%s on a hot path stalls the executor thread — fix "
                    "it, or baseline it with the justification" % kind))
            alloc = _bucket_alloc_kind(sub)
            if alloc is not None:
                findings.append(Finding(
                    "RNB-H007", rel, sub.lineno, qual,
                    "%s on a per-emission loader path — decode into a "
                    "staging slot (rnb_tpu_torch.staging) instead, or "
                    "baseline the copy fallback with its justification"
                    % alloc))
            if os.path.basename(rel) not in _H010_EXEMPT_BASENAMES:
                dev_alloc = _device_alloc_kind(sub)
                if dev_alloc is not None:
                    findings.append(Finding(
                        "RNB-H010", rel, sub.lineno, qual,
                        "%s on a hot path — a fresh pool-shaped device "
                        "tensor per emission churns the allocator; draw "
                        "from the page allocator (rnb_tpu_torch.pager) "
                        "or a stage-init preallocation, or baseline the "
                        "deliberate fallback with its justification"
                        % dev_alloc))


#: attribute names whose NO-ARGUMENT call blocks until someone else
#: acts — with no timeout, forever (dict.get and Queue.get(key-ish)
#: take positional args, so zero-arg calls are the queue/event/lock/
#: future shapes)
_H009_BLOCKING_ATTRS = {"get", "wait", "acquire", "result"}


def _unbounded_wait_kind(node: ast.Call) -> Optional[str]:
    """Classify one call as an unbounded blocking wait, or None."""
    f = node.func
    if not isinstance(f, ast.Attribute) \
            or f.attr not in _H009_BLOCKING_ATTRS:
        return None
    if node.args:
        return None  # positional args: dict.get(key), pool.wait(t)
    if any(kw.arg == "timeout" for kw in node.keywords):
        return None
    return ".%s()" % f.attr


#: socket verbs whose blocking is bounded only by the SOCKET's
#: configured timeout — the rule demands VISIBLE timeout discipline in
#: the enclosing function: a ``settimeout(...)`` call or a
#: ``gettimeout()`` consult (the rnb_tpu_torch.ops.wire.recv_exact
#: idiom)
_H009_SOCKET_ATTRS = {"recv", "recv_into", "accept", "connect"}

#: the in-function evidence that a socket's blocking is bounded
_H009_SOCKET_MARKERS = {"settimeout", "gettimeout"}


def _socket_wait_kind(node: ast.Call) -> Optional[str]:
    """Classify one call as a timeout-governed socket verb, or None."""
    f = node.func
    if not isinstance(f, ast.Attribute) \
            or f.attr not in _H009_SOCKET_ATTRS:
        return None
    return ".%s()" % f.attr


def _lint_unbounded_waits(rel: str, index: _ModuleIndex,
                          findings: List[Finding],
                          hot: Set[str]) -> None:
    """RNB-H009 over the hot set plus every ``wait`` method — the
    blocking leaf hot paths call through cross-object (the intra-
    module call graph cannot follow ``handle.wait()``), so the leaves
    are linted under their own anchors. Socket verbs are linted over
    EVERY function: receiver loops are thread targets the hot-root
    graph cannot reach, and the function that blocks must be the one
    seen configuring or guarding the socket's timeout."""
    scope = set(hot)
    for qual in index.functions:
        name = qual.rsplit(".", 1)[-1]
        if name == "wait":
            scope.add(qual)
    for qual in sorted(scope):
        node = index.functions.get(qual)
        if node is None:
            continue
        for sub in _own_walk(node):
            if not isinstance(sub, ast.Call):
                continue
            kind = _unbounded_wait_kind(sub)
            if kind is not None:
                findings.append(Finding(
                    "RNB-H009", rel, sub.lineno, qual,
                    "%s without a timeout on a hot/blocking path — a "
                    "dead counterpart hangs this thread forever; "
                    "bound the wait and re-check liveness each lap, "
                    "or baseline it with the justification" % kind))
    for qual in sorted(index.functions):
        node = index.functions[qual]
        bounded = any(
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr in _H009_SOCKET_MARKERS
            for sub in _own_walk(node))
        if bounded:
            continue
        for sub in _own_walk(node):
            if not isinstance(sub, ast.Call):
                continue
            kind = _socket_wait_kind(sub)
            if kind is not None:
                findings.append(Finding(
                    "RNB-H009", rel, sub.lineno, qual,
                    "socket%s with no configured timeout in sight — "
                    "a silently dead peer blocks this thread forever "
                    "instead of classifying as net_timeout; settimeout "
                    "the socket (or gettimeout-guard it) in this "
                    "function, or baseline it with the justification"
                    % kind))


def _lint_fault_determinism(rel: str, index: _ModuleIndex,
                            findings: List[Finding]) -> None:
    is_faults_module = os.path.basename(rel) == "faults.py"
    for qual, node in index.functions.items():
        cls = qual.rsplit(".", 1)[0] if "." in qual else ""
        if not (is_faults_module or "FaultPlan" in cls
                or "fault_plan" in node.name):
            continue
        for sub in _own_walk(node):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            bad = None
            if isinstance(f, ast.Attribute):
                if f.attr == "time" and isinstance(f.value, ast.Name) \
                        and f.value.id == "time":
                    bad = "time.time()"
                elif isinstance(f.value, ast.Name) \
                        and f.value.id == "random":
                    bad = "random.%s()" % f.attr
                elif isinstance(f.value, ast.Attribute) \
                        and f.value.attr == "random" \
                        and isinstance(f.value.value, ast.Name) \
                        and f.value.value.id in _NP_NAMES:
                    bad = "np.random.%s()" % f.attr
                elif f.attr in ("now", "utcnow") \
                        and _attr_chain_has(f, {"datetime"}):
                    bad = "datetime.%s()" % f.attr
            if bad is not None:
                findings.append(Finding(
                    "RNB-H004", rel, sub.lineno, qual,
                    "%s in deterministic fault-injection code — "
                    "schedules must be reproducible (use seeded, "
                    "stateless draws like faults._hash_draw)" % bad))


#: host-materialization calls RNB-H008 rejects on device-resident
#: handoff paths
_H008_ATTR_CALLS = {"cpu", "numpy", "tolist"}


def _lint_handoff_device_paths(rel: str, index: _ModuleIndex,
                               findings: List[Finding]) -> None:
    """RNB-H008: no host materialization inside a device-resident
    handoff path. Scope: methods of ``*Handoff*`` classes and
    module-level functions of ``handoff*.py`` modules; a ``host``
    component in the function name marks the designated host-mode
    path and exempts it (that arm exists to bounce, measurably)."""
    is_handoff_module = os.path.basename(rel).startswith("handoff")
    for qual, node in index.functions.items():
        cls, _, meth = qual.rpartition(".")
        name = meth or qual
        in_scope = "Handoff" in cls or (is_handoff_module and not cls)
        if not in_scope or "host" in name.lower():
            continue
        for sub in _own_walk(node):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            if isinstance(f, ast.Attribute) and f.attr in _H008_ATTR_CALLS:
                findings.append(Finding(
                    "RNB-H008", rel, sub.lineno, qual,
                    ".%s() on a device-resident handoff path — the edge "
                    "contract promises zero host-hop bytes; move the "
                    "call into the '*host*'-named host-mode path or "
                    "fix it" % f.attr))


def _lint_shed_ordering(rel: str, index: _ModuleIndex,
                        findings: List[Finding]) -> None:
    for qual, node in index.functions.items():
        write_line = shed_line = None
        for sub in _own_walk(node):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            if isinstance(f, ast.Attribute) and f.attr == "write" \
                    and _attr_chain_has(f.value, {"output_ring"}):
                if write_line is None or sub.lineno < write_line:
                    write_line = sub.lineno
            if isinstance(f, ast.Name) and f.id == "_shed_item":
                if shed_line is None or sub.lineno < shed_line:
                    shed_line = sub.lineno
        if write_line is not None and shed_line is not None \
                and write_line < shed_line:
            findings.append(Finding(
                "RNB-H005", rel, write_line, qual,
                "ring-slot write at line %d precedes the shed decision "
                "at line %d — a written-but-never-signalled slot "
                "deadlocks the producer on wrap-around; decide shed "
                "first" % (write_line, shed_line)))


def check_file(path: str, root: str = ".") -> List[Finding]:
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    try:
        tree = parse_py(path)
    except SyntaxError as e:
        return [Finding("RNB-H000", rel, e.lineno or 0, "parse",
                        "file does not parse: %s" % e)]
    index = _ModuleIndex()
    index.visit(tree)
    findings: List[Finding] = []
    captured = _lint_captured(rel, index, findings)
    hot = _hot_set(index, rel)
    for qual in sorted(hot - captured):
        _lint_hot_body(rel, qual, index.functions[qual], findings)
    _lint_unbounded_waits(rel, index, findings, hot)
    _lint_fault_determinism(rel, index, findings)
    _lint_shed_ordering(rel, index, findings)
    _lint_handoff_device_paths(rel, index, findings)
    return findings


def check_package(package_dir: str, root: str = ".") -> List[Finding]:
    findings: List[Finding] = []
    for path in package_py_files(package_dir):
        findings.extend(check_file(path, root))
    return findings
