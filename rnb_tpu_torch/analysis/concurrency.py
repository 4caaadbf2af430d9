"""rnb-lint concurrency family: declared lock contracts + discipline.

Counterpart of ``rnb_tpu/analysis/concurrency.py`` over
``rnb_tpu_torch/``; the rules are the reference's, with the card's
syncs in place of JAX's among C005's blocking calls.

The repo's threaded modules guard their cross-thread state machines
(staging slot lifecycle, hedge claim ledger, pager pin/limbo, lane
boards) by convention; this family turns the convention into declared,
checkable contracts — same philosophy as the telemetry registries
(rnb_tpu_torch.telemetry): declare once, cross-check everywhere.

Declaration seams (class attributes on lock-owning classes):

``GUARDED_BY = {"_entries": "_lock", ...}``
    Which lock guards which attribute. Values are attribute chains on
    ``self`` — ``"_lock"`` for an own lock, ``"pager.lock"`` for a
    lock owned by a collaborator (the rnb_tpu_torch.pager discipline).
``UNGUARDED_OK = {"_evicted": "tx-thread confined", ...}``
    Attributes that are lock-free by design, each with its one-line
    justification (thread confinement, immutable-after-publish, ...).
``READ_ONLY_ROLES = {"hot": "pollers must never mutate", ...}``
    Thread roles (see below) from which every method must be
    read-only on shared state.

Rules:

RNB-C001
    A ``GUARDED_BY`` attribute is read or written at a site where the
    declared lock is not statically held. Lock-held-at-site tracks
    ``with self._lock:`` blocks, paired ``acquire()``/``release()``
    calls (including the acquire/try/finally-release shape), the
    Condition-on-lock alias (``threading.Condition(self._lock)``
    counts as the lock), and the ``*_locked`` naming convention
    (callee asserts the caller holds the class's locks). ``__init__``
    is exempt (no concurrent aliases exist yet).
RNB-C002
    A method whose inferred thread role is declared read-only writes a
    shared attribute. Roles come from the existing seams: hotpath's
    executor roots (``HOT_ROOT_METHODS`` -> role ``hot``) and
    ``threading.Thread(target=self.x, name="...")`` entry points
    (role = the thread-name prefix, the trace/hostprof convention),
    propagated through self-method calls.
RNB-C003
    A lock-owning class mutates attributes after ``__init__`` without
    declaring them (neither ``GUARDED_BY`` nor ``UNGUARDED_OK``).
    Attributes only ever assigned in ``__init__`` are
    immutable-by-convention and exempt.
RNB-C004
    The static lock-acquisition order graph has a cycle. Lock identity
    is ``(class, attr)``; edges come from nested ``with`` blocks and
    from self-method calls made while a lock is held (one transitive
    closure over the class's own call graph).
RNB-C005
    A blocking call — ``queue.get/put``, bare ``.wait()``,
    ``.result()``, ``.join()``, a sync with the card
    (``torch.cuda.synchronize()``, ``Stream``/``Event.synchronize()``,
    and ``.item()``, ``.cpu()`` or ``.tolist()`` of a tensor), socket IO,
    ``time.sleep`` — while holding a lock. ``Condition.wait`` on the held lock itself
    is the sanctioned exception (it releases the lock), and
    ``dict.get(key)`` (positional args) is never flagged.

The static graph is exported via :func:`static_lock_order_edges` so
``parse_utils --check`` can verify the runtime witness
(rnb_tpu_torch.lockwitness): observed acquisition-order edges must be a
subset of this graph, with zero witness violations.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from rnb_tpu_torch.analysis.findings import Finding, package_py_files, parse_py

#: executor-side entry points (the hotpath family's reachability
#: roots) — methods reachable from these carry the ``hot`` role
HOT_ROOT_METHODS = ("__call__", "submit", "complete", "poll", "select")

#: threading constructors whose result makes an attribute a lock
_LOCK_FACTORIES = ("Lock", "RLock")
#: attribute names that make a bare ``with``-context count as a lock
#: even without a resolvable constructor (foreign chains like
#: ``arena.pager.lock``)
_LOCKISH = "lock"

#: blocking attribute calls flagged under a held lock regardless of
#: argument shape
_BLOCKING_ATTRS = {"result", "recv", "recv_into", "sendall", "accept",
                   "send_frame", "read_frame", "recv_frame"}
#: blocking only with zero positional args (``q.get()`` blocks;
#: ``d.get(key)`` is a dict probe). ``synchronize`` covers
#: ``torch.cuda.synchronize()`` and ``Stream``/``Event.synchronize()``;
#: ``item``, ``cpu`` and ``tolist`` read a tensor back to the host, so
#: each waits for the card's queue up to it
_BLOCKING_ATTRS_ZERO_ARG = {"get", "join", "wait", "synchronize", "item",
                            "cpu", "tolist"}
#: bare-name calls flagged under a held lock
_BLOCKING_NAMES = {"create_connection", "synchronize"}

_CONTRACT_NAMES = ("GUARDED_BY", "UNGUARDED_OK", "READ_ONLY_ROLES")


def _rel(path: str, root: Optional[str]) -> str:
    if root:
        try:
            return os.path.relpath(path, root)
        except ValueError:
            pass
    return path


def _own_walk(node):
    """Walk a function body without descending into nested function or
    class definitions (their bodies run in other scopes — often other
    threads — and are analyzed on their own)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(child))


def _attr_chain(node) -> Optional[Tuple[str, ...]]:
    """``a.b.c`` -> ("a", "b", "c"); None for non-name chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _call_chain(call: ast.Call) -> Optional[Tuple[str, ...]]:
    return _attr_chain(call.func)


class _Method:
    """Per-method facts the class-level passes consume."""

    def __init__(self, node):
        self.node = node
        self.name = node.name
        #: locks acquired anywhere in the body (chains on self)
        self.acquires: Set[Tuple[str, ...]] = set()
        #: self-methods called anywhere in the body
        self.self_calls: Set[str] = set()
        #: self attributes written outside __init__
        self.writes: Set[str] = set()
        #: (held-chain frozenset, callee-name) for call-graph edges
        self.calls_under_lock: List[Tuple[frozenset, str]] = []


class _ClassContract:
    """One class's lock inventory + declared contracts."""

    def __init__(self, node: ast.ClassDef, file: str):
        self.node = node
        self.file = file
        self.name = node.name
        self.locks: Set[str] = set()        # own lock attrs
        self.aliases: Dict[str, str] = {}   # Condition attr -> lock attr
        self.guarded: Dict[str, str] = {}
        self.unguarded_ok: Dict[str, str] = {}
        self.read_only_roles: Dict[str, str] = {}
        self.declared = False               # any contract attr present
        self.contract_errors: List[Tuple[int, str]] = []
        self.methods: Dict[str, _Method] = {}
        #: role entry points: method name -> role
        self.entry_roles: Dict[str, str] = {}

    def guard_chain(self, attr: str) -> Tuple[str, ...]:
        """The declared guard of ``attr`` as a normalized chain."""
        return self.normalize(tuple(self.guarded[attr].split(".")))

    def normalize(self, chain: Tuple[str, ...]) -> Tuple[str, ...]:
        """Resolve the Condition-on-lock alias on own-lock chains."""
        if len(chain) == 1 and chain[0] in self.aliases:
            return (self.aliases[chain[0]],)
        return chain


def _thread_role(name_literal: Optional[str]) -> str:
    """Thread role from the ``name=`` literal the trace/hostprof seams
    key on: the prefix before any per-instance numbering
    (``rnb-decode_3`` -> ``rnb-decode``)."""
    if not name_literal:
        return "worker"
    role = name_literal
    for sep in ("_", "-"):
        head, _, tail = role.rpartition(sep)
        if head and tail.isdigit():
            role = head
    return role


def _extract_contracts(cls: ast.ClassDef, file: str) -> _ClassContract:
    info = _ClassContract(cls, file)
    for stmt in cls.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and stmt.targets[0].id in _CONTRACT_NAMES:
            name = stmt.targets[0].id
            try:
                value = ast.literal_eval(stmt.value)
                if not isinstance(value, dict) \
                        or not all(isinstance(k, str)
                                   and isinstance(v, str)
                                   for k, v in value.items()):
                    raise ValueError("must be a {str: str} dict")
            except ValueError as exc:
                info.contract_errors.append(
                    (stmt.lineno, "%s is not a literal {str: str} dict "
                     "(%s)" % (name, exc)))
                continue
            info.declared = True
            if name == "GUARDED_BY":
                info.guarded = value
            elif name == "UNGUARDED_OK":
                info.unguarded_ok = value
            else:
                info.read_only_roles = value
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            deco = {d.id for d in stmt.decorator_list
                    if isinstance(d, ast.Name)}
            if "staticmethod" in deco or "classmethod" in deco:
                continue
            info.methods[stmt.name] = _Method(stmt)

    # lock inventory + Condition aliasing, from __init__ assignments
    init = info.methods.get("__init__")
    if init is not None:
        for node in _own_walk(init.node):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Attribute)
                    and isinstance(node.targets[0].value, ast.Name)
                    and node.targets[0].value.id == "self"
                    and isinstance(node.value, ast.Call)):
                continue
            attr = node.targets[0].attr
            chain = _call_chain(node.value)
            if chain is None:
                continue
            if chain[-1] in _LOCK_FACTORIES \
                    or chain[-2:] == ("lockwitness", "lock") \
                    or chain == ("lock",):
                info.locks.add(attr)
            elif chain[-1] == "Condition":
                args = node.value.args
                base = _attr_chain(args[0]) if args else None
                if base is not None and len(base) == 2 \
                        and base[0] == "self":
                    info.aliases[attr] = base[1]
                else:
                    # a Condition owns a private lock when built bare
                    info.locks.add(attr)

    # role entry points: hotpath executor roots + Thread targets
    for mname in info.methods:
        if mname in HOT_ROOT_METHODS:
            info.entry_roles[mname] = "hot"
    for m in info.methods.values():
        for node in _own_walk(m.node):
            if not (isinstance(node, ast.Call)
                    and (_call_chain(node) or ())[-1:] == ("Thread",)):
                continue
            target = None
            name_literal = None
            for kw in node.keywords:
                if kw.arg == "target":
                    target = _attr_chain(kw.value)
                elif kw.arg == "name" \
                        and isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str):
                    name_literal = kw.value.value
            if target is not None and len(target) == 2 \
                    and target[0] == "self" \
                    and target[1] in info.methods:
                info.entry_roles[target[1]] = _thread_role(name_literal)
    if "run" in info.methods and "run" not in info.entry_roles:
        for base in cls.bases:
            bchain = _attr_chain(base) or ()
            if bchain[-1:] == ("Thread",):
                info.entry_roles["run"] = "worker"
    return info


def _is_lock_chain(info: _ClassContract, chain: Tuple[str, ...]) -> bool:
    """Does ``with self.<chain>`` / ``<chain>.acquire()`` take a lock?"""
    if not chain:
        return False
    if chain[0] == "self":
        rest = info.normalize(chain[1:])
        if not rest:
            return False
        if len(rest) == 1:
            return rest[0] in info.locks or rest[0] in info.aliases \
                or _LOCKISH in rest[0].lower()
        return _LOCKISH in rest[-1].lower()
    if len(chain) == 1:
        # module-level lock convention: private name containing "lock"
        return chain[0].startswith("_") and _LOCKISH in chain[0].lower()
    return _LOCKISH in chain[-1].lower()


def _held_key(info: _ClassContract,
              chain: Tuple[str, ...]) -> Tuple[str, ...]:
    """Normalize an acquisition chain to the held-set key: own locks
    become a 1-tuple attr, foreign chains keep their tail."""
    if chain and chain[0] == "self":
        return info.normalize(chain[1:])
    return chain


class _MethodScan:
    """One statement-ordered pass over a method body, tracking the set
    of held locks through ``with`` blocks and acquire/release pairs."""

    def __init__(self, info: _ClassContract, method: _Method,
                 findings: List[Finding], edges: Set[Tuple], file: str,
                 check_c001: bool):
        self.info = info
        self.m = method
        self.findings = findings
        self.edges = edges
        self.file = file
        self.check_c001 = check_c001
        self.anchor = "%s.%s" % (info.name, method.name)
        self._c001_seen: Set[str] = set()
        self._c005_seen: Set[int] = set()

    def run(self, initial_held: Set[Tuple[str, ...]]) -> None:
        self._block(self.m.node.body, set(initial_held))

    # -- statement walk ----------------------------------------------

    def _block(self, stmts, held: Set[Tuple[str, ...]]) -> None:
        for stmt in stmts:
            self._stmt(stmt, held)

    def _stmt(self, stmt, held: Set[Tuple[str, ...]]) -> None:
        if isinstance(stmt, ast.With):
            entered = []
            for item in stmt.items:
                chain = None
                if isinstance(item.context_expr, (ast.Attribute,
                                                  ast.Name)):
                    chain = _attr_chain(item.context_expr)
                if chain is not None \
                        and _is_lock_chain(self.info, chain):
                    self._acquire(chain, held)
                    entered.append(_held_key(self.info, chain))
                else:
                    self._exprs(item.context_expr, held)
            self._block(stmt.body, held)
            for key in entered:
                held.discard(key)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.Try):
            self._block(stmt.body, held)
            for handler in stmt.handlers:
                self._block(handler.body, set(held))
            self._block(stmt.orelse, set(held))
            self._block(stmt.finalbody, held)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._exprs(stmt.test, held)
            self._block(stmt.body, set(held))
            self._block(stmt.orelse, set(held))
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._exprs(stmt.iter, held)
            self._access(stmt.target, held, write=True)
            self._block(stmt.body, set(held))
            self._block(stmt.orelse, set(held))
            return
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                     ast.Call):
            chain = _call_chain(stmt.value)
            if chain is not None and len(chain) > 1:
                if chain[-1] == "acquire" \
                        and _is_lock_chain(self.info, chain[:-1]):
                    self._exprs(stmt.value, held, skip_blocking=True)
                    self._acquire(chain[:-1], held)
                    return
                if chain[-1] == "release" \
                        and _is_lock_chain(self.info, chain[:-1]):
                    held.discard(_held_key(self.info, chain[:-1]))
                    return
        # generic statement: check every expression inside it
        if isinstance(stmt, ast.Assign):
            for target in stmt.targets:
                self._access(target, held, write=True)
            self._exprs(stmt.value, held)
            return
        if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            self._access(stmt.target, held, write=True)
            if isinstance(stmt, ast.AugAssign) or stmt.value is not None:
                self._exprs(stmt.value, held)
            return
        if isinstance(stmt, ast.Delete):
            for target in stmt.targets:
                self._access(target, held, write=True)
            return
        for child in ast.iter_child_nodes(stmt):
            self._exprs(child, held)

    # -- acquisition bookkeeping -------------------------------------

    def _acquire(self, chain: Tuple[str, ...],
                 held: Set[Tuple[str, ...]]) -> None:
        key = _held_key(self.info, chain)
        if key in held:
            return  # reentrant re-acquire: no new edge
        for prior in held:
            self.edges.add((self.info.name, prior, key,
                            self.file, self.anchor))
        held.add(key)
        self.m.acquires.add(key)

    # -- expression walk (accesses + blocking calls) ------------------

    def _exprs(self, node, held: Set[Tuple[str, ...]],
               skip_blocking: bool = False) -> None:
        if node is None:
            return
        for sub in [node] + [n for n in _own_walk(node)]:
            if isinstance(sub, ast.Attribute):
                self._access(sub, held, write=False)
            elif isinstance(sub, ast.Call) and not skip_blocking:
                self._call(sub, held)

    def _access(self, node, held: Set[Tuple[str, ...]],
                write: bool) -> None:
        if isinstance(node, (ast.Tuple, ast.List)):
            for elt in node.elts:
                self._access(elt, held, write=write)
            return
        if isinstance(node, (ast.Subscript, ast.Starred)):
            # a[k] = v reads the container binding; the element write
            # is still a mutation of the guarded structure
            self._access(node.value, held, write=write)
            if isinstance(node, ast.Subscript):
                self._exprs(node.slice, held)
            return
        if not (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            if isinstance(node, ast.Attribute):
                self._exprs(node.value, held)
            return
        attr = node.attr
        if write and self.m.name != "__init__":
            self.m.writes.add(attr)
        if not self.check_c001 or attr not in self.info.guarded:
            return
        guard = self.info.guard_chain(attr)
        if guard in held or attr in self._c001_seen:
            return
        self._c001_seen.add(attr)
        self.findings.append(Finding(
            "RNB-C001", self.file, node.lineno, self.anchor,
            "%s self.%s outside its declared lock %r "
            "(GUARDED_BY on %s)" % (
                "writes" if write else "reads", attr,
                self.info.guarded[attr], self.info.name)))

    def _call(self, call: ast.Call,
              held: Set[Tuple[str, ...]]) -> None:
        chain = _call_chain(call)
        if chain is None:
            return
        if chain[0] == "self" and len(chain) == 2 \
                and chain[1] in self.info.methods:
            self.m.self_calls.add(chain[1])
            if held:
                self.m.calls_under_lock.append(
                    (frozenset(held), chain[1]))
        if not held or call.lineno in self._c005_seen:
            return
        blocking = None
        tail = chain[-1]
        if len(chain) > 1 and tail in _BLOCKING_ATTRS:
            blocking = ".%s()" % tail
        elif len(chain) > 1 and tail in _BLOCKING_ATTRS_ZERO_ARG \
                and not call.args:
            if tail == "wait":
                # Condition.wait on the held lock releases it — the
                # sanctioned blocking shape
                key = _held_key(self.info, chain[:-1])
                if key in held:
                    return
            blocking = ".%s()" % tail
        elif len(chain) > 1 and tail == "put" \
                and "queue" in chain[-2].lower():
            blocking = ".put()"
        elif chain == ("time", "sleep"):
            blocking = "time.sleep()"
        elif len(chain) == 1 and tail in _BLOCKING_NAMES:
            blocking = "%s()" % tail
        if blocking is None:
            return
        self._c005_seen.add(call.lineno)
        self.findings.append(Finding(
            "RNB-C005", self.file, call.lineno, self.anchor,
            "blocking call %s while holding %s" % (
                blocking,
                ", ".join(sorted(".".join(h) for h in held)))))


# -- per-file analysis -------------------------------------------------

def _classes_of(tree) -> List[ast.ClassDef]:
    out = []
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.ClassDef):
            out.append(node)
            stack.extend(n for n in node.body
                         if isinstance(n, ast.ClassDef))
    return sorted(out, key=lambda c: c.lineno)


def _scan_class(info: _ClassContract,
                findings: List[Finding],
                edges: Set[Tuple]) -> None:
    relevant = bool(info.locks or info.declared or info.aliases)
    for m in info.methods.values():
        if m.name == "__init__":
            # still scanned for C005/edges (locks can nest in setup),
            # but C001 is moot: no concurrent aliases exist yet
            initial: Set[Tuple[str, ...]] = set()
            check_c001 = False
        elif m.name.endswith("_locked"):
            # the *_locked convention: the caller holds the class's
            # locks — C001-clean by contract, but blocking calls are
            # blocking calls under THOSE locks (C005 still applies)
            initial = {info.guard_chain(a) for a in info.guarded}
            initial |= {(lk,) for lk in info.locks}
            check_c001 = False
        else:
            initial = set()
            check_c001 = relevant
        scan = _MethodScan(info, m, findings, edges, info.file,
                           check_c001=check_c001)
        scan.run(initial)

    # transitive self-call edges: caller holds H, callee acquires B
    acquires = {name: set(m.acquires)
                for name, m in info.methods.items()}
    changed = True
    while changed:
        changed = False
        for name, m in info.methods.items():
            for callee in m.self_calls:
                extra = acquires.get(callee, set()) - acquires[name]
                if extra:
                    acquires[name] |= extra
                    changed = True
    for m in info.methods.values():
        for held, callee in m.calls_under_lock:
            for acquired in acquires.get(callee, set()):
                if acquired not in held:
                    for prior in held:
                        edges.add((info.name, prior, acquired,
                                   info.file,
                                   "%s.%s" % (info.name, m.name)))

    if not relevant:
        return

    for lineno, msg in info.contract_errors:
        findings.append(Finding("RNB-C003", info.file, lineno,
                                info.name, msg))

    # C003: post-init mutations must be declared (lock-owning classes)
    if info.locks:
        undeclared = set()
        for m in info.methods.values():
            undeclared |= m.writes
        undeclared -= set(info.guarded)
        undeclared -= set(info.unguarded_ok)
        undeclared -= info.locks
        undeclared -= set(info.aliases)
        if undeclared:
            findings.append(Finding(
                "RNB-C003", info.file, info.node.lineno, info.name,
                "lock-owning class mutates undeclared shared "
                "attribute(s) after __init__: %s — declare each in "
                "GUARDED_BY or UNGUARDED_OK"
                % ", ".join(sorted(undeclared))))

    # C002: read-only roles must not write shared state
    if info.read_only_roles:
        roles: Dict[str, Set[str]] = {}
        for entry, role in info.entry_roles.items():
            roles.setdefault(entry, set()).add(role)
        changed = True
        while changed:
            changed = False
            for name, m in info.methods.items():
                for callee in m.self_calls:
                    extra = roles.get(name, set()) \
                        - roles.get(callee, set())
                    if extra and callee in info.methods:
                        roles.setdefault(callee, set()).update(extra)
                        changed = True
        for name, m in info.methods.items():
            if name == "__init__":
                continue
            bad_roles = roles.get(name, set()) \
                & set(info.read_only_roles)
            shared_writes = m.writes - set(info.unguarded_ok) \
                - info.locks - set(info.aliases)
            if bad_roles and shared_writes:
                findings.append(Finding(
                    "RNB-C002", info.file, m.node.lineno,
                    "%s.%s" % (info.name, name),
                    "role %r is declared read-only but this method "
                    "writes %s" % (sorted(bad_roles)[0],
                                   ", ".join(sorted(shared_writes)))))


def _resolve_edges(edges: Set[Tuple],
                   lock_owners: Dict[str, Set[str]]
                   ) -> Tuple[Set[Tuple[str, str]],
                              Dict[Tuple[str, str],
                                   Tuple[str, str]]]:
    """(cls, held-key, acquired-key, file, anchor) tuples -> global
    edge set over "Class.attr" lock names, plus one representative
    (file, anchor) site per edge for rendering."""
    resolved: Set[Tuple[str, str]] = set()
    sites: Dict[Tuple[str, str], Tuple[str, str]] = {}

    def name_of(cls: str, key: Tuple[str, ...]) -> Optional[str]:
        attr = key[-1]
        if len(key) == 1:
            return "%s.%s" % (cls, attr)
        owners = lock_owners.get(attr, set())
        if len(owners) == 1:
            return "%s.%s" % (next(iter(owners)), attr)
        return None  # ambiguous foreign lock: never invent an edge

    for cls, held, acquired, file, anchor in edges:
        a, b = name_of(cls, held), name_of(cls, acquired)
        if a is None or b is None or a == b:
            continue
        edge = (a, b)
        resolved.add(edge)
        sites.setdefault(edge, (file, anchor))
    return resolved, sites


def _find_cycles(edges: Set[Tuple[str, str]]) -> List[List[str]]:
    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    cycles: List[List[str]] = []
    seen_cycles: Set[Tuple[str, ...]] = set()

    def dfs(node, path, on_path):
        for nxt in sorted(graph.get(node, ())):
            if nxt in on_path:
                cyc = path[path.index(nxt):] + [nxt]
                lo = min(range(len(cyc) - 1),
                         key=lambda i: cyc[i])
                canon = tuple(cyc[lo:-1] + cyc[:lo + 1])
                if canon not in seen_cycles:
                    seen_cycles.add(canon)
                    cycles.append(list(canon))
            elif nxt not in visited:
                visited.add(nxt)
                dfs(nxt, path + [nxt], on_path | {nxt})

    visited: Set[str] = set()
    for start in sorted(graph):
        if start not in visited:
            visited.add(start)
            dfs(start, [start], {start})
    return cycles


# -- public API --------------------------------------------------------

def check_files(paths: List[str],
                root: Optional[str] = None) -> List[Finding]:
    findings: List[Finding] = []
    raw_edges: Set[Tuple] = set()
    lock_owners: Dict[str, Set[str]] = {}
    infos: List[_ClassContract] = []
    for path in paths:
        rel = _rel(path, root)
        tree = parse_py(path)
        for cls in _classes_of(tree):
            info = _extract_contracts(cls, rel)
            infos.append(info)
            for lk in info.locks:
                lock_owners.setdefault(lk, set()).add(info.name)
    for info in infos:
        _scan_class(info, findings, raw_edges)
    resolved, sites = _resolve_edges(raw_edges, lock_owners)
    for cycle in _find_cycles(resolved):
        file, _ = sites[(cycle[0], cycle[1])]
        findings.append(Finding(
            "RNB-C004", file, 0, "->".join(cycle),
            "lock-order cycle: %s — some thread can hold each lock "
            "while wanting the next" % " -> ".join(cycle)))
    findings.sort(key=lambda f: (f.file, f.line, f.rule, f.anchor))
    return findings


def check_file(path: str, root: Optional[str] = None) -> List[Finding]:
    return check_files([path], root=root)


def check_package(package_dir: str,
                  root: Optional[str] = None) -> List[Finding]:
    return check_files(package_py_files(package_dir), root=root)


def static_lock_order_edges(package_dir: Optional[str] = None
                            ) -> Set[Tuple[str, str]]:
    """The static acquisition-order graph over "Class.attr" lock names
    — the reference set ``parse_utils --check`` verifies the runtime
    witness's observed edges against."""
    if package_dir is None:
        package_dir = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))
    raw_edges: Set[Tuple] = set()
    lock_owners: Dict[str, Set[str]] = {}
    infos: List[_ClassContract] = []
    for path in package_py_files(package_dir):
        tree = parse_py(path)
        rel = os.path.basename(path)
        for cls in _classes_of(tree):
            info = _extract_contracts(cls, rel)
            infos.append(info)
            for lk in info.locks:
                lock_owners.setdefault(lk, set()).add(info.name)
    findings: List[Finding] = []
    for info in infos:
        _scan_class(info, findings, raw_edges)
    resolved, _ = _resolve_edges(raw_edges, lock_owners)
    return resolved


def contract_registry(package_dir: Optional[str] = None
                      ) -> List[Tuple[str, str, Dict[str, str],
                                      Dict[str, str]]]:
    """(file, class, GUARDED_BY, UNGUARDED_OK) for every declaring
    class — the ``--stamps`` face of this family."""
    if package_dir is None:
        package_dir = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))
    out = []
    for path in package_py_files(package_dir):
        tree = parse_py(path)
        for cls in _classes_of(tree):
            info = _extract_contracts(cls, os.path.basename(path))
            if info.declared:
                out.append((info.file, info.name, info.guarded,
                            info.unguarded_ok))
    return out
