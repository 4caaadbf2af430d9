"""Runtime lock-order witness: the checked-not-trusted face of the
static concurrency contracts.

Counterpart of ``rnb_tpu/lockwitness.py``, the port's own copy, whole.

FreeBSD WITNESS in miniature: participating modules construct their
locks through :func:`lock` with a stable name (``"ClassName.attr"`` —
the same ``(class, attr)`` identity the static analyzer uses). When
the witness is **disabled** (the default), :func:`lock` returns a
plain ``threading.Lock``/``RLock`` — zero wrapper, zero overhead, and
runs produce byte-identical output to a build without this module.
When **enabled** (config ``lint: {lock_witness: true}``, or tests),
each acquisition records:

* the **order edge** (top of the acquiring thread's held stack ->
  the acquired lock) — at teardown the observed edge set must be a
  subset of the static acquisition-order graph
  (``parse_utils --check``);
* **violations**: an acquisition inverting an already-observed edge
  (the two-thread interleaving that deadlocks), releasing a lock the
  thread does not hold, and :func:`require` assertions — the runtime
  face of the ``*_locked`` naming convention — failing.

The summary feeds the ``Locks:`` / ``Lock edges:`` log-meta lines
(META_LINE_REGISTRY), so the static model and observed reality
cross-foot exactly like every other telemetry plane.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Set, Tuple

_enabled = False
_state = threading.local()          # per-thread held stack + tally
_reg_lock = threading.Lock()        # guards the module tallies below
_locks_created = 0
_tallies: List[List[int]] = []      # per-thread acquire counts
_tally_gen = 0                      # bumped by reset(): stale tallies
                                    # re-register instead of resurrect
_edges: Set[Tuple[str, str]] = set()
_violations: List[str] = []

#: cap so a pathological run cannot grow the violation list unbounded
MAX_VIOLATIONS = 100


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Turn the witness on for locks constructed from now on (call
    before the pipeline builds, i.e. before any participating class's
    ``__init__``)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Clear tallies (test isolation; enable/disable is separate)."""
    global _locks_created, _tally_gen
    with _reg_lock:
        _locks_created = 0
        _tally_gen += 1
        del _tallies[:]
        _edges.clear()
        del _violations[:]


def _held() -> List[str]:
    stack = getattr(_state, "held", None)
    if stack is None:
        stack = _state.held = []
    return stack


def _tally() -> List[int]:
    """This thread's acquire counter. Registered once per thread per
    reset() generation, so the hot acquire path is an uncontended
    list increment — never the registry lock (a witnessed suite must
    not serialize every lock in the process through one global)."""
    if getattr(_state, "tally_gen", None) == _tally_gen:
        return _state.tally
    t = [0]
    with _reg_lock:
        _state.tally = t
        _state.tally_gen = _tally_gen
        _tallies.append(t)
    return t


def _violation(msg: str) -> None:
    with _reg_lock:
        if len(_violations) < MAX_VIOLATIONS:
            _violations.append(msg)


class WitnessLock:
    """A named lock that records acquisition-order edges and order
    inversions. Context-manager and acquire/release compatible, so
    ``threading.Condition`` built on it works unchanged."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._note_acquired()
        return got

    def _note_acquired(self) -> None:
        held = _held()
        _tally()[0] += 1
        if held and held[-1] != self.name and self.name not in held:
            edge = (held[-1], self.name)
            # GIL-safe racy pre-check: repeat edges (the steady state)
            # never touch the registry lock
            if edge not in _edges:
                with _reg_lock:
                    if edge not in _edges:
                        if (edge[1], edge[0]) in _edges \
                                and len(_violations) < MAX_VIOLATIONS:
                            _violations.append(
                                "order inversion: acquired %s while "
                                "holding %s, but %s -> %s was already "
                                "observed" % (self.name, held[-1],
                                              self.name, held[-1]))
                        _edges.add(edge)
        held.append(self.name)

    def release(self) -> None:
        held = _held()
        if self.name not in held:
            _violation("released %s on a thread that does not hold it"
                       % self.name)
        else:
            # remove the innermost hold (reentrant stacks pop LIFO)
            for i in range(len(held) - 1, -1, -1):
                if held[i] == self.name:
                    del held[i]
                    break
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        return self._inner.locked()

    def __repr__(self):
        return "<WitnessLock %s %r>" % (self.name, self._inner)


def lock(name: str, factory=threading.Lock):
    """The one construction seam: a plain ``factory()`` lock when the
    witness is off (byte-identical no-op path), a named
    :class:`WitnessLock` around it when on."""
    if not _enabled:
        return factory()
    global _locks_created
    with _reg_lock:
        _locks_created += 1
    return WitnessLock(name, factory())


def require(name: str) -> None:
    """Runtime assert of the ``*_locked`` convention: records a
    violation when the calling thread does not hold ``name``. Free
    when the witness is off."""
    if not _enabled:
        return
    if name not in _held():
        _violation("%s required but not held (a *_locked callee ran "
                   "without its caller's lock)" % name)


def holds(name: str) -> bool:
    return name in _held()


def summary() -> Optional[Dict[str, object]]:
    """Teardown snapshot for the ``Locks:`` meta line, or None when
    the witness never ran (keeps witness-off logs byte-stable)."""
    if not _enabled:
        return None
    with _reg_lock:
        return {
            "locks": _locks_created,
            "acquires": sum(t[0] for t in _tallies),
            "edges": sorted(_edges),
            "violations": list(_violations),
        }


def format_edges(snap: Dict[str, object]) -> str:
    """The ``Lock edges:`` JSON detail payload."""
    return json.dumps({
        "edges": [list(e) for e in snap["edges"]],
        "violations": snap["violations"],
    }, sort_keys=True)
