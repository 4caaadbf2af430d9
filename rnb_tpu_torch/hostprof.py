"""Opt-in host hot-path profiler (``RNB_HOST_PROFILE=1``).

Counterpart of ``rnb_tpu/hostprof.py``, the port's own copy. The hot
paths get named wall-time sections that cost one module-level bool
test when disabled and about a microsecond per section when enabled,
aggregated per (section, thread role): the role is the recording
thread's name (``runner-s1-g0-i0``, ``client``, ``rnb-transfer``), so
a section hit from several threads splits per thread.

Wall-time sections measure where threads spend time, waits included
(decode wait, device sync); the companion figure is the process CPU
time over the measured window (``host_cpu_frac`` in ``hostprof.txt``,
written by :mod:`rnb_tpu_torch.benchmark`). Together they separate
"host busy" from "host waiting on the card or on decode".
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

#: evaluated at import; tests flip it directly
ENABLED = bool(os.environ.get("RNB_HOST_PROFILE"))

_lock = threading.Lock()
#: (name, thread_role) -> [total_s, calls]. The role is the recording
#: thread's name — stable per worker ("runner-s0-g0-i0", "client",
#: "rnb-transfer"), so one section shared by several thread roles
#: splits per role instead of folding together.
_acc: Dict[Tuple[str, str], List[float]] = {}


def add(name: str, dt: float, role: str = None) -> None:
    if role is None:
        role = threading.current_thread().name
    key = (name, role)
    with _lock:
        entry = _acc.get(key)
        if entry is None:
            _acc[key] = [dt, 1]
        else:
            entry[0] += dt
            entry[1] += 1


class _NullSection:
    """Shared no-op context manager: the disabled path costs one
    function call and no allocation."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSection()


@contextmanager
def _timed(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add(name, time.perf_counter() - t0)


def section(name: str):
    if not ENABLED:
        return _NULL
    return _timed(name)


def reset() -> None:
    with _lock:
        _acc.clear()


def snapshot() -> Dict[str, Tuple[float, int]]:
    """Role-less view (the historical schema): name -> (total_s,
    calls) summed across every thread role that hit the section."""
    out: Dict[str, List[float]] = {}
    with _lock:
        for (name, _role), (secs, n) in _acc.items():
            entry = out.setdefault(name, [0.0, 0])
            entry[0] += secs
            entry[1] += n
    return {k: (v[0], v[1]) for k, v in out.items()}


def snapshot_by_role() -> Dict[Tuple[str, str], Tuple[float, int]]:
    """Full-resolution view: (name, thread_role) -> (total_s, calls)."""
    with _lock:
        return {k: (v[0], v[1]) for k, v in _acc.items()}


def totals(prefix: str, role: str = None) -> Tuple[float, int]:
    """Summed ``(seconds, calls)`` over sections whose name starts
    with ``prefix`` — e.g. ``totals("loader.emit")`` for the whole
    emission-assembly family, or ``totals("transfer.")`` for the
    transfer-worker thread. ``role`` restricts the sum to one thread
    role (exact thread name), answering "how much of this section ran
    on THAT thread" — the question the role-less sum cannot."""
    with _lock:
        total_s, calls = 0.0, 0
        for (name, r), (secs, n) in _acc.items():
            if name.startswith(prefix) and (role is None or r == role):
                total_s += secs
                calls += n
        return total_s, calls


def report_lines(wall_s: float) -> List[str]:
    """Human table: per-section total seconds, share of the window,
    call count and per-call mean, sorted by total — the role-less
    default view. Sections hit from more than one thread role get a
    per-role breakdown block appended (indented ``name @role`` rows),
    so a shared section (cache_insert from the executor AND the
    transfer worker) attributes its time to the threads that spent
    it."""
    snap = snapshot()
    by_role = snapshot_by_role()
    lines = ["%-28s %9s %6s %10s %10s"
             % ("section", "total_s", "pct", "calls", "mean_us")]
    for name, (total, calls) in sorted(snap.items(),
                                       key=lambda kv: -kv[1][0]):
        lines.append("%-28s %9.3f %5.1f%% %10d %10.1f"
                     % (name, total,
                        100.0 * total / wall_s if wall_s else 0.0,
                        calls, 1e6 * total / calls if calls else 0.0))
    multi = {}
    for (name, role), (secs, n) in by_role.items():
        multi.setdefault(name, []).append((role, secs, n))
    multi = {name: rows for name, rows in multi.items()
             if len(rows) > 1}
    if multi:
        lines.append("%-28s %9s %6s %10s %10s"
                     % ("  by thread role", "total_s", "pct", "calls",
                        "mean_us"))
        for name in sorted(multi, key=lambda n: -snap[n][0]):
            for role, secs, n in sorted(multi[name],
                                        key=lambda row: -row[1]):
                lines.append("  %-26s %9.3f %5.1f%% %10d %10.1f"
                             % ("%s @%s" % (name, role), secs,
                                100.0 * secs / wall_s if wall_s else 0.0,
                                n, 1e6 * secs / n if n else 0.0))
    return lines
