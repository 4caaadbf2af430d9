"""Continuous wall-clock stack sampling over the pipeline threads.

Counterpart of ``rnb_tpu/stacksampler.py``, the port's own copy,
whole. The port names its threads as the reference does (``client``,
``runner-s<step>-g<group>-i<instance>``, ``rnb-transfer``,
``rnb-decode``), so the roles are the same. The native decode pool's
C++ threads have no Python frames and do not show; their Python
callers do, parked in the ctypes call.

hostprof answers "how much wall time did section X cost" — but only
for the sections somebody instrumented, and only as end-of-run sums.
This module is the always-on complement: a low-rate background sampler
over ``sys._current_frames()`` that records *where each named pipeline
thread actually is* at every tick, with zero per-sample cooperation
from the sampled code. Three surfaces come out of one sample stream:

* ``logs/<job>/stacks.folded`` — the classic flamegraph-folded format
  (``role;frame;frame;...;leaf count`` per line), loadable untouched
  by any FlameGraph/speedscope-style viewer;
* sampler tracks merged into ``trace.json`` — one ``stacks:<role>``
  track per thread role whose tiles are the role's *top frame* at each
  tick, so the Perfetto timeline shows what the host was executing in
  the gaps between instrumented spans;
* a ``Stacks:`` log-meta counter line (ticks, roles, distinct folded
  stacks, total per-thread samples) whose folded-stack counts
  ``parse_utils --check`` re-sums from the artifact, and whose tick
  count it holds to ``sample_hz x measured wall`` within tolerance.

Gating: the sampler rides the root ``operator`` config key
(``operator.sample_hz``; 0 disables it) — see :mod:`rnb_tpu_torch.statusz`.
With the key absent nothing starts and no artifact or meta line is
written (byte-stable logs). Overhead: one ``sys._current_frames()``
call per tick walks every thread's frame chain under the GIL; its cost
beside the runner thread that replays the captured graphs is what
``PERF.md`` reads from the operator cell against the metrics cell.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from rnb_tpu_torch import lockwitness

#: default sampling rate (Hz) — low enough to be invisible next to the
#: pipeline's own work, high enough that a few-second run still yields
#: hundreds of samples per thread
DEFAULT_SAMPLE_HZ = 25.0

#: thread-name prefixes that count as pipeline roles; everything else
#: (the controller MainThread, the samplers/flushers themselves,
#: torch-internal threads) is deliberately not sampled — the signal is
#: "where is the *pipeline* spending host time"
ROLE_PREFIXES = ("client", "runner-", "rnb-decode", "rnb-transfer")

#: frame-walk depth cap: a pathological recursion must cost bounded
#: work per tick, never a runaway folded key
MAX_STACK_DEPTH = 64

#: cap on per-sample timeline events kept for the trace merge (the
#: folded aggregation is unbounded-safe on its own: distinct stacks,
#: not samples); beyond the cap samples still fold, only the timeline
#: tiles stop growing
MAX_TRACE_SAMPLES = 100000


def role_of(thread_name: str) -> Optional[str]:
    """The sampled role of one thread name, or None when the thread is
    not a pipeline role. Pool workers collapse onto their pool's role
    (``rnb-decode_3`` -> ``rnb-decode``) so the aggregation reads as
    "the decode pool", not N anonymous lanes."""
    for prefix in ROLE_PREFIXES:
        if thread_name.startswith(prefix):
            if prefix in ("rnb-decode", "rnb-transfer"):
                return prefix
            return thread_name
    return None


def _frame_label(frame) -> str:
    """``file:function`` for one frame, semicolon/space-free so the
    folded format stays parseable."""
    code = frame.f_code
    base = os.path.basename(code.co_filename)
    if base.endswith(".py"):
        base = base[:-3]
    label = "%s:%s" % (base, code.co_name)
    return label.replace(";", "_").replace(" ", "_")


def walk_stack(frame) -> Tuple[str, ...]:
    """Root-first frame labels of one thread's live stack (the folded
    orientation: caller;...;leaf), depth-capped."""
    labels: List[str] = []
    while frame is not None and len(labels) < MAX_STACK_DEPTH:
        labels.append(_frame_label(frame))
        frame = frame.f_back
    labels.reverse()
    return tuple(labels)


class StackSampler:
    """Bounded, thread-safe wall-clock sampler.

    The real feed is ``sys._current_frames()`` + ``threading
    .enumerate()``; tests drive :meth:`record` directly with synthetic
    stacks (the folded math is pure aggregation over (role, stack)
    pairs), or inject ``frames_fn``/``names_fn``.
    """

    GUARDED_BY = {
        "_folded": "_lock",
        "_roles": "_lock",
        "_timeline": "_lock",
        "samples": "_lock",
        "timeline_dropped": "_lock",
    }

    UNGUARDED_OK = {
        "_thread": "controller-thread lifecycle (start/stop)",
    }

    def __init__(self, sample_hz: float = DEFAULT_SAMPLE_HZ,
                 frames_fn: Optional[Callable[[], Dict]] = None,
                 names_fn: Optional[Callable[[], Dict[int, str]]] = None):
        self.sample_hz = float(sample_hz)
        self._frames_fn = frames_fn or sys._current_frames
        self._names_fn = names_fn or self._live_thread_names
        self._lock = lockwitness.lock("StackSampler._lock")
        #: (role, stack_tuple) -> sample count (the folded artifact)
        self._folded: Dict[Tuple, int] = {}
        #: distinct roles ever sampled
        self._roles: set = set()
        #: sampling ticks executed (the samples ~ hz x wall invariant)
        self.samples = 0
        #: per-sample (t_epoch_s, role, leaf_label) timeline tiles for
        #: the trace merge, bounded by MAX_TRACE_SAMPLES
        self._timeline: List[Tuple[float, str, str]] = []
        self.timeline_dropped = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @staticmethod
    def _live_thread_names() -> Dict[int, str]:
        return {t.ident: t.name for t in threading.enumerate()
                if t.ident is not None}

    # -- collection ---------------------------------------------------

    def record(self, role: str, stack: Tuple[str, ...],
               now: Optional[float] = None) -> None:
        """Fold one (role, stack) observation; ``stack`` is root-first
        frame labels. Public so tests feed synthetic stacks."""
        now = time.time() if now is None else now
        key = (role,) + tuple(stack)
        leaf = stack[-1] if stack else "?"
        with self._lock:
            self._folded[key] = self._folded.get(key, 0) + 1
            self._roles.add(role)
            if len(self._timeline) < MAX_TRACE_SAMPLES:
                self._timeline.append((now, role, leaf))
            else:
                self.timeline_dropped += 1

    def sample_once(self, now: Optional[float] = None) -> int:
        """One tick over every live pipeline thread; returns how many
        threads were sampled. Counted as one sample tick even when no
        pipeline thread is running (the hz x wall invariant covers the
        sampler's own cadence, not the pipeline's lifetime)."""
        now = time.time() if now is None else now
        with self._lock:
            self.samples += 1
        names = self._names_fn()
        sampled = 0
        for ident, frame in list(self._frames_fn().items()):
            name = names.get(ident)
            if name is None:
                continue
            role = role_of(name)
            if role is None:
                continue
            self.record(role, walk_stack(frame), now)
            sampled += 1
        return sampled

    # -- lifecycle ----------------------------------------------------

    def start(self) -> None:
        if self.sample_hz <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="stack-sampler",
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        period = 1.0 / self.sample_hz
        while not self._stop.wait(timeout=period):
            try:
                self.sample_once()
            except Exception:
                continue  # a torn-down thread must not kill the sampler

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    # -- artifacts ----------------------------------------------------

    def folded_lines(self) -> List[str]:
        """The flamegraph-folded artifact body: one
        ``role;frame;...;leaf count`` line per distinct stack, sorted
        for deterministic output."""
        with self._lock:
            items = sorted(self._folded.items())
        return ["%s %d" % (";".join(key), count)
                for key, count in items]

    def write_folded(self, path: str) -> None:
        lines = self.folded_lines()
        with open(path, "w") as f:
            f.write("\n".join(lines))
            if lines:
                f.write("\n")

    def trace_events(self) -> List[Tuple]:
        """Per-sample timeline tiles as Tracer event tuples (the
        collection schema ``(name, ph, t0, dur_s, thread_name, rid,
        args)``) on synthetic ``stacks:<role>`` tracks — each tile is
        the role's top frame at that tick, one sampling period wide,
        so the merged trace.json shows the sampled execution ribbon
        under the instrumented spans."""
        period = 1.0 / self.sample_hz if self.sample_hz > 0 else 0.04
        with self._lock:
            timeline = list(self._timeline)
        return [(leaf, "X", t, period, "stacks:%s" % role, None, None)
                for t, role, leaf in timeline]

    def summary(self) -> Dict[str, int]:
        """The ``Stacks:`` log-meta line payload (and the ``stacks_*``
        BenchmarkResult fields): sampling ticks, distinct roles,
        distinct folded stacks, total per-thread samples — the folded
        artifact's counts sum to ``total`` exactly (--check re-sums
        them)."""
        with self._lock:
            return {
                "samples": self.samples,
                "threads": len(self._roles),
                "folded": len(self._folded),
                "total": sum(self._folded.values()),
            }
