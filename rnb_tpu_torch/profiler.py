"""Device-op profiler bridge: per-op (name, start_ns, end_ns) timelines.

Counterpart of ``rnb_tpu/profiler.py``, with its three-call contract:

* :func:`initialize` — start a ``torch.profiler`` session (kineto, with
  CUPTI underneath on the card);
* :func:`flush` — stop it;
* :func:`report` — the session's events as ``[(op_name, start_ns,
  end_ns)]`` (or with the plane appended), clearing captured state.

One session per process: a second :func:`initialize` while one runs
raises ``RuntimeError``, and the benchmark's ``--profile`` window goes
through the same guard, so a devobs capture inside it is skipped and
counted, never opened twice.

On the card the session records ``ProfilerActivity.CUDA`` only (CUPTI
traces the whole process, so kernels launched from any thread and inside
CUDA-graph replays are seen), and each kernel, copy or set lands on the
plane ``/device:GPU:<index>``. On the CPU (the tests) it records CPU
operators of every thread where the installed torch can, on
``/host:CPU``. ``report()`` prefers device planes and falls back to
everything, as the reference's does.

The reference parses ``.xplane.pb`` files that ``jax.profiler`` wrote to
disk (natively by ``native/xplane.cpp``, else in Python). kineto hands
the events back in process, so the port has no file and no parser: it
reads kineto's raw event list, not the profiler's ``events()`` (which
builds an operator tree in Python). Timestamps are nanoseconds from the session's start, comparable
within one plane.

The first session of a process sets CUPTI up, seconds on the card; later
ones start in milliseconds (``rnb_tpu_torch/tools/profiler_probe.py``
measures both). :func:`warm_up` pays the first before a measured window.
CUPTI stays set up between sessions (``TEARDOWN_CUPTI=0``, unless the
caller's environment says otherwise): torch applies the same rule to its
own CUDA graphs, whose replays do not survive CUPTI being torn down and
set up again, and a session of the card's serving runners replays
graphs.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Sequence, Tuple, Union

import torch

Interval = Tuple[str, int, int]
#: surfaced by ``report(include_plane=True)``
PlaneInterval = Tuple[str, int, int, str]

DEVICE_PLANE_MARKER = "/device:"
HOST_PLANE = "/host:CPU"

_state_lock = threading.Lock()
#: the running session, or the stopped one whose events report() drains
_session: Optional["torch.profiler.profile"] = None
_capturing = False


def _all_threads_config():
    """kineto's option to record CPU operators of every thread, where
    the installed torch has it (None otherwise)."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def initialize(activities: Optional[Sequence] = None
               ) -> "torch.profiler.profile":
    """Begin capturing device activity: by default the card's kernels
    where there is a card, else every thread's CPU operators. Returns the
    session (the ``--profile`` window reads its ``key_averages()`` after
    :func:`flush`). Raises ``RuntimeError`` while another session runs."""
    global _session, _capturing
    kwargs = {}
    # read by kineto when a session stops (torch/profiler/profiler.py
    # sets it for the graphs it captures itself)
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    if activities is None:
        if torch.cuda.is_available():
            activities = [torch.profiler.ProfilerActivity.CUDA]
        else:
            activities = [torch.profiler.ProfilerActivity.CPU]
            config = _all_threads_config()
            if config is not None:
                kwargs["experimental_config"] = config
    with _state_lock:
        if _capturing:
            raise RuntimeError("profiler already initialized")
        session = torch.profiler.profile(activities=list(activities),
                                         **kwargs)
        session.start()
        _session = session
        _capturing = True
        return session


def flush() -> None:
    """Stop the session; its events stay for :func:`report`."""
    global _capturing
    with _state_lock:
        if not _capturing:
            return
        _capturing = False
        _session.stop()


def discard(session) -> None:
    """Drop ``session`` if it is the stopped one :func:`report` would
    drain (a ``--profile`` window that read its own table, or the
    warm-up): its events are nobody's capture."""
    global _session
    with _state_lock:
        if not _capturing and _session is session:
            _session = None


def warm_up() -> None:
    """Run one empty session, so that the next starts at once. Skipped
    while another session runs (that one set kineto up already)."""
    try:
        session = initialize()
    except RuntimeError:
        return
    flush()
    discard(session)


def _intervals(session) -> List[PlaneInterval]:
    result = session.profiler.kineto_results
    base = result.trace_start_ns()
    out = []
    for event in result.events():
        if event.device_type() == torch.autograd.DeviceType.CUDA:
            plane = "/device:GPU:%d" % event.device_index()
        else:
            plane = HOST_PLANE
        out.append((event.name(), event.start_ns() - base,
                    event.end_ns() - base, plane))
    return out


def report(plane_filter: Optional[str] = None,
           include_plane: bool = False
           ) -> Union[List[Interval], List[PlaneInterval]]:
    """-> captured ``[(op_name, start_ns, end_ns)]`` sorted by start;
    drains the stopped session (an empty list while one still runs or
    none ran).

    ``plane_filter`` keeps only planes whose name contains the string.
    Default: device planes if any exist, else all planes (so the same
    caller runs on the card and on the CPU). ``include_plane`` appends
    the owning plane name to each tuple; timestamps are comparable only
    within one plane.
    """
    global _session
    with _state_lock:
        if _capturing or _session is None:
            return []
        session, _session = _session, None
    intervals = _intervals(session)
    if plane_filter is not None:
        intervals = [iv for iv in intervals if plane_filter in iv[3]]
    else:
        device = [iv for iv in intervals if DEVICE_PLANE_MARKER in iv[3]]
        intervals = device or intervals
    if not include_plane:
        intervals = [(name, t0, t1) for name, t0, t1, _plane in intervals]
    intervals.sort(key=lambda t: t[1])
    return intervals
