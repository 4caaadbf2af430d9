"""Device observability plane: capture windows, live MFU, footprint ledger.

Counterpart of ``rnb_tpu/devobs.py``, behind the same root ``devobs``
config key, with three legs:

* **Unified timeline** — bounded ``torch.profiler`` capture windows
  (:mod:`rnb_tpu_torch.profiler`; config ``capture_window_ms``, the
  ``RNB_DEVOBS_FORCE`` env, or the flight recorder's triggers through
  the metrics registry's trigger hooks). Captured op intervals are
  written as bounded ``devobs-capture-<n>.txt`` artifacts (the
  ``xprof-ops.txt`` 4-column format ``scripts/device_busy.py`` reads)
  and merged into ``trace.json`` as ``device:<plane>`` tracks,
  time-aligned at the profiler session's start on the host's wall
  clock (the reference's flush-epoch anchor where that cannot hold; see
  :meth:`DevObsPlane.device_events`) and rid-correlated to the enclosing
  ``exec{i}.model_call`` spans, so the exporter's flow chains bind the
  device ops to their requests.
* **Live MFU** — per-dispatch achieved FLOPs: the stage's declared
  per-row count (``compute_profile()``, backed by
  :mod:`rnb_tpu_torch.models.r2p1d.flops`) x the ``num_clips`` rows
  the dispatch carried, over the measured ``inference{i}`` span. Per
  stage: achieved TFLOP/s over busy time and MFU against
  ``peak_tflops_for`` of the stage's card, streamed as ``compute.*``
  series and summarized in ``Compute:`` / ``Compute stages:`` lines
  whose job figures keep the reference's expression order and
  rounding.
* **Footprint ledger** — :mod:`rnb_tpu_torch.memledger`: params, cache,
  staging, ragged pool and page pool as declared owners, ``memory.*``
  gauges with peaks, a watermark that warns and fires the flight
  recorder, and a reconcile against ``torch.cuda.memory_allocated``.

With the ``devobs`` key absent nothing is installed: every hook is one
``None`` test and every artifact keeps the pre-devobs schema.
"""

from __future__ import annotations

import bisect
import os
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from rnb_tpu_torch import metrics, profiler
from rnb_tpu_torch.memledger import MemLedger
from rnb_tpu_torch.models.r2p1d.flops import (peak_tflops_for,
                                              range_flops_per_clip)

#: the active per-job plane, installed and cleared by
#: rnb_tpu_torch.benchmark
ACTIVE: Optional["DevObsPlane"] = None

#: env var forcing one capture window at run start
FORCE_ENV = "RNB_DEVOBS_FORCE"

DEFAULT_CAPTURE_WINDOW_MS = 0.0     # no configured window
DEFAULT_FORCED_WINDOW_MS = 250.0    # window for env/trigger captures
DEFAULT_MAX_CAPTURES = 4
DEFAULT_CAPTURE_MAX_OPS = 20000
DEFAULT_SAMPLE_HZ = 20.0

#: merged-trace track prefix
DEVICE_TRACK_PREFIX = "device:"

_MODEL_CALL_RE = re.compile(r"^exec\d+\.model_call$")


def note_dispatch(step_idx: int, rows: int, busy_s: float) -> None:
    """Per-dispatch compute feed. Disabled path: one ``None`` test.
    The executor resolves :func:`meter_for` once instead."""
    plane = ACTIVE
    if plane is None:
        return
    meter = plane.meters.get(step_idx)
    if meter is not None:
        meter.note(rows, busy_s)


def meter_for(step_idx: int) -> Optional["StageComputeMeter"]:
    """The step's compute meter, or None when devobs is off or the stage
    declared no compute profile — resolved once ahead of the executor's
    hot loop so the per-dispatch cost is one ``None`` test."""
    plane = ACTIVE
    if plane is None:
        return None
    return plane.meters.get(step_idx)


def register_stage(model, step_idx: int, device, handoff=None) -> None:
    """Stage-side registration (the executor calls it after building the
    stage, before the start barrier): the stage's compute profile
    becomes a meter and its byte-owning subsystems ledger sources. No-op
    when devobs is off."""
    plane = ACTIVE
    if plane is None:
        return
    plane.add_stage(model, step_idx, device, handoff)


# -- config-derived helpers ---------------------------------------------

def config_stage_views(config: dict):
    """Yield (step, [merged kwargs per queue_group]) with group keys
    overriding step keys, as the stage constructors see them."""
    for step in config.get("pipeline", []):
        groups = step.get("queue_groups") or [{}]
        views = []
        for group in groups:
            merged = dict(step)
            merged.update(group)
            views.append(merged)
        yield step, views


def flops_per_clip_for_config(config: dict) -> float:
    """Analytic conv+dense FLOPs one clip costs across every network
    stage of the pipeline (a layer-split pipeline sums its ranges back
    to the full net): the config-walk twin of the runtime
    ``compute_profile()``."""
    total = 0
    for step, views in config_stage_views(config):
        model = step.get("model", "")
        if not model.endswith((".R2P1DSingleStep", ".R2P1DMeshRunner",
                               ".R2P1DRunner")):
            continue
        # one clip flows through one replica of the step: count the step
        # once, from the first group's merged view
        view = views[0]
        kwargs = dict(
            consecutive_frames=view.get("consecutive_frames", 8),
            num_classes=view.get("num_classes", 400),
            factored_shortcut=view.get("factored_shortcut", False))
        if view.get("layer_sizes") is not None:
            kwargs["layer_sizes"] = tuple(view["layer_sizes"])
        if model.endswith(".R2P1DRunner"):
            start = view.get("start_index", 1)
            end = view.get("end_index", 5)
        else:
            start, end = 1, 5
        total += range_flops_per_clip(start, end, **kwargs)
    return float(total)


def latency_semantics(config: dict) -> str:
    """What a job's p50/p99 measure (``bench.py``'s rule): "dispatch"
    where a stage publishes before its device work ends (an
    ``async_dispatch`` step, or a mesh stage with ``sync_preds`` false),
    else "completion"."""
    for step, views in config_stage_views(config):
        for view in views:
            if view.get("async_dispatch"):
                return "dispatch"
            if (view.get("model", step.get("model", ""))
                    .endswith(".R2P1DMeshRunner")
                    and view.get("sync_preds") is False):
                return "dispatch"
    return "completion"


def devices_used(config: dict) -> int:
    """Distinct accelerator devices the topology touches (host -1
    excluded; a mesh stage counts its whole sub-mesh): the job MFU's
    denominator."""
    used = set()
    for _step, views in config_stage_views(config):
        for view in views:
            for dev in view.get("mesh_devices", []):
                used.add(int(dev))
            for dev in view.get("devices", []):
                if int(dev) >= 0:
                    used.add(int(dev))
    return max(1, len(used))


class DevObsSettings:
    """Validated per-job knobs (root config key ``devobs``)."""

    __slots__ = ("enabled", "capture_window_ms", "capture_on_trigger",
                 "max_captures", "capture_max_ops", "watermark_mb",
                 "sample_hz")

    def __init__(self, enabled: bool = True,
                 capture_window_ms: float = DEFAULT_CAPTURE_WINDOW_MS,
                 capture_on_trigger: bool = True,
                 max_captures: int = DEFAULT_MAX_CAPTURES,
                 capture_max_ops: int = DEFAULT_CAPTURE_MAX_OPS,
                 watermark_mb: Optional[float] = None,
                 sample_hz: float = DEFAULT_SAMPLE_HZ):
        self.enabled = bool(enabled)
        self.capture_window_ms = float(capture_window_ms)
        self.capture_on_trigger = bool(capture_on_trigger)
        self.max_captures = int(max_captures)
        self.capture_max_ops = int(capture_max_ops)
        self.watermark_mb = (float(watermark_mb)
                             if watermark_mb is not None else None)
        self.sample_hz = float(sample_hz)

    @staticmethod
    def from_config(raw: Optional[dict]) -> Optional["DevObsSettings"]:
        """Settings from the validated config dict, or None when the key
        is absent or ``enabled`` is false (devobs fully off)."""
        if raw is None:
            return None
        settings = DevObsSettings(
            enabled=raw.get("enabled", True),
            capture_window_ms=raw.get("capture_window_ms",
                                      DEFAULT_CAPTURE_WINDOW_MS),
            capture_on_trigger=raw.get("capture_on_trigger", True),
            max_captures=raw.get("max_captures", DEFAULT_MAX_CAPTURES),
            capture_max_ops=raw.get("capture_max_ops",
                                    DEFAULT_CAPTURE_MAX_OPS),
            watermark_mb=raw.get("watermark_mb"),
            sample_hz=raw.get("sample_hz", DEFAULT_SAMPLE_HZ))
        return settings if settings.enabled else None


class StageComputeMeter:
    """Per-step dispatch accounting: valid rows, dispatch count, busy
    seconds — times the stage's declared per-row FLOPs, the achieved
    TFLOP/s and MFU. Shared by a step's replica instances (one lock)."""

    __slots__ = ("step_idx", "flops_per_row", "devices",
                 "bytes_per_row", "_lock", "rows", "dispatches",
                 "busy_s")

    GUARDED_BY = {
        "rows": "_lock",
        "dispatches": "_lock",
        "busy_s": "_lock",
    }

    def __init__(self, step_idx: int, flops_per_row: int,
                 devices: int = 1,
                 bytes_per_row: Optional[float] = None):
        self.step_idx = int(step_idx)
        self.flops_per_row = int(flops_per_row)
        self.devices = max(1, int(devices))
        self.bytes_per_row = (float(bytes_per_row)
                              if bytes_per_row else None)
        self._lock = threading.Lock()
        self.rows = 0
        self.dispatches = 0
        self.busy_s = 0.0

    def note(self, rows: int, busy_s: float) -> None:
        with self._lock:
            self.rows += int(rows)
            self.dispatches += 1
            self.busy_s += max(0.0, float(busy_s))

    def snapshot(self) -> dict:
        with self._lock:
            return {"rows": self.rows, "dispatches": self.dispatches,
                    "busy_s": self.busy_s}

    def achieved_tflops(self) -> float:
        """Achieved TFLOP/s over this stage's busy time (0 with no busy
        time yet)."""
        snap = self.snapshot()
        if snap["busy_s"] <= 0.0:
            return 0.0
        return snap["rows"] * self.flops_per_row / snap["busy_s"] / 1e12


class _Capture:
    """One bounded profiler capture: host epoch bounds + per-plane op
    intervals (ns on each plane's own clock)."""

    __slots__ = ("index", "trigger", "t0_epoch", "t1_epoch",
                 "intervals", "total_ops", "path", "plane_anchors",
                 "start_epoch", "stop_epoch")

    def __init__(self, index: int, trigger: str, t0_epoch: float,
                 t1_epoch: float, intervals: List[Tuple],
                 total_ops: int, path: Optional[str],
                 plane_anchors: Optional[Dict[str, int]] = None,
                 start_epoch: Optional[float] = None,
                 stop_epoch: Optional[float] = None):
        self.index = index
        self.trigger = trigger
        self.t0_epoch = t0_epoch
        self.t1_epoch = t1_epoch
        self.intervals = intervals  # [(name, t0_ns, t1_ns, plane)]
        self.total_ops = total_ops
        self.path = path
        #: plane -> max end timestamp (ns) over the full capture,
        #: recorded before the op bound truncates to the earliest ops:
        #: the epoch-alignment anchor (t1_epoch maps here)
        self.plane_anchors = plane_anchors or {}
        #: the epoch second the intervals' zero stands for (the
        #: profiler session's start), and when the session had stopped;
        #: None where only the flush anchor is known
        self.start_epoch = start_epoch
        self.stop_epoch = stop_epoch


#: slack of the session-start alignment's bounds (seconds): the
#: window's opening is read before the session starts
ALIGN_SLACK_S = 0.05


def _within_session(cap: "_Capture", ivals: List[Tuple],
                    max_end: int) -> bool:
    """Whether a plane's ops, placed at the session's start, all fall
    between the window's opening and the session's stop."""
    stop = cap.stop_epoch if cap.stop_epoch is not None else cap.t1_epoch
    first = min(t0 for _n, t0, _t1 in ivals) / 1e9 + cap.start_epoch
    last = max_end / 1e9 + cap.start_epoch
    return (first >= cap.t0_epoch - ALIGN_SLACK_S
            and last <= stop + ALIGN_SLACK_S)


def model_call_spans(events: List[Tuple]) -> List[Tuple]:
    """The rid-correlated ``exec{i}.model_call`` spans of a Tracer event
    snapshot, sorted ``[(t0_s, t1_s, rid)]``: the flow anchors device
    ops correlate against."""
    spans = []
    for event_name, ph, t0, dur, _thread, rid, _args in events:
        if ph == "X" and rid is not None \
                and _MODEL_CALL_RE.match(event_name):
            spans.append((t0, t0 + max(0.0, dur), rid))
    spans.sort()
    return spans


class DevObsPlane:
    """Per-job device observability: capture worker + compute meters +
    the footprint ledger. Built by rnb_tpu_torch.benchmark when the
    ``devobs`` root config key is enabled; one instance per job."""

    GUARDED_BY = {
        "meters": "_lock",
        "captures": "_lock",
        "captures_skipped": "_lock",
        "_capture_requests": "_lock",
        "_captures_inflight": "_lock",
    }

    UNGUARDED_OK = {
        "_worker": "controller-thread lifecycle (start/stop)",
        "_peak_tflops": "idempotent memo — a racing duplicate probe "
                        "computes the same value",
        "_peak_resolved": "guards only the memo above; same "
                          "idempotence argument",
        "_peak_device": "written before the start barrier only",
    }

    def __init__(self, settings: DevObsSettings,
                 job_dir: Optional[str] = None, job_id: str = ""):
        self.settings = settings
        self.job_dir = job_dir
        self.job_id = job_id
        watermark_bytes = None
        if settings.watermark_mb is not None:
            watermark_bytes = int(settings.watermark_mb * (1 << 20))
        self.ledger = MemLedger(watermark_bytes=watermark_bytes)
        # metrics-less runs still get the watermark capture: the
        # ledger's direct observer arms it, deduped against the trigger
        # hook path (which delivers the same event with a registry)
        self.ledger.on_watermark = self._watermark_capture
        self.meters: Dict[int, StageComputeMeter] = {}
        self._lock = threading.Lock()
        self.captures: List[_Capture] = []
        self.captures_skipped = 0
        self._capture_requests: List[str] = []
        #: requests popped but not yet landed in ``captures``: part of
        #: the budget check, or a trigger firing mid-capture could
        #: overrun max_captures
        self._captures_inflight = 0
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._run_started = threading.Event()
        self._peak_tflops: Optional[float] = None
        self._peak_resolved = False
        #: the CUDA index of the first metered stage's card (None on
        #: the CPU): the device whose peak the MFU is held against
        self._peak_device: Optional[int] = None

    # -- stage registration -------------------------------------------

    def add_stage(self, model, step_idx: int, device,
                  handoff=None) -> None:
        device_label = getattr(device, "label", str(device))
        profile_fn = getattr(model, "compute_profile", None)
        profile = None
        if profile_fn is not None:
            try:
                profile = profile_fn()
            except Exception:
                profile = None
        if profile and int(profile.get("flops_per_row", 0)) > 0:
            with self._lock:
                if step_idx not in self.meters:
                    # replicas of one step share one meter
                    self.meters[step_idx] = StageComputeMeter(
                        step_idx, profile["flops_per_row"],
                        devices=profile.get("devices", 1),
                        bytes_per_row=profile.get("bytes_per_row"))
            resolve = getattr(device, "resolve", None)
            torch_device = resolve() if resolve is not None else None
            if self._peak_device is None and torch_device is not None \
                    and torch_device.type == "cuda":
                self._peak_device = torch_device.index or 0
            params_key = profile.get("params_key")
            params_bytes = int(profile.get("params_bytes", 0) or 0)
            if params_key is not None and params_bytes > 0:
                # deduped across stages sharing one network, and backed
                # by live device tensors (live=True enters the reconcile)
                self.ledger.register("params", device_label,
                                     params_key, params_bytes,
                                     live=True)
            pool_bytes = int(profile.get("pool_bytes", 0) or 0)
            if pool_bytes > 0:
                self.ledger.register("ragged_pool", device_label,
                                     ("pool", step_idx, id(model)),
                                     pool_bytes)
        cache = getattr(model, "cache", None)
        if cache is not None and hasattr(cache, "resident_bytes"):
            self.ledger.register(
                "cache", device_label, ("cache", id(cache)),
                lambda c=cache: c.resident_bytes)
        staging = getattr(model, "staging", None)
        if staging is not None and hasattr(staging, "snapshot"):
            self.ledger.register(
                "staging", device_label, ("staging", id(staging)),
                lambda s=staging: s.snapshot().get("slot_bytes", 0))
        if handoff is not None \
                and hasattr(handoff, "resident_bytes"):
            self.ledger.register(
                "handoff", device_label, ("handoff", id(handoff)),
                lambda h=handoff: h.resident_bytes)

    # -- capture windows ----------------------------------------------

    def request_capture(self, trigger: str) -> None:
        """Arm one bounded capture window (serviced by the worker, never
        profiler work on the caller's thread)."""
        with self._lock:
            if len(self.captures) + len(self._capture_requests) \
                    + self._captures_inflight \
                    >= self.settings.max_captures:
                self.captures_skipped += 1
                return
            self._capture_requests.append(str(trigger))

    def on_trigger(self, reason: str, detail: Optional[dict]) -> None:
        """Metrics-plane trigger hook: every anomaly trigger also arms a
        device capture."""
        if self.settings.capture_on_trigger:
            self.request_capture(reason)

    def _watermark_capture(self, total_bytes: int) -> None:
        """The ledger's direct watermark observer: arms the capture on
        metrics-less runs. With a live registry the same crossing
        arrives through the trigger hook, so this side defers to it."""
        if metrics.ACTIVE is not None:
            return
        if self.settings.capture_on_trigger:
            self.request_capture(metrics.TRIGGER_MEMORY_WATERMARK)

    def _capture_once(self, trigger: str) -> None:
        window_ms = self.settings.capture_window_ms \
            or DEFAULT_FORCED_WINDOW_MS
        t0 = time.time()
        try:
            profiler.initialize()
            t_started = time.time()
        except RuntimeError:
            # another session owns the profiler (a --profile run):
            # skip, never break the run
            with self._lock:
                self.captures_skipped += 1
            return
        try:
            # interruptible window: teardown must not wait a full
            # window out
            self._stop.wait(timeout=window_ms / 1000.0)
        finally:
            # anchor before flush: stopping and reading the session
            # takes time, and the alignment rule maps the last captured
            # op to this instant
            t1 = time.time()
            profiler.flush()
            t_stopped = time.time()
        intervals = profiler.report(include_plane=True)
        # the session's zero in epoch seconds: kineto's own start where
        # its clock is the wall clock (it then lies between the two
        # reads around the start), else the instant the start returned
        base_ns = profiler.last_trace_start_ns()
        start_epoch = t_started
        if base_ns is not None and t0 <= base_ns / 1e9 <= t_started:
            start_epoch = base_ns / 1e9
        total_ops = len(intervals)
        # per-plane anchors over the full set: the bound below keeps the
        # earliest ops, so anchoring on the kept maximum would misplace
        # a truncated capture by the dropped tail's extent
        plane_anchors: Dict[str, int] = {}
        for _name, _s, e, plane in intervals:
            if e > plane_anchors.get(plane, 0):
                plane_anchors[plane] = e
        # bounded artifact: the cap is part of the contract
        kept = intervals[:self.settings.capture_max_ops]
        with self._lock:
            index = len(self.captures)
        path = None
        if self.job_dir is not None:
            path = os.path.join(self.job_dir,
                                "devobs-capture-%d.txt" % index)
            with open(path, "w") as f:
                f.write("# t0_ns t1_ns plane op_name\n")
                f.write("# window_epoch %f %f flush_epoch %f\n"
                        % (t0, t1, t1))
                f.write("# trigger %s ops_total %d ops_written %d\n"
                        % (trigger.replace(" ", "_"), total_ops,
                           len(kept)))
                for name, s, e, plane in kept:
                    f.write("%d %d %s %s\n"
                            % (s, e, plane.replace(" ", "_") or "-",
                               name))
        with self._lock:
            self.captures.append(_Capture(index, trigger, t0, t1,
                                          kept, total_ops, path,
                                          plane_anchors, start_epoch,
                                          t_stopped))

    # -- worker --------------------------------------------------------

    def start(self) -> None:
        """Start the worker (before the start barrier). kineto's first
        session of the process, seconds of CUPTI set-up on the card, runs
        here, so no capture in the window pays it."""
        profiler.warm_up()
        if self._worker is None:
            self._worker = threading.Thread(target=self._run,
                                            name="devobs-worker",
                                            daemon=True)
            self._worker.start()

    def note_run_started(self) -> None:
        """The measured window opened (start barrier released): the
        configured/forced capture windows begin now, so no warm-up lands
        in a capture."""
        self._run_started.set()

    def _run(self) -> None:
        period = 1.0 / max(1e-3, self.settings.sample_hz)
        self._run_started.wait(timeout=1800.0)
        if os.environ.get(FORCE_ENV):
            self.request_capture("forced")
        if self.settings.capture_window_ms > 0:
            self.request_capture("window")
        while not self._stop.wait(timeout=period):
            try:
                self.ledger.sample()
                self._service_captures()
            except Exception:
                continue  # the worker must outlive any bad probe
        # drain any still-armed capture with the stop flag set: the
        # window wait returns at once, so the forced-capture contract
        # (env set => artifact exists) holds even for very short runs
        try:
            self._service_captures()
        except Exception:
            pass

    def _service_captures(self) -> None:
        while True:
            with self._lock:
                if not self._capture_requests:
                    return
                trigger = self._capture_requests.pop(0)
                self._captures_inflight += 1
            try:
                self._capture_once(trigger)
            finally:
                with self._lock:
                    self._captures_inflight -= 1

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        self._run_started.set()
        if self._worker is not None:
            self._worker.join(timeout=timeout)
            self._worker = None

    # -- metrics bridge -----------------------------------------------

    def _peak(self) -> Optional[float]:
        """The dense bf16 peak of the metered stages' card, or None on
        the CPU and for a card the table does not name."""
        if not self._peak_resolved:
            self._peak_resolved = True
            if self._peak_device is not None:
                self._peak_tflops = peak_tflops_for(
                    torch.cuda.get_device_name(self._peak_device))
        return self._peak_tflops

    def metrics_poll(self) -> List[Tuple[str, str, float]]:
        """Registry poll source: ``compute.*`` per-stage series and
        ``memory.*`` ledger gauges, read each flusher tick. Doubles as a
        ledger sampling site."""
        out: List[Tuple[str, str, float]] = []
        peak = self._peak()
        with self._lock:
            meters = list(self.meters.values())
        for meter in meters:
            snap = meter.snapshot()
            step = meter.step_idx
            out.append(("counter",
                        metrics.name("compute.s%d.rows", step),
                        snap["rows"]))
            out.append(("counter",
                        metrics.name("compute.s%d.dispatches", step),
                        snap["dispatches"]))
            tflops = meter.achieved_tflops()
            out.append(("gauge",
                        metrics.name("compute.s%d.tflops", step),
                        tflops))
            if peak:
                out.append(("gauge",
                            metrics.name("compute.s%d.mfu", step),
                            tflops / (peak * meter.devices)))
        record = self.ledger.sample()
        out.append(("gauge", metrics.name("memory.total_bytes"),
                    record["total"]))
        out.append(("gauge", metrics.name("memory.peak_bytes"),
                    self.ledger.peak_total))
        owner_gauges = {
            "params": metrics.name("memory.params_bytes"),
            "cache": metrics.name("memory.cache_bytes"),
            "staging": metrics.name("memory.staging_bytes"),
            "ragged_pool": metrics.name("memory.ragged_pool_bytes"),
            "handoff": metrics.name("memory.handoff_bytes"),
            "page_pool": metrics.name("memory.page_pool_bytes"),
        }
        for owner, nbytes in sorted(record["owners"].items()):
            gauge_name = owner_gauges.get(owner)
            if gauge_name is not None:
                out.append(("gauge", gauge_name, nbytes))
        return out

    # -- trace merge ---------------------------------------------------

    def device_events(self, spans: List[Tuple]) -> List[Tuple]:
        """Captured op intervals as Tracer event tuples on synthetic
        ``device:<plane>`` tracks, epoch-aligned per plane and
        rid-correlated to the enclosing ``model_call`` span, so the
        exporter's flow chains bind them to their request. ``spans``
        comes from :func:`model_call_spans`.

        Alignment departs from the reference's rule, which maps each
        plane's last op to the capture's flush epoch: that holds only
        while the card works up to the window's end. When the pipeline
        drains inside the window (a short run), every op would land
        after its span by the idle tail and bind to nothing. kineto
        stamps its ops on the host's wall clock from the session's
        start, so a plane is placed at ``start_epoch`` where all of its
        ops then fall between the window's opening and the session's
        stop; otherwise (another clock, or a capture that recorded no
        start) the reference's flush anchor applies."""
        starts = [s[0] for s in spans]
        # running max-end prefix: model_call spans overlap across lanes
        # and steps, so walk back while an earlier span could still
        # reach t, preferring the latest-started (innermost) one
        maxend: List[float] = []
        running = float("-inf")
        for _t0, t1, _rid in spans:
            running = max(running, t1)
            maxend.append(running)

        def rid_at(t: float) -> Optional[int]:
            idx = bisect.bisect_right(starts, t) - 1
            while idx >= 0 and maxend[idx] >= t:
                if spans[idx][1] >= t:
                    return spans[idx][2]
                idx -= 1
            return None

        events: List[Tuple] = []
        with self._lock:
            captures = list(self.captures)
        for cap in captures:
            by_plane: Dict[str, List[Tuple]] = {}
            for name, t0_ns, t1_ns, plane in cap.intervals:
                by_plane.setdefault(plane, []).append(
                    (name, t0_ns, t1_ns))
            for plane, ivals in sorted(by_plane.items()):
                # per-plane anchoring, on the full capture's anchor
                # where recorded (the kept set may be a truncated prefix)
                max_end = cap.plane_anchors.get(
                    plane, max(t1 for _n, _t0, t1 in ivals))
                offset = cap.t1_epoch - max_end / 1e9
                if cap.start_epoch is not None and _within_session(
                        cap, ivals, max_end):
                    offset = cap.start_epoch
                track = DEVICE_TRACK_PREFIX + plane
                for name, t0_ns, t1_ns in ivals:
                    t0 = t0_ns / 1e9 + offset
                    dur = max(0.0, (t1_ns - t0_ns) / 1e9)
                    rid = rid_at(t0 + dur / 2.0)
                    events.append((name, "X", t0, dur, track, rid,
                                   {"devobs_capture": cap.index}))
        return events

    # -- summaries -----------------------------------------------------

    def compute_summary(self, total_time_s: float,
                        devices_used_count: int) -> Optional[dict]:
        """The ``Compute:`` / ``Compute stages:`` record. Job-level
        tflops/mfu keep the reference's expression order (``rows/s *
        flops_per_clip / 1e12``), denominator (``peak * devices_used``)
        and rounding (3 digits tflops, 4 digits mfu); per-stage figures
        use each stage's busy time. With no flops-declaring stage the
        record still carries the capture counter."""
        with self._lock:
            meters = sorted(self.meters.values(),
                            key=lambda m: m.step_idx)
        peak = self._peak()
        stage_detail: Dict[str, dict] = {}
        flops_total = 0
        dispatches_total = 0
        for meter in meters:
            snap = meter.snapshot()
            stage_flops = snap["rows"] * meter.flops_per_row
            flops_total += stage_flops
            dispatches_total += snap["dispatches"]
            busy_s = snap["busy_s"]
            tflops_busy = (stage_flops / busy_s / 1e12
                           if busy_s > 0 else 0.0)
            entry = {
                "rows": snap["rows"],
                "dispatches": snap["dispatches"],
                "flops_per_row": meter.flops_per_row,
                "flops": stage_flops,
                "busy_us": int(round(busy_s * 1e6)),
                "devices": meter.devices,
                "tflops_busy": round(tflops_busy, 6),
                "mfu_busy": (round(tflops_busy
                                   / (peak * meter.devices), 6)
                             if peak else None),
                "ai_flops_per_byte": (
                    round(meter.flops_per_row / meter.bytes_per_row, 3)
                    if meter.bytes_per_row else None),
            }
            stage_detail["step%d" % meter.step_idx] = entry
        # job level: rows at the last flops-bearing stage are the
        # completed clips, and the per-clip cost is the sum over stages
        rows_job = meters[-1].snapshot()["rows"] if meters else 0
        flops_per_clip = float(sum(m.flops_per_row for m in meters))
        clips_per_sec = (rows_job / total_time_s
                         if total_time_s > 0 else 0.0)
        tflops = clips_per_sec * flops_per_clip / 1e12
        mfu = (tflops / (peak * devices_used_count)
               if peak else None)
        with self._lock:
            num_captures = len(self.captures)
        return {
            "stages": len(meters),
            "dispatches": dispatches_total,
            "rows": rows_job,
            "flops_total": flops_total,
            "window_us": int(round(total_time_s * 1e6)),
            "tflops_milli": int(round(round(tflops, 3) * 1000)),
            "mfu_e4": (int(round(round(mfu, 4) * 10000))
                       if mfu is not None else -1),
            "captures": num_captures,
            "stage_detail": stage_detail,
        }

    def memory_summary(self) -> dict:
        """The ``Memory:`` / ``Memory owners:`` record: the ledger's
        settled snapshot plus the allocator reconcile."""
        snap = self.ledger.snapshot()
        live_bytes, ok = self.ledger.reconcile()
        snap["live_bytes"] = live_bytes
        snap["reconciled"] = 1 if (live_bytes > 0 and ok) else 0
        return snap
