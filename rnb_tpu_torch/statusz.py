"""The operator plane: a live introspection & control HTTP server.

Counterpart of ``rnb_tpu/statusz.py``, the port's own copy: the same
endpoints, payloads, gating and request ledger, over the port's own
registries. A threaded stdlib-HTTP server (one ``ThreadingHTTPServer``
on loopback, root config key ``operator: {enabled, port, allow_actions,
sample_hz}``) serves what the planes already hold — nothing is
re-measured:

* ``GET /healthz`` — lane-health board states
  (:class:`rnb_tpu_torch.health.LaneHealthBoard` snapshots of the
  replica lanes; the port has none yet, so the map is empty) + the
  termination flag;
* ``GET /metrics`` — the Prometheus text exposition rendered from the
  live :class:`rnb_tpu_torch.metrics.MetricsRegistry` (the same
  renderer as the teardown ``metrics.prom``);
* ``GET /statusz`` — one human HTML page: pipeline topology, queue
  depths, lane states, SLO burn, memory owners, compute gauges;
* ``GET /whatif`` — the calibrated counterfactual
  (:meth:`rnb_tpu_torch.whatif.WhatIfModel.query`) answered from the
  latest metrics snapshot;
* ``GET /stacks`` — an all-thread stack dump;
* ``POST /flight`` / ``POST /capture`` — force a flight-recorder dump
  / arm a devobs capture window (``torch.profiler``; skipped and counted
  while ``--profile``/``--xprof`` hold the one session). Both are gated
  by ``operator.allow_actions`` (default false: a 403, counted in the
  ``denied`` ledger).

A handler never touches a CUDA tensor: every payload is a host
snapshot that its registry's lock guards. The bound address is written
to ``logs/<job>/operator.json`` at start (``port: 0`` binds an
ephemeral port), and the request ledger (scrapes / actions / denied /
errors) lands in the ``Operator:`` log-meta line + ``operator_*``
BenchmarkResult fields, which ``parse_utils`` holds to the artifact.
With the ``operator`` key absent nothing binds and every log stays
byte-identical.
"""

from __future__ import annotations

import html
import json
import os
import sys
import threading
import time
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

from rnb_tpu_torch import lockwitness

#: the loopback-only bind host: the operator plane is a per-process
#: control endpoint, not a public service
BIND_HOST = "127.0.0.1"

#: endpoint inventory written into operator.json (the machine-readable
#: "what can I ask this process" contract)
ENDPOINTS = ("/healthz", "/metrics", "/statusz", "/whatif", "/stacks",
             "/flight", "/capture")


class OperatorSettings:
    """Validated per-job knobs (root config key ``operator``)."""

    __slots__ = ("enabled", "port", "allow_actions", "sample_hz")

    def __init__(self, enabled: bool = True, port: int = 0,
                 allow_actions: bool = False,
                 sample_hz: Optional[float] = None):
        from rnb_tpu_torch.stacksampler import DEFAULT_SAMPLE_HZ
        self.enabled = bool(enabled)
        self.port = int(port)
        self.allow_actions = bool(allow_actions)
        self.sample_hz = (DEFAULT_SAMPLE_HZ if sample_hz is None
                          else float(sample_hz))

    @staticmethod
    def from_config(raw: Optional[dict]) -> Optional["OperatorSettings"]:
        """Settings from the validated config dict, or None when the
        key is absent or ``enabled`` is false (operator plane fully
        off: no server, no sampler, byte-stable logs)."""
        if raw is None:
            return None
        settings = OperatorSettings(
            enabled=raw.get("enabled", True),
            port=raw.get("port", 0),
            allow_actions=raw.get("allow_actions", False),
            sample_hz=raw.get("sample_hz"))
        return settings if settings.enabled else None


def _dump_all_stacks() -> str:
    """Text dump of every live thread's stack (the ``/stacks``
    payload) — name, daemon flag, and the full frame chain."""
    names = {t.ident: t for t in threading.enumerate()
             if t.ident is not None}
    parts: List[str] = []
    for ident, frame in sorted(sys._current_frames().items()):
        t = names.get(ident)
        label = t.name if t is not None else "ident-%d" % ident
        daemon = " daemon" if t is not None and t.daemon else ""
        parts.append("== thread %r (ident %d%s)" % (label, ident,
                                                    daemon))
        parts.append("".join(traceback.format_stack(frame)).rstrip())
        parts.append("")
    return "\n".join(parts) + "\n"


def parse_whatif_query(query: str) -> Dict[str, object]:
    """``/whatif`` query string -> the WhatIfModel.query spec.

    Vocabulary (mirroring rnb_tpu_torch.whatif exactly):
    ``replicas_step<i>=<n|+k|-k>``, ``service_scale_step<i>=<f>`` and
    ``shard_degree_step<i>=<k>`` (one per step),
    ``arrival_scale=<f>``, ``pool_rows=<n>``. Unknown keys raise
    ValueError so a typo'd probe fails loudly (400), never as a
    silently-ignored knob."""
    spec: Dict[str, object] = {}
    replicas: Dict[str, object] = {}
    service_scale: Dict[str, float] = {}
    shard_degree: Dict[str, int] = {}
    for key, values in urllib.parse.parse_qs(
            query, keep_blank_values=True).items():
        value = values[-1]
        if value != value.strip():
            # query-string decoding turns an unencoded '+' into a
            # space — silently reading '+1' as the absolute count 1
            # would answer a scale-DOWN counterfactual for a scale-up
            # question; fail loudly with the fix instead
            raise ValueError(
                "value %r for %r carries whitespace — URL-encode a "
                "relative '+N' delta as %%2BN" % (value, key))
        if key.startswith("replicas_step") \
                and key[len("replicas_step"):].isdigit():
            step_key = key[len("replicas_"):]
            if value.startswith(("+", "-")):
                replicas[step_key] = value
            else:
                replicas[step_key] = int(value)
        elif key.startswith("service_scale_step") \
                and key[len("service_scale_step"):].isdigit():
            service_scale[key[len("service_scale_"):]] = float(value)
        elif key.startswith("shard_degree_step") \
                and key[len("shard_degree_step"):].isdigit():
            degree = int(value)
            if degree < 1:
                raise ValueError(
                    "shard degree must be >= 1, got %d" % degree)
            shard_degree[key[len("shard_degree_"):]] = degree
        elif key == "arrival_scale":
            spec[key] = float(value)
        elif key == "pool_rows":
            spec[key] = int(value)
        else:
            raise ValueError(
                "unknown whatif parameter %r (known: "
                "replicas_step<i>, service_scale_step<i>, "
                "shard_degree_step<i>, arrival_scale, pool_rows)"
                % key)
    if replicas:
        spec["replicas"] = replicas
    if service_scale:
        spec["service_scale"] = service_scale
    if shard_degree:
        spec["shard_degree"] = shard_degree
    return spec


class OperatorServer:
    """Threaded loopback HTTP server over the job's live registries.

    Every provider is an object the launcher already built (metrics
    registry, health boards, devobs plane, the raw config) or a cheap
    probe callable — the server *reads*, it never measures. One
    request ledger (scrapes / actions / denied / errors) under one
    lock backs the ``Operator:`` line.
    """

    GUARDED_BY = {
        "scrapes": "_lock",
        "actions": "_lock",
        "denied": "_lock",
        "errors": "_lock",
    }

    UNGUARDED_OK = {
        "_httpd": "controller-thread lifecycle (start/stop)",
        "_thread": "controller-thread lifecycle (start/stop)",
        "port": "written once by start() before the serve thread "
                "launches; later reads see an immutable publish",
    }

    def __init__(self, settings: OperatorSettings,
                 job_dir: Optional[str] = None, job_id: str = "",
                 metrics_registry=None,
                 boards: Optional[Dict[int, object]] = None,
                 devobs_plane=None,
                 config_raw: Optional[dict] = None,
                 topology: Optional[dict] = None,
                 queue_probes: Tuple = (),
                 termination=None,
                 window: Optional[dict] = None,
                 sampler=None):
        self.settings = settings
        self.job_dir = job_dir
        self.job_id = job_id
        self.metrics_registry = metrics_registry
        self.boards = dict(boards or {})
        self.devobs_plane = devobs_plane
        self.config_raw = config_raw or {}
        self.topology = topology or {}
        #: [(name, qsize_fn, capacity)] — the same probes the metrics
        #: plane samples, passed explicitly so /statusz shows depths
        #: even on metrics-off runs
        self.queue_probes = list(queue_probes)
        self.termination = termination
        #: mutable {"t0": epoch_s | None} the launcher stamps at the
        #: start barrier — the measured-window clock /whatif and
        #: /statusz report against
        self.window = window if window is not None else {"t0": None}
        self.sampler = sampler
        self._t_started = time.time()
        self._lock = lockwitness.lock("OperatorServer._lock")
        self.scrapes = 0
        self.actions = 0
        self.denied = 0
        self.errors = 0
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    # -- lifecycle ----------------------------------------------------

    def start(self) -> None:
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((BIND_HOST,
                                           self.settings.port), handler)
        # non-daemon handler threads: server_close() (stop below) then
        # JOINS any in-flight request, so the ledger is final when
        # summary() is read — a handler cannot bump a counter after
        # the Operator: line is written. The per-request socket
        # timeout on the Handler bounds how long that join can take.
        self._httpd.daemon_threads = False
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="operator-server", daemon=True)
        self._thread.start()
        if self.job_dir is not None:
            self._write_address()

    def _write_address(self) -> None:
        record = {
            "host": BIND_HOST,
            "port": self.port,
            "url": "http://%s:%d" % (BIND_HOST, self.port),
            "pid": os.getpid(),
            "job_id": self.job_id,
            "allow_actions": self.settings.allow_actions,
            "sample_hz": self.settings.sample_hz,
            "endpoints": list(ENDPOINTS),
        }
        path = os.path.join(self.job_dir, "operator.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f, sort_keys=True, indent=2)
        os.replace(tmp, path)

    def stop(self, timeout: float = 5.0) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def summary(self) -> Dict[str, int]:
        """The ``Operator:`` log-meta line payload (and the
        ``operator_*`` BenchmarkResult fields)."""
        with self._lock:
            return {"scrapes": self.scrapes, "actions": self.actions,
                    "denied": self.denied, "errors": self.errors}

    # -- ledger -------------------------------------------------------

    def _count(self, field: str) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + 1)

    # -- payload builders (read-only over the live registries) --------

    def wall_s(self) -> float:
        t0 = self.window.get("t0")
        if t0 is None:
            return 0.0
        return max(0.0, time.time() - t0)

    def healthz_payload(self) -> Dict[str, object]:
        lanes: Dict[str, str] = {}
        for board in self.boards.values():
            snap = board.snapshot()
            for q, detail in dict(snap.get("lane_detail", {})).items():
                lanes[str(q)] = str(detail.get("state"))
        degraded = sorted(q for q, state in lanes.items()
                          if state not in ("healthy", "suspect"))
        # TerminationFlag.UNSET is -1 (still serving); 0 is the clean
        # target-reached drain; positive codes are error terminations
        flag = (int(self.termination.value)
                if self.termination is not None else -1)
        if degraded:
            status = "degraded"
        elif flag < 0:
            status = "ok"
        elif flag == 0:
            status = "draining"
        else:
            status = "terminating"
        return {
            "status": status,
            "job_id": self.job_id,
            "serving": flag < 0,
            "termination_flag": flag,
            "boards": len(self.boards),
            "lanes": lanes,
            "degraded_lanes": degraded,
            "uptime_s": round(time.time() - self._t_started, 3),
            "window_s": round(self.wall_s(), 3),
        }

    def _whatif_model(self):
        registry = self.metrics_registry
        if registry is None:
            return None
        snapshot = registry.final_snapshot()
        if snapshot is None:
            return None
        from rnb_tpu_torch import whatif as whatif_mod
        return whatif_mod.calibrate_from_snapshot(
            snapshot,
            whatif_mod.steps_info_from_config(self.config_raw),
            wall_s=max(1e-6, self.wall_s()),
            arrival_hz=whatif_mod.arrival_hz_from_snapshot(snapshot))

    def whatif_payload(self, query: str) -> Tuple[int, Dict[str, object]]:
        try:
            spec = parse_whatif_query(query)
        except (ValueError, TypeError) as e:
            return 400, {"error": str(e)}
        model = self._whatif_model()
        if model is None:
            return 503, {"error": "whatif needs the live metrics plane "
                                  "(root 'metrics' key) and at least "
                                  "one streamed snapshot"}
        out = dict(model.query(spec or None))
        out["calibrated"] = bool(model.calibrated)
        out["stages"] = len(model.stages)
        out["spec"] = spec
        return 200, out

    def statusz_html(self) -> str:
        """The one human page, every section read from an existing
        registry and individually fault-isolated (a dying provider
        renders as its error string, never a 500)."""
        sections: List[str] = []

        def section(title: str, build: Callable[[], str]) -> None:
            try:
                body = build()
            except Exception as e:  # noqa: BLE001 - shown, not hidden
                body = "<i>unavailable: %s</i>" % html.escape(str(e))
            sections.append("<h2>%s</h2>\n%s" % (html.escape(title),
                                                 body))

        def topology() -> str:
            steps = self.topology.get("steps", [])
            if not steps:
                return "<i>no topology</i>"
            rows = "".join(
                "<tr><td>step%d</td><td>%s</td><td>%d</td><td>%d</td>"
                "<td>%s</td></tr>"
                % (s["step"], html.escape(str(s["model"])),
                   s["groups"], s["instances"],
                   html.escape(str(s["replica_lanes"] or "-")))
                for s in steps)
            return ("<table border=1 cellpadding=4><tr><th>step</th>"
                    "<th>model</th><th>groups</th><th>instances</th>"
                    "<th>replica lanes</th></tr>%s</table>" % rows)

        def queues() -> str:
            if not self.queue_probes:
                return "<i>no probes</i>"
            rows = []
            for name, fn, capacity in self.queue_probes:
                try:
                    depth = fn()
                except Exception:
                    depth = "?"
                rows.append("<tr><td>%s</td><td>%s</td><td>%s</td></tr>"
                            % (html.escape(str(name)), depth,
                               capacity if capacity else "-"))
            return ("<table border=1 cellpadding=4><tr><th>queue</th>"
                    "<th>depth</th><th>capacity</th></tr>%s</table>"
                    % "".join(rows))

        def lanes() -> str:
            payload = self.healthz_payload()
            if not payload["lanes"]:
                return ("<i>no replica lanes (health plane off or no "
                        "replicated step)</i>")
            rows = "".join(
                "<tr><td>lane %s</td><td>%s</td></tr>"
                % (html.escape(q), html.escape(state))
                for q, state in sorted(payload["lanes"].items()))
            return ("<table border=1 cellpadding=4><tr><th>lane</th>"
                    "<th>state</th></tr>%s</table>" % rows)

        def slo() -> str:
            registry = self.metrics_registry
            if registry is None:
                return "<i>metrics plane off</i>"
            snapshot = registry.final_snapshot()
            if snapshot is None:
                return "<i>no snapshot yet</i>"
            gauges = dict(snapshot.get("gauges", {}))
            counters = dict(snapshot.get("counters", {}))
            return ("goodput %.3f/s, burn %.3f; tracked %d / within "
                    "%d / missed %d (snapshot seq %s)"
                    % (gauges.get("slo.goodput_vps", 0.0),
                       gauges.get("slo.burn_rate", 0.0),
                       counters.get("slo.tracked", 0),
                       counters.get("slo.within", 0),
                       counters.get("slo.missed", 0),
                       snapshot.get("seq")))

        def memory() -> str:
            plane = self.devobs_plane
            if plane is None:
                return "<i>devobs plane off</i>"
            # peek, never sample: a GET must not update peaks or fire
            # the watermark trigger (that would be ungated actuation)
            record = plane.ledger.peek()
            if record is None:
                return "<i>no ledger sample yet</i>"
            rows = "".join(
                "<tr><td>%s</td><td>%d</td></tr>"
                % (html.escape(owner), nbytes)
                for owner, nbytes
                in sorted(dict(record["owners"]).items()))
            return ("total %d bytes (peak %d)<br>"
                    "<table border=1 cellpadding=4><tr><th>owner</th>"
                    "<th>bytes</th></tr>%s</table>"
                    % (record["total"], plane.ledger.peak_total, rows))

        def compute() -> str:
            plane = self.devobs_plane
            if plane is None:
                return "<i>devobs plane off</i>"
            rows = []
            for meter in list(plane.meters.values()):
                snap = meter.snapshot()
                rows.append(
                    "<tr><td>step%d</td><td>%d</td><td>%d</td>"
                    "<td>%.4f</td></tr>"
                    % (meter.step_idx, snap["dispatches"],
                       snap["rows"], meter.achieved_tflops()))
            if not rows:
                return "<i>no compute meters</i>"
            return ("<table border=1 cellpadding=4><tr><th>stage</th>"
                    "<th>dispatches</th><th>rows</th>"
                    "<th>tflops(busy)</th></tr>%s</table>"
                    % "".join(rows))

        def sampler() -> str:
            if self.sampler is None:
                return "<i>stack sampler off (operator.sample_hz 0)</i>"
            summary = self.sampler.summary()
            return ("%d tick(s) at %g Hz over %d role(s), %d distinct "
                    "stack(s), %d sample(s)"
                    % (summary["samples"], self.sampler.sample_hz,
                       summary["threads"], summary["folded"],
                       summary["total"]))

        section("Pipeline topology", topology)
        section("Queue depths", queues)
        section("Replica lanes", lanes)
        section("SLO", slo)
        section("Memory owners", memory)
        section("Compute", compute)
        section("Stack sampler", sampler)
        ledger = self.summary()
        return ("<!DOCTYPE html><html><head><title>rnb-tpu statusz"
                "</title></head><body><h1>rnb-tpu %s</h1>"
                "<p>measured window %.3f s; operator ledger: "
                "%d scrape(s), %d action(s), %d denied, %d error(s); "
                "actions %s</p>\n%s</body></html>"
                % (html.escape(self.job_id), self.wall_s(),
                   ledger["scrapes"], ledger["actions"],
                   ledger["denied"], ledger["errors"],
                   "enabled" if self.settings.allow_actions
                   else "disabled",
                   "\n".join(sections)))

    # -- actions ------------------------------------------------------

    def action_flight(self) -> Tuple[int, Dict[str, object]]:
        registry = self.metrics_registry
        if registry is None or registry.bridge is None \
                or registry.bridge.ring is None:
            return 503, {"error": "no flight recorder (metrics plane "
                                  "or flight_recorder disabled)"}
        from rnb_tpu_torch.metrics import TRIGGER_FORCED
        registry.request_dump(TRIGGER_FORCED, {"via": "operator"})
        return 200, {"armed": "flight",
                     "note": "dump serviced on the next flusher tick"}

    def action_capture(self) -> Tuple[int, Dict[str, object]]:
        plane = self.devobs_plane
        if plane is None:
            return 503, {"error": "no devobs plane (root 'devobs' key "
                                  "absent)"}
        plane.request_capture("operator")
        return 200, {"armed": "capture"}


def _make_handler(server: OperatorServer):
    """The BaseHTTPRequestHandler bound to one OperatorServer (the
    stdlib handler API is class-based; the closure carries the server
    reference without touching the socketserver plumbing)."""

    class Handler(BaseHTTPRequestHandler):
        # per-request threads (ThreadingHTTPServer): keep-alive off so
        # a dangling client can never pin a handler thread at
        # shutdown, and a socket timeout so the non-daemon handler
        # join in OperatorServer.stop() is bounded even against a
        # stalled peer
        protocol_version = "HTTP/1.0"
        timeout = 10.0

        def log_message(self, fmt, *args):  # noqa: N802 (stdlib API)
            pass  # operator traffic must not spam the bench stdout

        def _send(self, code: int, content_type: str,
                  body: str) -> None:
            data = body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _send_json(self, code: int, payload: Dict) -> None:
            self._send(code, "application/json",
                       json.dumps(payload, sort_keys=True) + "\n")

        def do_GET(self) -> None:  # noqa: N802 (stdlib API)
            parsed = urllib.parse.urlsplit(self.path)
            route = parsed.path.rstrip("/") or "/"
            try:
                self._route_get(route, parsed)
            except BrokenPipeError:
                return  # client went away mid-write: not our error
            except Exception as e:  # noqa: BLE001 - counted + shown
                server._count("errors")
                try:
                    self._send_json(500, {"error": "%s: %s"
                                          % (type(e).__name__, e)})
                except BrokenPipeError:
                    pass

        def _route_get(self, route: str, parsed) -> None:
            if route == "/healthz":
                self._send_json(200, server.healthz_payload())
            elif route == "/metrics":
                registry = server.metrics_registry
                if registry is None:
                    server._count("errors")
                    self._send(503, "text/plain",
                               "metrics plane disabled (no root "
                               "'metrics' key)\n")
                    return
                self._send(200, "text/plain; version=0.0.4",
                           registry.render_exposition())
            elif route in ("/statusz", "/"):
                self._send(200, "text/html", server.statusz_html())
            elif route == "/whatif":
                code, payload = server.whatif_payload(parsed.query)
                if code != 200:
                    server._count("errors")
                    self._send_json(code, payload)
                    return
                self._send_json(200, payload)
            elif route == "/stacks":
                self._send(200, "text/plain", _dump_all_stacks())
            else:
                server._count("errors")
                self._send_json(404, {"error": "unknown endpoint",
                                      "endpoints": list(ENDPOINTS)})
                return
            server._count("scrapes")

        def do_POST(self) -> None:  # noqa: N802 (stdlib API)
            route = urllib.parse.urlsplit(self.path).path.rstrip("/")
            if route not in ("/flight", "/capture"):
                server._count("errors")
                self._send_json(404, {"error": "unknown action",
                                      "actions": ["/flight",
                                                  "/capture"]})
                return
            if not server.settings.allow_actions:
                # the gating honesty policy: a denied action is a
                # COUNTED outcome (the Operator: line carries it), so
                # a misconfigured actuator is visible, not silent
                server._count("denied")
                self._send_json(403, {
                    "error": "actions disabled — set "
                             "operator.allow_actions true to permit "
                             "POST /flight and /capture"})
                return
            try:
                if route == "/flight":
                    code, payload = server.action_flight()
                else:
                    code, payload = server.action_capture()
            except BrokenPipeError:
                return
            if code == 200:
                server._count("actions")
            else:
                server._count("errors")
            self._send_json(code, payload)

    return Handler
