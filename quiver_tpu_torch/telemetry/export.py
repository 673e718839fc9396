"""Exposition formats + optional HTTP endpoint.

Kept OUT of the hot path on purpose: nothing under ``quiver_tpu_torch``
imports this module at import time, so the
stdlib ``http.server`` dependency only loads when someone actually
calls ``InferenceServer.expose_metrics()`` / ``start_http_server()``.

Three views:

  * ``to_prometheus_text(snapshot)`` — Prometheus exposition format
    (counters, gauges, and cumulative ``_bucket{le=...}`` histograms).
  * ``to_json(snapshot)`` — the snapshot itself, serialized.
  * ``start_http_server()`` — a daemon-threaded stdlib server exposing
    ``/metrics`` (text), ``/metrics.json``, ``/trace.json`` (Chrome
    trace events, Perfetto-loadable), plus the flight-recorder debug
    surface: ``/debug/requests`` (retained-request summaries),
    ``/debug/requests/<trace_id>`` (one full event log), ``/debug/slo``
    (watchdog objective status), ``/debug/breakers`` (per-lane
    circuit-breaker states), ``/debug/qos`` (tenant classes, token
    levels, degradation-ladder level + history), ``/debug/timeline``
    (the unified cross-subsystem Chrome trace — Perfetto-loadable),
    ``/debug/programs`` (top-K per-program time attribution, see
    ``telemetry.profile``: the port's kernel wrappers and serving
    forwards), ``/debug/mesh`` (the live mesh feature and sampler's
    shard stats, ``mesh.mesh_status()``), ``/debug/fleet`` (the router
    and membership view of the serving fleet, ``fleet.fleet_status()``);
    with a live fleet federation three more: ``/metrics/fleet`` (the
    federated exposition), ``/debug/fleet/summary`` (scrape health,
    fleet SLOs, clock offsets) and ``/debug/fleet/trace/<id>`` (one
    request reconstructed across processes).  ``/healthz`` answers with the
    ``health_fn=`` document, or else ``recovery.manager.health_status()``
    (the active ``RecoveryManager``'s readiness ladder; ``serving`` when
    there is none): 200 when it says ``ready``, else 503.  ``HEAD``
    answers every route with
    the headers its ``GET`` would carry.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .registry import parse_metric_key

__all__ = ["to_prometheus_text", "to_json", "MetricsServer",
           "start_http_server"]


def _escape_label_value(v) -> str:
    # Prometheus text format: label VALUES escape backslash, double
    # quote, and line feed (in that order — escaping the escapes first
    # keeps the round trip unambiguous).  Unescaped, a hostile tenant
    # name like `gold"} 1\n` splits the sample line and corrupts the
    # whole exposition.
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(merged[k])}"'
                     for k in sorted(merged))
    return "{" + inner + "}"


def _fmt_num(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_help(text: str) -> str:
    # Prometheus text format: backslash and newline are the only escapes
    # in HELP text.
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def to_prometheus_text(snapshot: dict) -> str:
    """Prometheus text exposition of a registry snapshot."""
    lines = []
    typed = set()
    help_texts = snapshot.get("help", {})

    def _type(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            text = help_texts.get(name)
            if text:
                lines.append(f"# HELP {name} {_escape_help(text)}")
            lines.append(f"# TYPE {name} {kind}")

    for key, v in sorted(snapshot.get("counters", {}).items()):
        name, labels = parse_metric_key(key)
        _type(name, "counter")
        lines.append(f"{name}{_fmt_labels(labels)} {_fmt_num(v)}")
    for key, v in sorted(snapshot.get("gauges", {}).items()):
        name, labels = parse_metric_key(key)
        _type(name, "gauge")
        lines.append(f"{name}{_fmt_labels(labels)} {_fmt_num(v)}")
    for key, d in sorted(snapshot.get("histograms", {}).items()):
        name, labels = parse_metric_key(key)
        _type(name, "histogram")
        cum = 0
        for bound, c in zip(d["bounds"], d["counts"]):
            cum += c
            lines.append(f"{name}_bucket"
                         f"{_fmt_labels(labels, {'le': _fmt_num(bound)})} "
                         f"{cum}")
        cum += d["counts"][-1]
        lines.append(
            f"{name}_bucket{_fmt_labels(labels, {'le': '+Inf'})} {cum}")
        lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt_num(d['sum'])}")
        lines.append(f"{name}_count{_fmt_labels(labels)} {cum}")
    return "\n".join(lines) + "\n"


def to_json(snapshot: dict, indent: Optional[int] = None) -> str:
    return json.dumps(snapshot, indent=indent, sort_keys=True)


class _ReuseAddrHTTPServer(ThreadingHTTPServer):
    # explicit SO_REUSEADDR: restarting an exporter (or a recovered
    # process re-binding its old port) must not fail on the previous
    # instance's sockets lingering in TIME_WAIT.  stdlib HTTPServer
    # happens to set this today; pin it so a restart-on-same-port is a
    # contract, not an implementation detail.
    allow_reuse_address = True


class MetricsServer:
    """Daemon-threaded stdlib HTTP server over a registry + tracer."""

    def __init__(self, registry=None, tracer=None, host: str = "127.0.0.1",
                 port: int = 0, health_fn=None):
        # ``port=0`` binds an ephemeral port (read back via ``.port``)
        # so N servers on one host never collide; ``health_fn`` backs
        # /healthz (the recovery manager's health_status without one).
        if registry is None or tracer is None:
            from . import get_registry, get_tracer
            registry = registry or get_registry()
            tracer = tracer or get_tracer()
        self.registry = registry
        self.tracer = tracer
        self.health_fn = health_fn
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def _payload(self):
                """Route ``self.path`` -> ``(body, ctype)`` or
                ``(body, ctype, status)``, or ``None`` for a 404.
                Shared by GET and HEAD so HEAD answers with the exact
                headers a GET would carry."""
                path = self.path
                if path.startswith("/healthz"):
                    if outer.health_fn is not None:
                        health = outer.health_fn()
                    else:
                        from ..recovery.manager import health_status

                        health = health_status()
                    # load balancers read the status code; humans read
                    # the body.  503 while booting/replaying/warming.
                    status = 200 if health.get("ready") else 503
                    return (json.dumps(health, indent=2),
                            "application/json", status)
                if path.startswith("/metrics/fleet"):
                    # matched BEFORE the /metrics prefix: the federated
                    # exposition (aggregates + per-replica series), 404
                    # when no federation is live in this process
                    from ..fleet.federation import get_federation

                    fed = get_federation()
                    if fed is None:
                        return None
                    return (fed.prometheus_text(),
                            "text/plain; version=0.0.4")
                if path.startswith("/metrics.json"):
                    return (to_json(outer.registry.snapshot(), indent=2),
                            "application/json")
                if path.startswith("/metrics"):
                    return (to_prometheus_text(outer.registry.snapshot()),
                            "text/plain; version=0.0.4")
                if path.startswith("/trace.json"):
                    return (json.dumps(outer.tracer.chrome_trace()),
                            "application/json")
                if path.startswith("/debug/requests"):
                    from .flightrec import get_recorder

                    rec = get_recorder()
                    from urllib.parse import unquote

                    parts = path.rstrip("/").split("/")
                    if len(parts) >= 4 and parts[3]:
                        # trace ids may arrive percent-encoded
                        record = rec.get(unquote(parts[3]))
                        if record is None:
                            return None
                        return json.dumps(record, indent=2), "application/json"
                    body = json.dumps({
                        "capacity": rec.capacity,
                        "slow_threshold_s": rec.slow_threshold_s,
                        "count": len(rec.records()),
                        "records": rec.summaries(),
                    }, indent=2)
                    return body, "application/json"
                if path.startswith("/debug/slo"):
                    from .slo import get_watchdog

                    return (json.dumps(get_watchdog().status(), indent=2),
                            "application/json")
                if path.startswith("/debug/breakers"):
                    from ..resilience.breaker import breakers_status

                    return (json.dumps(breakers_status(), indent=2),
                            "application/json")
                if path.startswith("/debug/qos"):
                    from ..resilience.qos import qos_status

                    return (json.dumps(qos_status(), indent=2),
                            "application/json")
                if path.startswith("/debug/timeline"):
                    from . import timeline

                    # the merged Chrome trace itself: save the body,
                    # load it in Perfetto
                    return (json.dumps(timeline.chrome_trace()),
                            "application/json")
                if path.startswith("/debug/fleet/summary"):
                    from ..fleet.federation import federation_status

                    return (json.dumps(federation_status(), indent=2),
                            "application/json")
                if path.startswith("/debug/fleet/trace/"):
                    from urllib.parse import unquote

                    from ..fleet.federation import get_federation

                    fed = get_federation()
                    trace_id = unquote(
                        path[len("/debug/fleet/trace/"):].rstrip("/"))
                    if fed is None or not trace_id:
                        return None
                    doc = fed.reconstruct(trace_id)
                    if not doc.get("found"):
                        return (json.dumps(doc, indent=2),
                                "application/json", 404)
                    return json.dumps(doc, indent=2), "application/json"
                if path.startswith("/debug/fleet"):
                    from ..fleet.router import fleet_status

                    return (json.dumps(fleet_status(), indent=2),
                            "application/json")
                if path.startswith("/debug/mesh"):
                    from ..mesh import mesh_status

                    return (json.dumps(mesh_status(), indent=2),
                            "application/json")
                if path.startswith("/debug/programs"):
                    from . import profile

                    return (json.dumps(profile.debug_payload(), indent=2),
                            "application/json")
                return None

            def _respond(self, send_body: bool) -> None:
                try:
                    payload = self._payload()
                except Exception as e:  # pragma: no cover - defensive
                    self.send_error(500, str(e))
                    return
                if payload is None:
                    self.send_error(404)
                    return
                if len(payload) == 3:
                    body, ctype, status = payload
                else:
                    body, ctype = payload
                    status = 200
                data = body.encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                if send_body:
                    self.wfile.write(data)

            def do_GET(self):  # noqa: N802 (stdlib API name)
                self._respond(send_body=True)

            def do_HEAD(self):  # noqa: N802 (stdlib API name)
                self._respond(send_body=False)

            def log_message(self, *a):  # silence per-request stderr spam
                pass

        self._httpd = _ReuseAddrHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="quiver-metrics-http",
                                        daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def close(self) -> None:
        # local import: resilience.shutdown itself imports telemetry
        from ..resilience.shutdown import join_and_reap

        self._httpd.shutdown()
        self._httpd.server_close()
        join_and_reap([self._thread], 5.0, component="telemetry.export")


def start_http_server(port: int = 0, host: str = "127.0.0.1",
                      registry=None, tracer=None) -> MetricsServer:
    """Start the metrics endpoint; ``port=0`` picks a free port (read it
    back from ``server.port``)."""
    return MetricsServer(registry=registry, tracer=tracer, host=host,
                         port=port)
