"""Fleet-wide observability plane: scrape, federate, align, reconstruct
(counterpart of ``quiver_tpu/fleet/federation.py``).

The fleet scales serving out to one leader + N replicas behind a router,
but every other observability surface is strictly per-process: a request
that crosses router → replica loses its trace identity at the TCP
boundary, and "what is the fleet's p99 right now" has no single
answer.  This module is the read side of the fleet — four pieces:

  * **metrics federation** — a membership-driven scraper polls each
    serving member's ``/metrics``, parses the Prometheus text back
    into per-replica series (:func:`parse_prometheus_text` — the
    *parsing* twin of ``export._escape_label_value``: hostile label
    values round-trip, malformed exposition ticks
    ``fleet_federation_parse_errors_total`` and never kills the
    sweep), and :func:`federate` merges them: counters summed,
    histograms merged bucket-wise (the fixed default bounds make the
    merge exact), gauges reported min/max/avg, every per-replica
    series re-exported under a ``replica`` label.  Served at
    ``GET /metrics/fleet`` + ``/debug/fleet/summary`` on the router's
    MetricsServer.
  * **fleet SLOs** — :class:`FleetSLOWatchdog` runs the SLO watchdog
    over the *federated* snapshot: fleet p99 / error ratio over the
    replicas' ``fleet_replica_request*`` series, plus max replica
    staleness and an eligible-replica floor.
  * **merged timelines** — each replica's ``/debug/timeline`` Chrome
    trace is pulled and re-based into one wall-clock timebase using
    per-replica perf_counter↔wall offsets estimated from the
    timestamp pairs replicas embed in their membership heartbeats
    (:func:`estimate_offsets` — median of ``wall - perf``, robust to
    a scheduling stall corrupting one pair).  One process track per
    replica plus the router; exported via ``timeline.export_fleet``
    (a provider hook, so telemetry never imports fleet).
  * **request reconstruction** — :meth:`FleetFederation.reconstruct`
    joins the router's hop record for a trace_id with the owning
    replica's flight record(s) (``GET /debug/fleet/trace/<id>``), so
    one id tells the whole cross-process story, redispatches included.

Everything here is OFF the request path: the router pays one cached
config check when ``config.fleet_federation`` is off (no thread, no
new metric keys), and the scraper is a read-only consumer of endpoints
the fleet already serves.

Lock discipline: scrape state is written by the scraper thread and read
from HTTP handler threads; all access holds ``_lock``.  urllib (the HTTP
*client*) is imported at call time like the router's health poller;
http.server never loads here.
"""

from __future__ import annotations

import json
import logging
import math
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple
from weakref import ref as weakref

from .. import telemetry
from ..telemetry.registry import metric_key, parse_metric_key
from ..telemetry.slo import SLOWatchdog, _merged_histogram, _sum_counters
from .membership import MembershipDirectory

__all__ = [
    "parse_prometheus_text", "federate", "render_fleet_text",
    "estimate_offsets", "FleetFederation", "FleetSLOWatchdog",
    "get_federation", "federation_status",
]

log = logging.getLogger("quiver_tpu_torch.fleet")

# series are keyed (name, ((label, value), ...)) — label values keep
# their raw bytes (commas, quotes, newlines) instead of being folded
# into the registry's flat `name{k=v}` strings, which forbid them
_SeriesKey = Tuple[str, Tuple[Tuple[str, str], ...]]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_UNESCAPE = {"\\": "\\", '"': '"', "n": "\n"}
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")
_MAX_CLOCK_PAIRS = 32  # heartbeat timestamp pairs retained per replica


# -- Prometheus text parsing -------------------------------------------
def _parse_labels(body: str) -> Optional[Dict[str, str]]:
    """The ``k="v",...`` interior of a label set; None when malformed.
    Inverse of ``export._escape_label_value``: ``\\\\``, ``\\"`` and
    ``\\n`` unescape, anything else after a backslash is corrupt."""
    labels: Dict[str, str] = {}
    i, n = 0, len(body)
    while i < n:
        eq = body.find("=", i)
        if eq < 0:
            return None
        key = body[i:eq].strip()
        if not _NAME_RE.match(key) or eq + 1 >= n or body[eq + 1] != '"':
            return None
        j = eq + 2
        out: List[str] = []
        closed = False
        while j < n:
            c = body[j]
            if c == "\\":
                rep = _UNESCAPE.get(body[j + 1]) if j + 1 < n else None
                if rep is None:
                    return None
                out.append(rep)
                j += 2
                continue
            if c == '"':
                closed = True
                break
            out.append(c)
            j += 1
        if not closed:
            return None
        labels[key] = "".join(out)
        i = j + 1
        if i < n:
            if body[i] != ",":
                return None
            i += 1
    return labels


def _parse_sample(line: str) -> Optional[Tuple[str, Dict[str, str], float]]:
    """One sample line → ``(name, labels, value)``; None when corrupt."""
    if "{" in line:
        brace = line.index("{")
        name = line[:brace].strip()
        # find the matching close brace quote-aware: label values may
        # contain '}' legitimately
        j, in_q = brace + 1, False
        while j < len(line):
            c = line[j]
            if in_q:
                if c == "\\":
                    j += 2
                    continue
                if c == '"':
                    in_q = False
            elif c == '"':
                in_q = True
            elif c == "}":
                break
            j += 1
        if j >= len(line):
            return None
        labels = _parse_labels(line[brace + 1:j])
        if labels is None:
            return None
        rest = line[j + 1:].split()
    else:
        parts = line.split()
        if len(parts) < 2:
            return None
        name, rest, labels = parts[0], parts[1:], {}
    if not _NAME_RE.match(name) or not rest:
        return None
    try:
        value = float(rest[0])  # optional trailing timestamp is ignored
    except ValueError:
        return None
    return name, labels, value


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _hist_family(name: str, types: Dict[str, str]) \
        -> Tuple[Optional[str], Optional[str]]:
    for suffix in _HIST_SUFFIXES:
        if name.endswith(suffix):
            base = name[:-len(suffix)]
            if types.get(base) == "histogram":
                return base, suffix[1:]
    return None, None


def _assemble_histogram(parts: dict) -> Optional[dict]:
    """Cumulative ``_bucket{le=...}`` samples → a registry-shaped
    ``{"bounds", "counts", "sum"}`` dict; None when the exposition is
    internally inconsistent (non-monotone cumulative counts, missing
    ``+Inf`` bucket or ``_sum``)."""
    finite = sorted((b, v) for b, v in parts["buckets"]
                    if not math.isinf(b))
    inf = [v for b, v in parts["buckets"] if math.isinf(b)]
    if len(inf) != 1 or parts["sum"] is None:
        return None
    total = inf[0]
    bounds, counts, prev = [], [], 0.0
    for b, cum in finite:
        if cum < prev - 1e-9:
            return None
        bounds.append(b)
        counts.append(int(round(cum - prev)))
        prev = cum
    overflow = total - prev
    if overflow < -1e-9:
        return None
    counts.append(int(round(max(overflow, 0.0))))
    if parts["count"] is not None and abs(parts["count"] - total) > 1e-6:
        return None
    return {"bounds": bounds, "counts": counts,
            "sum": float(parts["sum"]), "min": None, "max": None}


def parse_prometheus_text(text: str) -> Tuple[dict, int]:
    """Prometheus text exposition → ``({"counters", "gauges",
    "histograms"}, n_errors)`` keyed by ``(name, label_tuple)``.

    Every malformed line / inconsistent histogram counts one error and
    is skipped — a hostile or truncated scrape degrades coverage, it
    never raises out of the sweep.  Untyped samples classify by the
    unit suffix (``_total`` → counter, else gauge).
    """
    types: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    errors = 0
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3].strip()
            continue
        parsed = _parse_sample(line)
        if parsed is None:
            errors += 1
            continue
        samples.append(parsed)

    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    hist_parts: Dict[_SeriesKey, dict] = {}
    for name, labels, value in samples:
        family, part = _hist_family(name, types)
        if family is not None:
            base = {k: v for k, v in labels.items() if k != "le"}
            d = hist_parts.setdefault(
                (family, _label_key(base)),
                {"buckets": [], "sum": None, "count": None})
            if part == "bucket":
                le = labels.get("le")
                try:
                    d["buckets"].append((float(le), value))
                except (TypeError, ValueError):
                    errors += 1
            elif part == "sum":
                d["sum"] = value
            else:
                d["count"] = value
            continue
        kind = types.get(name)
        if kind is None:
            kind = "counter" if name.endswith("_total") else "gauge"
        key = (name, _label_key(labels))
        if kind == "counter":
            out["counters"][key] = value
        else:
            out["gauges"][key] = value
    for key, parts in hist_parts.items():
        h = _assemble_histogram(parts)
        if h is None:
            errors += 1
            continue
        out["histograms"][key] = h
    return out, errors


# -- federation (pure) -------------------------------------------------
def _tag_replica(key: _SeriesKey, rid: str) -> _SeriesKey:
    name, labels = key
    merged = dict(labels)
    # a series that is already replica-scoped at the source (shipping's
    # staleness gauges) keeps its own attribution
    merged.setdefault("replica", rid)
    return name, _label_key(merged)


def federate(scrapes: Dict[str, dict]) -> dict:
    """Merge per-replica parsed scrapes into the fleet view: counters
    summed, histograms merged bucket-wise (bounds must match — a
    mismatch drops that family from the aggregate and counts a merge
    error), gauges min/max/avg; every source series re-keyed with a
    ``replica`` label under ``per_replica``."""
    view: dict = {
        "replicas": sorted(scrapes),
        "counters": {}, "gauges": {}, "histograms": {},
        "per_replica": {"counters": {}, "gauges": {}, "histograms": {}},
        "merge_errors": 0,
    }
    gauge_vals: Dict[_SeriesKey, List[float]] = {}
    for rid in sorted(scrapes):
        snap = scrapes[rid]
        for key, v in snap.get("counters", {}).items():
            view["per_replica"]["counters"][_tag_replica(key, rid)] = v
            view["counters"][key] = view["counters"].get(key, 0.0) + v
        for key, v in snap.get("gauges", {}).items():
            view["per_replica"]["gauges"][_tag_replica(key, rid)] = v
            gauge_vals.setdefault(key, []).append(v)
        for key, h in snap.get("histograms", {}).items():
            view["per_replica"]["histograms"][_tag_replica(key, rid)] = h
            agg = view["histograms"].get(key)
            if agg is None:
                view["histograms"][key] = {
                    "bounds": list(h["bounds"]), "counts": list(h["counts"]),
                    "sum": h["sum"], "min": None, "max": None}
            elif agg["bounds"] == list(h["bounds"]):
                agg["counts"] = [a + b for a, b
                                 in zip(agg["counts"], h["counts"])]
                agg["sum"] += h["sum"]
            else:
                view["histograms"].pop(key, None)
                view["merge_errors"] += 1
    view["gauges"] = {
        key: {"min": min(vs), "max": max(vs), "avg": sum(vs) / len(vs)}
        for key, vs in gauge_vals.items()}
    return view


def render_fleet_text(view: dict) -> str:
    """The ``/metrics/fleet`` exposition: aggregate series first, then
    the per-replica series under the same ``# TYPE``.  Gauges aggregate
    as three ``agg="min|max|avg"`` series (summing gauges is a lie)."""
    from ..telemetry.export import _fmt_labels, _fmt_num

    lines: List[str] = []
    typed = set()

    def _type(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    def _hist_lines(name: str, labels: dict, d: dict) -> None:
        cum = 0
        for bound, c in zip(d["bounds"], d["counts"]):
            cum += c
            lines.append(f"{name}_bucket"
                         f"{_fmt_labels(labels, {'le': _fmt_num(bound)})} "
                         f"{cum}")
        cum += d["counts"][-1]
        lines.append(
            f"{name}_bucket{_fmt_labels(labels, {'le': '+Inf'})} {cum}")
        lines.append(f"{name}_sum{_fmt_labels(labels)} "
                     f"{_fmt_num(d['sum'])}")
        lines.append(f"{name}_count{_fmt_labels(labels)} {cum}")

    for (name, labels), v in sorted(view["counters"].items()):
        _type(name, "counter")
        lines.append(f"{name}{_fmt_labels(dict(labels))} {_fmt_num(v)}")
    for (name, labels), v in sorted(view["per_replica"]["counters"].items()):
        _type(name, "counter")
        lines.append(f"{name}{_fmt_labels(dict(labels))} {_fmt_num(v)}")
    for (name, labels), agg in sorted(view["gauges"].items()):
        _type(name, "gauge")
        for k in ("min", "max", "avg"):
            lines.append(f"{name}{_fmt_labels(dict(labels), {'agg': k})} "
                         f"{_fmt_num(agg[k])}")
    for (name, labels), v in sorted(view["per_replica"]["gauges"].items()):
        _type(name, "gauge")
        lines.append(f"{name}{_fmt_labels(dict(labels))} {_fmt_num(v)}")
    for (name, labels), d in sorted(view["histograms"].items()):
        _type(name, "histogram")
        _hist_lines(name, dict(labels), d)
    for (name, labels), d in sorted(
            view["per_replica"]["histograms"].items()):
        _type(name, "histogram")
        _hist_lines(name, dict(labels), d)
    return "\n".join(lines) + "\n"


# -- clock alignment ---------------------------------------------------
def estimate_offsets(samples: Dict[str, Sequence[Tuple[float, float]]]) \
        -> Dict[str, float]:
    """Per-process perf_counter→wall offset from ``(perf, wall)``
    timestamp pairs: the median of ``wall - perf`` per process.  Both
    stamps are taken back-to-back at heartbeat time, so each pair's
    difference is the process's perf epoch plus a sub-millisecond
    sampling error; the median rejects pairs a scheduling stall tore
    apart.  Adding the offset to a perf_counter timestamp lands it on
    that process's wall clock — the shared timebase the merged
    timeline uses."""
    out: Dict[str, float] = {}
    for rid, pairs in samples.items():
        deltas = sorted(w - p for p, w in pairs)
        if not deltas:
            continue
        m = len(deltas) // 2
        out[rid] = (deltas[m] if len(deltas) % 2
                    else (deltas[m - 1] + deltas[m]) / 2.0)
    return out


def _flat_key(name: str, labels: Tuple[Tuple[str, str], ...]) \
        -> Optional[str]:
    # the registry's flat keys forbid `,={}"\n` in label values; a
    # hostile series stays in the tuple-keyed view and is simply not
    # visible to the flat-snapshot consumers (the SLO watchdog)
    try:
        return metric_key(name, dict(labels))
    except (TypeError, ValueError):
        return None


# -- fleet SLOs --------------------------------------------------------
class _FederatedRegistry:
    """Adapter handing the base watchdog a federated ``snapshot()``."""

    __slots__ = ("_fed_ref",)

    def __init__(self, fed: "FleetFederation"):
        self._fed_ref = weakref(fed)

    def snapshot(self) -> dict:
        fed = self._fed_ref()
        return fed.fleet_snapshot() if fed is not None else {}


class FleetSLOWatchdog(SLOWatchdog):
    """The SLO watchdog over the federated snapshot: fleet p99 and
    error ratio come from the replicas' ``fleet_replica_request*``
    series, plus two fleet-only objectives — max replica staleness
    (``config.fleet_max_staleness_lsn``) and an eligible-replica floor
    (``config.fleet_min_eligible``)."""

    def __init__(self, federation: "FleetFederation",
                 interval_s: Optional[float] = None):
        from ..config import get_config

        cfg = get_config()
        super().__init__(registry=_FederatedRegistry(federation),
                         interval_s=(interval_s if interval_s is not None
                                     else federation.interval_s))
        self.max_staleness_lsn = float(cfg.fleet_max_staleness_lsn)
        self.min_eligible = float(cfg.fleet_min_eligible)

    def _score(self, window: dict) -> List[dict]:
        # gauges pass through snapshot_delta untouched, so the window
        # carries current staleness / eligibility readings alongside
        # the windowed counter and histogram deltas
        return [self._eval_fleet_p99(window),
                self._eval_fleet_errors(window),
                self._eval_staleness(window),
                self._eval_eligible(window)]

    def _eval_fleet_p99(self, window: dict) -> dict:
        h = _merged_histogram(window, "fleet_replica_request_seconds")
        n = h.count if h is not None else 0
        p99_ms = h.percentile(99) * 1e3 if n else 0.0
        return {
            "objective": "fleet_p99_latency",
            "target": self.p99_ms, "unit": "ms",
            "value": round(p99_ms, 3), "samples": int(n),
            "burn": round(p99_ms / self.p99_ms, 4) if self.p99_ms else 0.0,
            "breaching": bool(n and p99_ms > self.p99_ms),
        }

    def _eval_fleet_errors(self, window: dict) -> dict:
        err = _sum_counters(window, "fleet_replica_requests_total",
                            {"status": "error"})
        total = _sum_counters(window, "fleet_replica_requests_total")
        ratio = err / total if total else 0.0
        return {
            "objective": "fleet_error_ratio",
            "target": self.error_ratio, "unit": "ratio",
            "value": round(ratio, 6), "samples": int(total),
            "burn": (round(ratio / self.error_ratio, 4)
                     if self.error_ratio else 0.0),
            "breaching": bool(total and ratio > self.error_ratio),
        }

    def _eval_staleness(self, window: dict) -> dict:
        worst, worst_rid, n = 0.0, None, 0
        for key, v in window.get("gauges", {}).items():
            name, labels = parse_metric_key(key)
            if name != "fleet_replica_staleness_lsn":
                continue
            n += 1
            if v > worst:
                worst, worst_rid = v, labels.get("replica")
        target = self.max_staleness_lsn
        out = {
            "objective": "fleet_staleness",
            "target": target, "unit": "lsn",
            "value": worst, "samples": n,
            "burn": round(worst / target, 4) if target else 0.0,
            "breaching": bool(n and target and worst > target),
        }
        if worst_rid is not None:
            out["replica"] = worst_rid
        return out

    def _eval_eligible(self, window: dict) -> dict:
        v = window.get("gauges", {}).get("fleet_router_eligible_total")
        known = v is not None
        value = float(v) if known else 0.0
        floor = self.min_eligible
        return {
            "objective": "fleet_eligible",
            "target": floor, "unit": "replicas",
            "value": value, "samples": int(known),
            # floor objective: burn > 1 means fewer routable replicas
            # than provisioned
            "burn": (round(floor / value, 4) if value
                     else (float(known and floor > 0))),
            "breaching": bool(known and value < floor),
        }


# -- the federation ----------------------------------------------------
class FleetFederation:
    """Membership-driven scraper + merged views over the fleet.

    Construct it next to the router (``FleetRouter`` with federation on
    does this itself), then either :meth:`start` the background sweep
    or call :meth:`scrape_once` deterministically (tests, bench).  All
    read views — ``/metrics/fleet``, ``/debug/fleet/summary``,
    ``/debug/fleet/trace/<id>``, ``timeline.export_fleet`` — serve from
    the last completed sweep.
    """

    _guarded_by = {"_scrapes": "_lock", "_meta": "_lock",
                   "_pairs": "_lock", "_view": "_lock"}

    def __init__(self, directory: MembershipDirectory, router=None,
                 interval_s: Optional[float] = None,
                 timeout_s: Optional[float] = None,
                 watchdog: bool = True):
        from ..config import get_config
        from ..telemetry import timeline

        cfg = get_config()
        self.directory = directory
        self._router_ref = weakref(router) if router is not None else None
        self.interval_s = float(interval_s if interval_s is not None
                                else cfg.fleet_scrape_interval_s)
        self.timeout_s = float(timeout_s if timeout_s is not None
                               else cfg.fleet_request_timeout_s)
        self._lock = threading.Lock()
        self._scrapes: Dict[str, dict] = {}
        self._meta: Dict[str, dict] = {}
        self._pairs: Dict[str, List[Tuple[float, float]]] = {}
        self._view: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.watchdog = FleetSLOWatchdog(self) if watchdog else None
        _set_active(self)

        def _provider(ref=weakref(self)):
            fed = ref()
            return fed.fleet_chrome_trace() if fed is not None else None

        timeline.set_fleet_trace_provider(_provider)

    # -- scraping ------------------------------------------------------
    def targets(self) -> List[Tuple[str, str, int]]:
        """Scrapeable members: fresh + serving + a published metrics
        port.  Membership drives the sweep — joins and leaves change
        the target set on the next tick, no registration step."""
        out = []
        for r in self.directory.replicas(fresh_only=True):
            mport = int(r.detail.get("metrics_port", 0) or 0)
            if r.state == "serving" and mport > 0:
                out.append((r.replica_id, r.host, mport))
        return out

    def _harvest_clock_pairs(self) -> None:
        for r in self.directory.replicas(fresh_only=True):
            perf, wall = (r.detail.get("clock_perf"),
                          r.detail.get("clock_wall"))
            if perf is None or wall is None:
                continue
            pair = (float(perf), float(wall))
            with self._lock:
                pairs = self._pairs.setdefault(r.replica_id, [])
                if pairs and pairs[-1] == pair:
                    continue  # heartbeat not re-stamped since last sweep
                pairs.append(pair)
                if len(pairs) > _MAX_CLOCK_PAIRS:
                    del pairs[0]

    def _fetch(self, rid: str, url: str, count_errors: bool = True) \
            -> Optional[bytes]:
        # http.server stays out of library modules; the CLIENT
        # side (urllib) is fine — same stance as the router's poller
        import urllib.request

        try:
            with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
                return r.read()
        except (OSError, ValueError) as e:
            if count_errors:
                telemetry.counter("fleet_federation_scrape_errors_total",
                                  replica=rid).inc()
            log.debug("federation fetch %s failed: %s", url, e)
            return None

    def _fetch_json(self, rid: str, host: str, mport: int, path: str,
                    count_errors: bool = True) -> Optional[dict]:
        body = self._fetch(rid, f"http://{host}:{mport}{path}",
                           count_errors=count_errors)
        if body is None:
            return None
        try:
            return json.loads(body)
        except ValueError:
            if count_errors:
                telemetry.counter("fleet_federation_parse_errors_total").inc()
            return None

    def scrape_once(self) -> int:
        """One federation sweep: harvest heartbeat clock pairs, pull
        every target's ``/metrics``, re-parse, re-federate.  Returns
        the number of members scraped successfully; every failure mode
        ticks its counter and leaves the previous view standing."""
        self._harvest_clock_pairs()
        ok = 0
        for rid, host, mport in self.targets():
            body = self._fetch(rid, f"http://{host}:{mport}/metrics")
            if body is None:
                with self._lock:
                    self._meta[rid] = {"ok": False, "error": "unreachable"}
                continue
            parsed, errors = parse_prometheus_text(
                body.decode("utf-8", "replace"))
            if errors:
                telemetry.counter(
                    "fleet_federation_parse_errors_total").inc(errors)
            telemetry.counter("fleet_federation_scrapes_total",
                              replica=rid).inc()
            ok += 1
            with self._lock:
                self._scrapes[rid] = parsed
                self._meta[rid] = {
                    "ok": True, "parse_errors": errors,
                    "series": (len(parsed["counters"])
                               + len(parsed["gauges"])
                               + len(parsed["histograms"])),
                }
        with self._lock:
            scrapes = dict(self._scrapes)
        view = federate(scrapes)
        if view["merge_errors"]:
            telemetry.counter("fleet_federation_merge_errors_total").inc(
                view["merge_errors"])
        with self._lock:
            self._view = view
        return ok

    # -- merged views --------------------------------------------------
    def fleet_view(self) -> dict:
        with self._lock:
            view = self._view
        if view is None:
            self.scrape_once()
            with self._lock:
                view = self._view
        return view

    def fleet_snapshot(self) -> dict:
        """Registry-shaped flat snapshot of the federation (aggregate
        counters/histograms + per-replica gauges), with the router
        process's own gauges folded in — the :class:`FleetSLOWatchdog`
        input.  Series whose label values the flat keys cannot encode
        are skipped (they remain visible in :meth:`fleet_view`)."""
        view = self.fleet_view()
        snap: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for (name, labels), v in view["counters"].items():
            key = _flat_key(name, labels)
            if key is not None:
                snap["counters"][key] = v
        for (name, labels), h in view["histograms"].items():
            key = _flat_key(name, labels)
            if key is not None:
                snap["histograms"][key] = dict(h)
        for (name, labels), v in view["per_replica"]["gauges"].items():
            key = _flat_key(name, labels)
            if key is not None:
                snap["gauges"][key] = v
        # the eligible-replica gauge lives in the router process, not
        # on any replica: fold local gauges in (replica series win)
        for key, v in telemetry.snapshot().get("gauges", {}).items():
            snap["gauges"].setdefault(key, v)
        return snap

    def prometheus_text(self) -> str:
        """The ``GET /metrics/fleet`` body."""
        return render_fleet_text(self.fleet_view())

    def offsets(self) -> Dict[str, float]:
        """Per-replica perf_counter→wall offsets from harvested
        heartbeat clock pairs."""
        with self._lock:
            pairs = {rid: list(ps) for rid, ps in self._pairs.items()}
        return estimate_offsets(pairs)

    def summary(self) -> dict:
        """The ``GET /debug/fleet/summary`` document."""
        view = self.fleet_view()
        with self._lock:
            meta = {rid: dict(m) for rid, m in self._meta.items()}
            running = (self._thread is not None
                       and self._thread.is_alive())
        router = self._router_ref() if self._router_ref is not None \
            else None
        out = {
            "active": True,
            "interval_s": self.interval_s,
            "running": running,
            "replicas": meta,
            "series": {
                "counters": len(view["counters"]),
                "gauges": len(view["gauges"]),
                "histograms": len(view["histograms"]),
            },
            "merge_errors": view["merge_errors"],
            "offsets_s": {rid: round(off, 6)
                          for rid, off in sorted(self.offsets().items())},
        }
        if router is not None:
            out["router"] = {"origin": router.origin,
                             "hop_records": router.hop_count()}
        if self.watchdog is not None:
            out["slo"] = self.watchdog.status()
        return out

    # -- merged timeline -----------------------------------------------
    def fleet_chrome_trace(self) -> dict:
        """One Perfetto-loadable Chrome trace for the whole fleet: the
        router's own timeline plus every reachable replica's
        ``/debug/timeline``, each re-based from its process-local
        perf_counter epoch onto the wall clock via the heartbeat
        offsets, one process track each."""
        from ..telemetry import timeline

        offsets = self.offsets()
        local_pair = (time.perf_counter(), time.time())
        procs: List[Tuple[str, dict, float]] = [
            ("router", timeline.chrome_trace(),
             local_pair[1] - local_pair[0])]
        skipped: List[str] = []
        for rid, host, mport in self.targets():
            off = offsets.get(rid)
            doc = self._fetch_json(rid, host, mport, "/debug/timeline")
            if off is None or doc is None:
                skipped.append(rid)
                continue
            procs.append((rid, doc, off))
        merged: List[dict] = []
        for idx, (pname, doc, off) in enumerate(procs):
            track = "router" if pname == "router" else f"replica {pname}"
            merged.append({"name": "process_name", "ph": "M", "pid": idx,
                           "tid": 0, "args": {"name": track}})
            for e in doc.get("traceEvents", ()):
                if not isinstance(e, dict):
                    continue
                ev = dict(e)
                ev["pid"] = idx
                if ev.get("ph") == "M":
                    if ev.get("name") == "process_name":
                        continue  # replaced by the per-replica track
                    merged.append(ev)
                    continue
                try:
                    ev["ts"] = float(ev["ts"]) + off * 1e6
                except (KeyError, TypeError, ValueError):
                    continue
                merged.append(ev)
        out = {
            "traceEvents": merged,
            "displayTimeUnit": "ms",
            "otherData": {
                "processes": [p for p, _, _ in procs],
                "offsets_s": {p: round(o, 6) for p, _, o in procs},
            },
        }
        if skipped:
            out["otherData"]["skipped"] = skipped
        return out

    # -- request reconstruction ----------------------------------------
    def reconstruct(self, trace_id: str) -> dict:
        """The ``GET /debug/fleet/trace/<id>`` document: the router's
        hop record joined with the flight record of every replica the
        request was dispatched to.  A replica that died (that is how
        redispatches happen) reports unreachable rather than vanishing
        from the story."""
        from urllib.parse import quote

        router = self._router_ref() if self._router_ref is not None \
            else None
        hop = router.hop_record(trace_id) if router is not None else None
        out: dict = {"trace_id": trace_id, "router": hop, "replicas": {}}
        targets = {rid: (host, mport)
                   for rid, host, mport in self.targets()}
        rids = ([a["replica"] for a in hop.get("attempts", ())]
                if hop else sorted(targets))
        for rid in dict.fromkeys(rids):  # de-dup, order preserved
            loc = targets.get(rid)
            if loc is None:
                out["replicas"][rid] = {"error": "unreachable",
                                        "reason": "not in the fleet"}
                continue
            doc = self._fetch_json(rid, loc[0], loc[1],
                                   "/debug/requests/"
                                   + quote(trace_id, safe=""),
                                   count_errors=False)
            out["replicas"][rid] = (doc if doc is not None
                                    else {"error": "no record"})
        out["found"] = bool(hop) or any(
            "error" not in d for d in out["replicas"].values())
        return out

    # -- lifecycle -----------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
                if self.watchdog is not None:
                    self.watchdog.evaluate_once()
            except Exception as e:
                # the sweep must outlive flaky replicas; the previous
                # view stays standing and the next tick retries
                log.warning("federation sweep failed: %s", e)

    def start(self) -> "FleetFederation":
        """Start (idempotently) the background sweep thread."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="quiver-fleet-federation")
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        from ..resilience.shutdown import join_and_reap

        self._stop.set()
        t = self._thread
        if t is not None:
            join_and_reap([t], max(self.interval_s * 2, timeout),
                          component="fleet.federation")
            self._thread = None
        if self.watchdog is not None:
            self.watchdog.stop()
        _clear_active(self)


# -- /metrics/fleet plumbing (weakref, same pattern as fleet.router) ----
_ACTIVE_LOCK = threading.Lock()
_ACTIVE = None


def _set_active(fed: FleetFederation) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = weakref(fed)


def _clear_active(fed: FleetFederation) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None and _ACTIVE() is fed:
            _ACTIVE = None


def get_federation() -> Optional[FleetFederation]:
    """The most recently constructed federation in this process (what
    the MetricsServer's fleet routes serve), or None."""
    with _ACTIVE_LOCK:
        return _ACTIVE() if _ACTIVE is not None else None


def federation_status() -> dict:
    """The ``/debug/fleet/summary`` document; ``{"active": False}``
    when no federation is live."""
    fed = get_federation()
    if fed is None:
        return {"active": False}
    return fed.summary()
