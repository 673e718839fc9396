"""QT006 — metric-name hygiene at telemetry factory call sites.

The registry addresses metrics by flat ``name{k=v,...}`` strings and the
Prometheus exposition inherits them verbatim, so naming mistakes are
forever: a dynamic name (f-string with a batch size in it) explodes
cardinality, a missing unit suffix makes dashboards guess whether
``feature_gather`` is seconds or bytes, and a computed label key defeats
the catalogue in docs/OBSERVABILITY.md.  This rule pins the contract at
every ``telemetry.counter/gauge/histogram`` call:

  * the metric name is a **literal** ``snake_case`` string (never an
    f-string, concatenation, or variable);
  * the name carries a unit suffix: ``_total`` (counts), ``_seconds``
    (durations), ``_bytes`` (sizes), ``_state`` (enum gauges),
    ``_level`` (ordinal gauges — the QoS degradation ladder),
    ``_lsn`` (log-sequence-number watermarks — WAL shipping lag),
    ``_rows`` (row-count gauges — mesh frontier ownership),
    ``_members`` (membership-count gauges — fleet shard groups),
    ``_replicas`` (replica-count gauges — autoscaler targets),
    ``_rps`` (request-rate gauges — autoscaler predictions), or
    ``_epoch`` (election-epoch ordinals — leader fencing);
  * label keys are literal keyword arguments — ``**labels`` expansion
    hides the key set from static inspection and is flagged.

Matched call sites: dotted calls through a ``telemetry`` module object
(``telemetry.counter(...)``) and bare calls to factories imported from a
telemetry module (``from . import counter`` inside the package).
Registry-internal plumbing (``self.counter(name, **labels)`` in
``merge``) is deliberately NOT matched — it forwards names that were
already validated at their facade call site.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Set

from ..core import Finding, ModuleContext, Rule, dotted_call_name

_FACTORIES = {"counter", "gauge", "histogram"}
_UNIT_SUFFIXES = ("_total", "_seconds", "_bytes", "_state", "_level",
                  "_lsn", "_rows", "_members", "_replicas", "_rps",
                  "_epoch")
_SNAKE = re.compile(r"^[a-z][a-z0-9_]*$")
# factory kwargs that are API options, not metric labels
_OPTION_KWARGS = {"bounds", "help"}


class MetricNameRule(Rule):
    code = "QT006"
    name = "metric-name-hygiene"
    description = ("telemetry metric names must be literal snake_case "
                   "with a _total/_seconds/_bytes unit suffix and "
                   "literal label keys")

    def _bare_aliases(self, ctx: ModuleContext) -> Set[str]:
        """Names bound by ``from <...telemetry> import counter/...`` —
        including relative imports inside the telemetry package itself."""
        parts = ctx.relpath.replace("\\", "/").split("/")
        in_telemetry_pkg = "telemetry" in parts
        out: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ImportFrom):
                continue
            mod = node.module or ""
            from_telemetry = (
                mod.split(".")[-1] == "telemetry"
                or (node.level > 0 and not mod and in_telemetry_pkg)
            )
            if not from_telemetry:
                continue
            for alias in node.names:
                if alias.name in _FACTORIES:
                    out.add(alias.asname or alias.name)
        return out

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        bare = self._bare_aliases(ctx)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = dotted_call_name(node.func)
            if dotted is None:
                continue
            parts = dotted.split(".")
            if len(parts) >= 2:
                if parts[-1] not in _FACTORIES or parts[-2] != "telemetry":
                    continue
            elif parts[0] not in bare:
                continue
            factory = parts[-1]
            yield from self._check_call(ctx, node, factory)

    def _check_call(self, ctx: ModuleContext, node: ast.Call,
                    factory: str) -> Iterator[Finding]:
        if not node.args:
            return  # keyword-only name is not an idiom here; nothing to pin
        name_arg = node.args[0]
        if isinstance(name_arg, ast.JoinedStr):
            yield ctx.finding(
                self.code, name_arg,
                f"metric name passed to `{factory}` is an f-string: "
                "dynamic names explode label-free cardinality; use a "
                "literal name and put the variable part in a label")
            return
        if not (isinstance(name_arg, ast.Constant)
                and isinstance(name_arg.value, str)):
            yield ctx.finding(
                self.code, name_arg,
                f"metric name passed to `{factory}` is not a literal "
                "string: names must be statically auditable (the metric "
                "catalogue in docs/OBSERVABILITY.md is built from them)")
            return
        name = name_arg.value
        if not _SNAKE.match(name):
            yield ctx.finding(
                self.code, name_arg,
                f"metric name {name!r} is not snake_case "
                "([a-z][a-z0-9_]*)")
        elif not name.endswith(_UNIT_SUFFIXES):
            yield ctx.finding(
                self.code, name_arg,
                f"metric name {name!r} lacks a unit suffix: counts end "
                "in _total, durations in _seconds, sizes in _bytes, "
                "enum gauges in _state, ordinal gauges in _level")
        for kw in node.keywords:
            if kw.arg is None:
                yield ctx.finding(
                    self.code, kw.value,
                    f"`**` label expansion on `{factory}({name!r}, ...)`: "
                    "label keys must be literal keyword arguments so the "
                    "key set is statically auditable")
            elif kw.arg not in _OPTION_KWARGS and not _SNAKE.match(kw.arg):
                yield ctx.finding(
                    self.code, kw.value,
                    f"label key {kw.arg!r} on `{factory}({name!r}, ...)` "
                    "is not snake_case")
