"""QT007 — pipeline threads must not swallow exceptions silently.

The serving and prefetch pipelines are built from daemon threads
(``_worker`` / ``_loop`` / ``worker`` drain functions) whose broad
``except Exception`` blocks are load-bearing: they are what keeps one
malformed payload from killing a stream for every later request.  The
flip side is that a broad handler which merely ``pass``es turns a crash
into a silent wedge — the thread survives but the failure reaches no
metric, no flight record, and no caller.  Telemetry can only
observe what the handler bothers to report.

This rule pins that contract.  In **hot modules**, a broad except
handler (bare ``except:``, ``except Exception``, ``except
BaseException``) lexically inside a thread-loop-named function
(``*_loop``, ``*_worker``, ``run``, …) must do at least one of:

  * **re-raise** — any ``raise`` in the handler body;
  * **record** — call into ``telemetry`` / ``flightrec`` / ``logging``
    / ``warnings`` (or a ``logger.error(...)``-style method);
  * **forward** — pass the bound exception object to *some* call
    (``self._reject(item, e)``, ``results.put((e, "error"))``,
    ``exc.append(e)``): the object goes somewhere a consumer can
    surface it.

Narrow handlers (``except queue.Empty``) are control flow, not error
swallowing, and are never flagged.  Functions outside the thread-loop
naming convention are left to ordinary review — the rule targets the
long-lived drain loops where a swallowed exception has no caller left
to notice.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from ..core import Finding, ModuleContext, Rule, dotted_call_name

# long-lived drain functions: the last qualname segment decides
_LOOP_FN = re.compile(r"(^|_)(loop|worker|run|serve)$")

_BROAD = {"Exception", "BaseException"}

# calls through these names count as recording the failure
_RECORDING_NAMES = {"telemetry", "flightrec", "logging", "warnings",
                    "log", "logger"}
# logger-style method names (logger.error(...), LOG.exception(...))
_RECORDING_METHODS = {"debug", "info", "warning", "warn", "error",
                      "exception", "critical"}


def _is_broad(expr: Optional[ast.AST]) -> bool:
    if expr is None:  # bare `except:`
        return True
    if isinstance(expr, ast.Tuple):
        return any(_is_broad(e) for e in expr.elts)
    if isinstance(expr, ast.Name):
        return expr.id in _BROAD
    if isinstance(expr, ast.Attribute):  # builtins.Exception
        return expr.attr in _BROAD
    return False


def _is_recording_call(node: ast.Call) -> bool:
    dotted = dotted_call_name(node.func)
    if dotted is None:
        return False
    parts = dotted.split(".")
    if any(p in _RECORDING_NAMES for p in parts):
        return True
    return len(parts) >= 2 and parts[-1] in _RECORDING_METHODS


def _forwards_exception(node: ast.Call, bound: Optional[str]) -> bool:
    if bound is None:
        return False
    for arg in [*node.args, *(kw.value for kw in node.keywords)]:
        for sub in ast.walk(arg):
            if (isinstance(sub, ast.Name) and sub.id == bound
                    and isinstance(sub.ctx, ast.Load)):
                return True
    return False


class SilentExceptRule(Rule):
    code = "QT007"
    name = "silent-pipeline-except"
    description = ("broad except blocks in pipeline threads must "
                   "re-raise, record to telemetry/flightrec/logging, "
                   "or forward the exception object")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not ctx.is_hot():
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Try):
                continue
            for handler in node.handlers:
                if not _is_broad(handler.type):
                    continue
                scope = ctx.scope_of(handler)
                if not _LOOP_FN.search(scope.split(".")[-1]):
                    continue
                if self._records(handler):
                    continue
                caught = ("bare except" if handler.type is None
                          else ast.unparse(handler.type))
                yield ctx.finding(
                    self.code, handler,
                    f"broad handler ({caught}) in pipeline thread "
                    f"function swallows the failure: re-raise, record "
                    f"it (telemetry/flightrec/logging), or forward the "
                    f"exception object to a consumer")

    @staticmethod
    def _records(handler: ast.ExceptHandler) -> bool:
        bound = handler.name
        for stmt in handler.body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Raise):
                    return True
                if isinstance(node, ast.Call) and (
                        _is_recording_call(node)
                        or _forwards_exception(node, bound)):
                    return True
        return False
