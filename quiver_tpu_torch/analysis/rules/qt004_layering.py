"""QT004 — import layering: hot paths must not import the exporter stack.

``quiver_tpu_torch.telemetry.export`` pulls in ``http.server``; a module-level
import anywhere in the library would make every sampler/feature/serving
import pay for (and depend on) the HTTP stack, and would couple the data
plane to the observability plane.  The endpoint is opt-in at call time
(``InferenceServer.expose_metrics``) via a function-local import.

This generalizes an ad-hoc subprocess test
(``test_hot_paths_never_import_http_exporter``) into a static rule over
the whole package: any *import-time* import (module level, or class
body — both execute on import) of a forbidden module is a finding;
function-local lazy imports are the sanctioned pattern and pass.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

from ..core import Finding, ModuleContext, Rule, _match_any


def _function_spans(tree: ast.AST) -> List[ast.AST]:
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _resolve_from(node: ast.ImportFrom, module: str) -> Optional[str]:
    """Absolute dotted module for a possibly-relative ``from X import``."""
    if node.level == 0:
        return node.module
    parts = module.split(".")
    # for a module (not a package __init__), level-1 is its package
    base = parts[: len(parts) - node.level] if len(parts) >= node.level \
        else []
    if node.module:
        base = base + [node.module]
    return ".".join(base) if base else None


def _forbidden(name: Optional[str], forbidden: Tuple[str, ...]) -> bool:
    if not name:
        return False
    return any(name == f or name.startswith(f + ".") for f in forbidden)


class ImportLayeringRule(Rule):
    code = "QT004"
    name = "import-layering"
    description = ("library modules must not import the telemetry HTTP "
                   "exporter (or http.server) at import time; use a "
                   "function-local import at the opt-in call site")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if _match_any(ctx.relpath, ctx.config.layering_exempt):
            return
        forb = ctx.config.layering_forbidden
        inside_fn = set()
        for fn in _function_spans(ctx.tree):
            for sub in ast.walk(fn):
                inside_fn.add(id(sub))
        for node in ast.walk(ctx.tree):
            if id(node) in inside_fn:
                continue
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if _forbidden(alias.name, forb):
                        yield ctx.finding(
                            self.code, node,
                            f"import-time import of `{alias.name}` from a "
                            "library module; import it inside the opt-in "
                            "function instead")
            elif isinstance(node, ast.ImportFrom):
                base = _resolve_from(node, ctx.module)
                if _forbidden(base, forb):
                    yield ctx.finding(
                        self.code, node,
                        f"import-time import from `{base}` in a library "
                        "module; import it inside the opt-in function "
                        "instead")
                    continue
                for alias in node.names:
                    full = f"{base}.{alias.name}" if base else alias.name
                    if _forbidden(full, forb):
                        yield ctx.finding(
                            self.code, node,
                            f"import-time import of `{full}` in a library "
                            "module; import it inside the opt-in function "
                            "instead")
