"""QT005 — library hygiene: mutable default args and bare ``except:``.

Both are classic slow-motion serving bugs: a mutable default is one
shared object across every call (a stats dict default becomes global
state the first time two requests touch it), and a bare ``except:``
swallows ``KeyboardInterrupt``/``SystemExit``, turning an operator's
Ctrl-C into a hung worker thread.  Library code catches concrete
exception types; lanes that must survive arbitrary request errors say
so explicitly (``except Exception``), and the rare intentional case
carries a suppression with its justification.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import Finding, ModuleContext, Rule

_MUTABLE_CTORS = {"list", "dict", "set", "bytearray", "deque",
                  "defaultdict", "OrderedDict", "Counter"}


def _is_mutable_default(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in _MUTABLE_CTORS
    return False


class HygieneRule(Rule):
    code = "QT005"
    name = "library-hygiene"
    description = "mutable default arguments and bare except: clauses"

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for qual, fn in ctx.functions:
            args = fn.args
            defaults = list(args.defaults) + [d for d in args.kw_defaults
                                              if d is not None]
            for d in defaults:
                if _is_mutable_default(d):
                    yield ctx.finding(
                        self.code, d,
                        f"mutable default argument in `{fn.name}`: one "
                        "shared object across every call; default to None "
                        "and construct inside",
                        scope=qual)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                yield ctx.finding(
                    self.code, node,
                    "bare `except:` swallows KeyboardInterrupt/SystemExit; "
                    "catch Exception (or the concrete types) instead")
