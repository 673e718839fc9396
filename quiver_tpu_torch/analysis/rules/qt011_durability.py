"""QT011 — recovery-tier writes must flow through the blessed helpers.

The durability tier's whole value is that *every* persisted byte is
either a checksummed record (``blockio.write_record`` — torn tails and
bit rot are detectable) or an atomically published file
(``blockio.atomic_publish`` — readers never see a half-written
hybrid).  A bare ``open(path, "w")`` anywhere else under
``quiver_tpu_torch/recovery/`` silently reopens the exact failure modes the
tier exists to close: a crash mid-write leaves an unframed,
unverifiable file that replay can neither trust nor skip.

The rule is structural, not advisory: inside the durability scope
(``config.durability_scope``, default ``quiver_tpu_torch/recovery/*.py``)
any write-mode ``open``/``os.fdopen`` call — or one whose mode the
linter cannot prove is read-only — and any ``Path.write_text`` /
``Path.write_bytes`` call is a finding.  ``blockio.py`` itself is the
one exempt module (``config.durability_exempt``): it is where the raw
writes are *supposed* to live, behind the two audited primitives.

Read-mode opens pass: replay and checkpoint loading read freely; it is
only the mutation side that must be mediated.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from ..core import Finding, ModuleContext, Rule, _match_any, dotted_call_name

# any of these characters in an open() mode string means bytes can be
# written through the returned handle
_WRITE_MODE = re.compile(r"[wax+]")

_OPENERS = {"open", "io.open", "os.fdopen"}
_PATH_WRITERS = {"write_text", "write_bytes"}


def _mode_arg(node: ast.Call) -> Optional[ast.AST]:
    for kw in node.keywords:
        if kw.arg == "mode":
            return kw.value
    if len(node.args) >= 2:
        return node.args[1]
    return None


class DurabilityRule(Rule):
    code = "QT011"
    name = "durable-write-path"
    description = ("recovery-tier modules must persist bytes through "
                   "blockio.write_record / blockio.atomic_publish, not "
                   "bare write-mode open()/write_text()/write_bytes()")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not _match_any(ctx.relpath, ctx.config.durability_scope):
            return
        if _match_any(ctx.relpath, ctx.config.durability_exempt):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = dotted_call_name(node.func)
            if dotted in _OPENERS:
                mode = _mode_arg(node)
                if mode is None:
                    continue  # default "r": read-only
                if isinstance(mode, ast.Constant) and isinstance(
                        mode.value, str):
                    if not _WRITE_MODE.search(mode.value):
                        continue
                    why = f"write-mode open ({mode.value!r})"
                else:
                    why = "open() with a mode the linter cannot prove " \
                          "read-only"
                yield ctx.finding(
                    self.code, node,
                    f"{why} in a durability-scope module: persist "
                    "through blockio.write_record / "
                    "blockio.atomic_publish (or blockio.append_open "
                    "for WAL segments) so the bytes are checksummed "
                    "or atomically published")
            elif dotted and dotted.split(".")[-1] in _PATH_WRITERS:
                yield ctx.finding(
                    self.code, node,
                    f"`{dotted}` bypasses the durable write helpers: "
                    "use blockio.atomic_publish so readers never see "
                    "a torn file")
