"""Nothing under portbench/ imports JAX or the JAX package, compared by
whole top-level name (``quiver_tpu_torch`` is not ``quiver_tpu``), the
reference imports nothing of the program, and no source names the JAX
package's benchmark files."""

import ast
import subprocess
import sys

import pytest

from portbench import core
from portbench.tests import tiny

SOURCES = sorted(core.HERE.rglob("*.py"))
REFERENCE = core.HERE / "reference"
ALLOWED_IN_REFERENCE = {"__future__", "contextlib", "typing", "math",
                        "numpy", "torch"}


def _imports(path):
    """Top-level names of what ``path`` imports; a relative import is
    named by the package it reaches (``portbench`` or ``portbench.x``)."""
    tree = ast.parse(path.read_text())
    pkg = path.relative_to(core.HERE.parent).parent.parts
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[:len(pkg) - node.level + 1]
                out.add(".".join(base + ((node.module,) if node.module
                                         else ())))
            else:
                out.add(node.module)
    return out


def top(name):
    return name.split(".", 1)[0]


def test_the_comparison_is_by_whole_name():
    assert top("quiver_tpu_torch.ops") not in core.FORBIDDEN
    assert top("quiver_tpu.ops") in core.FORBIDDEN
    assert top("jax.numpy") in core.FORBIDDEN


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(core.HERE)) for p in SOURCES])
def test_no_jax_nor_the_jax_package(path):
    bad = {m for m in _imports(path) if top(m) in core.FORBIDDEN}
    assert not bad, f"{path} imports {bad}"
    text = path.read_text()
    if path.name != "test_portbench_imports.py":
        assert "benchmarks/" not in text and "bench.py" not in text


@pytest.mark.parametrize("path", sorted(REFERENCE.rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    for m in _imports(path):
        inside = m.startswith("portbench.reference")
        assert inside or top(m) in ALLOWED_IN_REFERENCE, \
            f"{path.name} imports {m}"


def test_a_run_loads_no_jax():
    """A whole (tiny, CPU) run in a fresh interpreter leaves no module of
    JAX or the JAX package in ``sys.modules``."""
    code = ("import sys; from portbench.tests import tiny; "
            "from portbench import core; "
            "r = tiny.run('products-sage.train', seconds=0.2); "
            "print(core.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
