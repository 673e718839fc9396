"""The port's linter over the JAX package's own tree: given JAX's
``LintConfig()`` field values and restricted to the copied rules
(QT003-QT012, QT014), it reports exactly the JAX linter's findings and
suppressions — rule, path, line, column, scope, message and snippet.
Each linter lints the tree once (a module-scoped fixture)."""

import dataclasses
from pathlib import Path

import pytest

import quiver_tpu.analysis as jax_lint
from quiver_tpu_torch.analysis import LintConfig, analyze_paths

REPO = Path(__file__).resolve().parents[1]
COPIED = ("QT003", "QT004", "QT005", "QT006", "QT007", "QT008", "QT009",
          "QT010", "QT011", "QT012", "QT014")


@pytest.fixture(scope="module", autouse=True)
def _jax_registry_left_empty():
    """The JAX code this file runs sets gauges and counters in the JAX
    package's registry: empty it when the file ends and set JAX's
    telemetry switch back, so nothing reaches a later file on this
    worker."""
    from quiver_tpu import telemetry as jax_telemetry

    on = jax_telemetry.enabled()
    yield
    jax_telemetry.reset()
    jax_telemetry.set_enabled(on)


def _key(f):
    return (f.rule, f.path, f.line, f.col, f.scope, f.message, f.snippet)


@pytest.fixture(scope="module")
def both():
    jcfg = jax_lint.LintConfig(rules=COPIED)
    jax = jax_lint.analyze_paths(["quiver_tpu"], config=jcfg, root=REPO)
    port = analyze_paths(["quiver_tpu"],
                         config=LintConfig(**dataclasses.asdict(jcfg)),
                         root=REPO)
    return jax, port


def test_same_files_and_no_errors(both):
    jax, port = both
    assert port.errors == jax.errors == []
    assert port.files == jax.files > 100


def test_same_findings(both):
    jax, port = both
    assert [_key(f) for f in port.findings] == [_key(f)
                                                for f in jax.findings]


def test_same_suppressions(both):
    jax, port = both
    assert [_key(f) for f in port.suppressed] == [_key(f)
                                                  for f in jax.suppressed]
    # the directives JAX carries for these rules are all in use
    assert {f.rule for f in jax.suppressed} >= {"QT003", "QT008", "QT012",
                                                "QT014"}


@pytest.mark.parametrize("rule", COPIED)
def test_each_rule_reports_what_jax_reports(both, rule):
    jax, port = both
    for attr in ("findings", "suppressed"):
        assert [_key(f) for f in getattr(port, attr) if f.rule == rule] \
            == [_key(f) for f in getattr(jax, attr) if f.rule == rule]


def test_copied_rules_default_to_the_port(both):
    """The same rules under the port's own defaults find nothing new in
    the JAX tree's hot modules: the defaults name the port's files."""
    port_default = analyze_paths(["quiver_tpu"],
                                 config=LintConfig(rules=("QT007",
                                                          "QT012")),
                                 root=REPO)
    assert port_default.findings == [] and port_default.suppressed == []
