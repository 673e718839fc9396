"""The port's linter (``quiver_tpu_torch.analysis``) against the JAX
package's (``quiver_tpu.analysis``), fixture by fixture.

The rules QT003-QT012 and QT014, the suppression parser and the
whole-program concurrency model are copies.  So every fixture of the JAX
package's ``test_quiverlint_rules.py`` (``TestLockDiscipline`` through
``TestCli``) and ``test_concurrency_analysis.py`` runs here as JAX wrote
it, with its ``analyze_paths`` running BOTH linters on the same file
under the same configuration values and requiring the same findings and
suppressions — rule, path, line, column, scope, message and snippet —
before JAX's own assertions run on the port's result.  The JAX modules
are loaded as private copies, so the JAX suite's own run is untouched.

QT001 is the port's own (torch host syncs): each of JAX's host-sync
fixtures has a torch twin that must be flagged at the lines JAX's is,
and the suppression, baseline and CLI cases that ride on QT001 are
repeated with torch syncs.
"""

import dataclasses
import importlib.util
import inspect
import json
import textwrap
from pathlib import Path

import pytest

import quiver_tpu.analysis as jax_lint
from quiver_tpu_torch.analysis import (LintConfig, RULE_CLASSES,
                                       analyze_paths)
from quiver_tpu_torch.analysis import baseline as baseline_mod
from quiver_tpu_torch.analysis import concurrency as port_concurrency
from quiver_tpu_torch.analysis.cli import main as lint_main
from quiver_tpu_torch.analysis.concurrency.program import MAIN_ROOT
from quiver_tpu_torch.analysis.core import load_contexts

REPO = Path(__file__).resolve().parents[1]
ALL_HOT = ("*.py",)


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


def both_analyze(paths, config=None, root=None):
    """Both linters over ``paths`` under the same configuration values;
    the findings and suppressions must be identical.  Returns the
    port's result."""
    config = config or _jax_defaults()
    jax = jax_lint.analyze_paths(
        paths, config=jax_lint.LintConfig(**dataclasses.asdict(config)),
        root=root)
    port = analyze_paths(paths, config=config, root=root)
    assert [_key(f) for f in port.findings] == [_key(f)
                                                for f in jax.findings]
    assert [_key(f) for f in port.suppressed] == [_key(f)
                                                  for f in jax.suppressed]
    assert port.errors == jax.errors and port.files == jax.files
    return port


def _jax_defaults(**kw):
    """A port config holding the JAX package's default values (its hot
    modules and scopes name ``quiver_tpu/...``, as the fixtures do)."""
    return LintConfig(**{**dataclasses.asdict(jax_lint.LintConfig()), **kw})


def _load_jax_cases(name):
    spec = importlib.util.spec_from_file_location(
        f"_port_parity_{name}", REPO / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.LintConfig = _jax_defaults
    mod.analyze_paths = both_analyze
    return mod


RULES = _load_jax_cases("test_quiverlint_rules")
RULES.lint_main = lint_main
CONCURRENCY = _load_jax_cases("test_concurrency_analysis")
CONCURRENCY.build_program = port_concurrency.build_program
CONCURRENCY.canonical_lock_edges = port_concurrency.canonical_lock_edges
CONCURRENCY.load_contexts = load_contexts
CONCURRENCY.MAIN_ROOT = MAIN_ROOT


def _cases(mod, classes, skip=()):
    out = []
    for cname in classes:
        cls = getattr(mod, cname)
        for name in sorted(n for n in vars(cls) if n.startswith("test_")):
            if f"{cname}.{name}" not in skip:
                out.append(pytest.param(cls, name, id=f"{cname}.{name}"))
    return out


# QT001-based cases (jax.device_get) have torch twins below
_RULE_CASES = _cases(RULES, (
    "TestLockDiscipline", "TestImportLayering", "TestHygiene",
    "TestMetricNames", "TestSilentExcept", "TestDurability",
    "TestWallClock", "TestCli"),
    skip={"TestCli.test_exit_codes_and_baseline_flow"})


def _call(cls, name, tmp_path, capsys):
    fn = getattr(cls(), name)
    wants = inspect.signature(fn).parameters
    fn(tmp_path, **({"capsys": capsys} if "capsys" in wants else {}))


@pytest.mark.parametrize("cls, name", _RULE_CASES)
def test_rule_fixture_matches_jax(cls, name, tmp_path, capsys):
    _call(cls, name, tmp_path, capsys)


@pytest.mark.parametrize("cls, name", _cases(CONCURRENCY, (
    "TestProgramModel", "TestDataRace", "TestLockOrder", "TestThreadReap")))
def test_concurrency_fixture_matches_jax(cls, name, tmp_path, capsys):
    _call(cls, name, tmp_path, capsys)


@pytest.mark.parametrize("pkg, rules", [
    ("race_seeded", ["QT008"]), ("inversion_seeded", ["QT009"]),
    ("race_guarded", []), ("inversion_clean", [])])
def test_concurrency_fixture_packages_match_jax(pkg, rules, capsys):
    """JAX's on-disk seeded-bug packages and their clean twins: the same
    findings from both linters, and the port's CLI exits as JAX's
    does."""
    target = REPO / "tests" / "fixtures" / "concurrency" / pkg
    result = both_analyze([str(target)], root=REPO)
    assert sorted({f.rule for f in result.findings}) == rules
    rc = lint_main([str(target), "--root", str(REPO), "--no-baseline",
                    "--format", "json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == (1 if rules else 0)
    assert sorted({f["rule"] for f in doc["findings"]}) == rules


def test_rule_set_is_this_slice():
    """JAX's fifteen rules, in code order, with JAX's names and the rule
    hash computed as JAX computes it."""
    codes = [cls.code for cls in RULE_CLASSES]
    assert codes == [f"QT{i:03d}" for i in range(1, 16)]
    assert codes == [cls.code for cls in jax_lint.RULE_CLASSES]
    jax_names = {cls.code: cls.name for cls in jax_lint.RULE_CLASSES}
    assert all(cls.name == jax_names[cls.code] for cls in RULE_CLASSES)
    from quiver_tpu_torch.analysis.rules import rule_fingerprints

    hashes = rule_fingerprints()
    assert sorted(hashes) == codes
    assert all(len(h) == 16 for h in hashes.values())


# -------------------------------------------------------------- QT001
def _run(tmp_path, source, name="mod.py", lint=analyze_paths,
         config=LintConfig, **cfg):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return lint([str(p)], config=config(**cfg), root=tmp_path)


def codes(result):
    return sorted(f.rule for f in result.findings)


# JAX's TestHostSync fixture, then its torch twin: the same shape, the
# findings at the same lines
HOST_SYNC_TWINS = {
    "flags_device_get_and_block_until_ready": ("""
        import jax

        def hot_loop(x):
            y = jax.device_get(x)
            x.block_until_ready()
            return y
    """, """
        import torch

        def hot_loop(x):
            y = x.cpu()
            torch.cuda.synchronize()
            return y
    """, {}),
    "flags_cast_of_tracked_device_value": ("""
        import jax.numpy as jnp

        def f(a):
            x = jnp.cumsum(a)
            total = x * 2 + 1
            return int(total[-1])
    """, """
        import torch

        def f(a):
            x = torch.cumsum(a, 0)
            total = x * 2 + 1
            return int(total[-1])
    """, {}),
    "host_numpy_cast_is_clean": ("""
        import numpy as np

        def f(a):
            y = np.cumsum(a)
            return int(y[-1])
    """, """
        import numpy as np

        def f(a):
            y = np.cumsum(a)
            return int(y[-1]), y.sum().item(), y.tolist()
    """, {}),
    "materialized_value_is_host_afterwards": ("""
        import jax.numpy as jnp
        import numpy as np

        def f(a):
            h = np.asarray(jnp.cumsum(a))
            return int(h[-1]), float(h[0])
    """, """
        import numpy as np
        import torch

        def f(a):
            h = np.asarray(torch.cumsum(a, 0))
            return int(h[-1]), float(h[0])
    """, {}),
    "attribute_target_does_not_poison_self": ("""
        import jax.numpy as jnp

        class G:
            def __init__(self, a):
                self.dev = jnp.asarray(a)
                self.n = int(len(a))
    """, """
        import torch

        class G:
            def __init__(self, a):
                self.dev = torch.as_tensor(a)
                self.n = int(len(a))
    """, {}),
    "cold_module_is_exempt": ("""
        import jax

        def f(x):
            return jax.device_get(x)
    """, """
        import torch

        def f(x):
            return x.cpu()
    """, dict(name="cold.py", hot_modules=("hot_*.py",))),
}


@pytest.mark.parametrize("case", sorted(HOST_SYNC_TWINS))
def test_host_sync_twin_is_flagged_where_jax_flags(case, tmp_path):
    jax_src, torch_src, cfg = HOST_SYNC_TWINS[case]
    cfg = dict(dict(hot_modules=ALL_HOT), **cfg)
    jax = _run(tmp_path / "jax", jax_src, lint=jax_lint.analyze_paths,
               config=jax_lint.LintConfig, **cfg)
    port = _run(tmp_path / "port", torch_src, **cfg)
    assert [(f.rule, f.line, f.scope) for f in port.findings] == [
        (f.rule, f.line, f.scope) for f in jax.findings]
    if case == "flags_cast_of_tracked_device_value":
        assert "int(...)" in port.findings[0].message
    if case == "materialized_value_is_host_afterwards":
        assert "np.asarray" in port.findings[0].snippet


# torch-only QT001 cases: (source, flagged lines)
TORCH_SYNCS = {
    "item_and_tolist_of_a_tensor": ("""
        import torch

        def f(a):
            t = torch.arange(a)
            n = t.sum().item()
            return n, t.tolist(), torch.ones(3).item()
    """, [6, 7, 7]),
    "cpu_and_to_cpu_are_flagged_outright": ("""
        import torch

        def f(x, dev):
            a = x.to("cpu")
            b = x.to(torch.device("cpu"))
            c = x.to(dev)
            return a, b, c, x.cpu()
    """, [5, 6, 8]),
    "numpy_is_the_cpu_copy_not_a_second_sync": ("""
        def f(x):
            return x.cpu().numpy(), x.numpy()
    """, [3]),
    "event_and_stream_waits": ("""
        import torch

        def f(ev, dev):
            ev.synchronize()
            torch.cuda.current_stream(dev).synchronize()
    """, [5, 6]),
    "metadata_reads_are_host": ("""
        import torch

        def f(a):
            t = torch.arange(a)
            return int(t.shape[0]), int(t.numel()), bool(t.is_cuda)
    """, []),
    "pageable_uploads": ("""
        import numpy as np
        import torch

        def f(a, dev):
            x = torch.from_numpy(a).to(dev)
            y = torch.from_numpy(a).long().cuda()
            z = torch.tensor([1, 2], device=dev)
            return x, y, z
    """, [6, 7, 8]),
    "pinned_or_async_uploads_are_clean": ("""
        import torch

        def f(a, dev):
            x = torch.from_numpy(a).to(dev, non_blocking=True)
            y = torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
            z = torch.from_numpy(a).to(torch.int32)
            w = torch.tensor([1, 2], device="cpu")
            return x, y, z, w
    """, []),
    "non_tensor_torch_calls_are_host": ("""
        import torch

        def f():
            ok = torch.cuda.is_available()
            n = torch.cuda.device_count()
            return bool(ok), int(n)
    """, []),
}


@pytest.mark.parametrize("case", sorted(TORCH_SYNCS))
def test_torch_host_sync_cases(case, tmp_path):
    src, lines = TORCH_SYNCS[case]
    r = _run(tmp_path, src, hot_modules=ALL_HOT)
    assert codes(r) == ["QT001"] * len(lines)
    assert [f.line for f in r.findings] == lines


# ------------------------------------------------ suppression plumbing
def test_same_line_suppression(tmp_path):
    r = _run(tmp_path, """
        import torch

        def f(x):
            return x.cpu()  # quiverlint: ignore[QT001] -- probe
    """, hot_modules=ALL_HOT)
    assert r.findings == []
    assert [f.rule for f in r.suppressed] == ["QT001"]


def test_comment_line_above_covers_justification_block(tmp_path):
    r = _run(tmp_path, """
        import torch

        def f(x):
            # quiverlint: ignore[QT001]
            # this sync is the serialized baseline arm of the A/B
            return x.cpu()
    """, hot_modules=ALL_HOT)
    assert r.findings == []
    assert [f.rule for f in r.suppressed] == ["QT001"]


def test_suppression_is_rule_specific(tmp_path):
    r = _run(tmp_path, """
        import torch

        def f(x):
            return x.cpu()  # quiverlint: ignore[QT005]
    """, hot_modules=ALL_HOT)
    assert codes(r) == ["QT001"]


# ------------------------------------------------------------ baseline
SRC = """
    import torch

    def f(x):
        return x.cpu()
"""


def test_baseline_round_trip_and_partition(tmp_path):
    r = _run(tmp_path, SRC, hot_modules=ALL_HOT)
    bl = tmp_path / "bl.json"
    baseline_mod.save(bl, r.findings)
    accepted = baseline_mod.load(bl)
    assert [f.fingerprint() for f in accepted] \
        == [f.fingerprint() for f in r.findings]
    new, known = baseline_mod.partition(r.findings, accepted)
    assert new == [] and len(known) == 1
    assert baseline_mod.stale(r.findings, accepted) == []
    assert len(baseline_mod.stale([], accepted)) == 1


def test_baseline_survives_line_shift_not_edit(tmp_path):
    r1 = _run(tmp_path, SRC, hot_modules=ALL_HOT)
    bl = tmp_path / "bl.json"
    baseline_mod.save(bl, r1.findings)
    r2 = _run(tmp_path, "import os\nX = 1\n" + textwrap.dedent(SRC),
              hot_modules=ALL_HOT)
    new, known = baseline_mod.partition(r2.findings, baseline_mod.load(bl))
    assert new == [] and len(known) == 1
    r3 = _run(tmp_path, SRC.replace("x.cpu()", "x[:1].cpu()"),
              hot_modules=ALL_HOT)
    new, known = baseline_mod.partition(r3.findings, baseline_mod.load(bl))
    assert len(new) == 1 and known == []


def test_second_copy_of_baselined_violation_is_new(tmp_path):
    r1 = _run(tmp_path, SRC, hot_modules=ALL_HOT)
    bl = tmp_path / "bl.json"
    baseline_mod.save(bl, r1.findings)
    doubled = textwrap.dedent(SRC) + textwrap.dedent("""
        def g(x):
            return x.cpu()
    """)
    r2 = _run(tmp_path, doubled, hot_modules=ALL_HOT)
    new, known = baseline_mod.partition(r2.findings, baseline_mod.load(bl))
    assert len(known) == 1 and len(new) == 1
    assert new[0].scope == "g"


def test_rule_hash_mismatch_is_reported(tmp_path):
    r = _run(tmp_path, SRC, hot_modules=ALL_HOT)
    bl = tmp_path / "bl.json"
    baseline_mod.save(bl, r.findings)
    entries = baseline_mod.load_entries(bl)
    assert baseline_mod.hash_mismatches(entries, {"QT001": entries[0][1]}) \
        == []
    assert len(baseline_mod.hash_mismatches(entries, {"QT001": "0" * 16})) \
        == 1


# ------------------------------------------------------------ CLI
def test_cli_exit_codes_and_baseline_flow(tmp_path, capsys):
    mod = tmp_path / "quiver_tpu_torch" / "sampler.py"
    mod.parent.mkdir()
    mod.write_text("import torch\n\n"
                   "def f(x):\n"
                   "    return x.cpu()\n")
    root = str(tmp_path)
    assert lint_main(["quiver_tpu_torch", "--root", root]) == 1
    assert lint_main(["quiver_tpu_torch", "--root", root,
                      "--write-baseline"]) == 0
    assert (tmp_path / "quiverlint_torch.baseline.json").exists()
    assert lint_main(["quiver_tpu_torch", "--root", root]) == 0
    assert lint_main(["quiver_tpu_torch", "--root", root,
                      "--strict-baseline"]) == 0
    assert lint_main(["quiver_tpu_torch", "--root", root,
                      "--no-baseline"]) == 1
    capsys.readouterr()
    assert lint_main(["quiver_tpu_torch", "--root", root, "--no-baseline",
                      "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in doc["findings"]] == ["QT001"]
    mod.write_text("def f(x):\n    return x\n")
    assert lint_main(["quiver_tpu_torch", "--root", root]) == 0
    assert lint_main(["quiver_tpu_torch", "--root", root,
                      "--strict-baseline"]) == 1
    assert "stale baseline entry" in capsys.readouterr().out


def test_cli_default_target_and_rule_list(tmp_path, capsys):
    mod = tmp_path / "quiver_tpu_torch" / "serving.py"
    mod.parent.mkdir()
    mod.write_text("import torch\n\n"
                   "def f():\n"
                   "    torch.cuda.synchronize()\n")
    assert lint_main(["--root", str(tmp_path), "--no-baseline"]) == 1
    assert "quiver_tpu_torch/serving.py:4:4: QT001" in capsys.readouterr().out
    assert lint_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out.split("\n")
    assert [line.split()[0] for line in listed if line] == [
        cls.code for cls in RULE_CLASSES]


# ------------------------------------------- the port's own defaults
# JAX's fixtures that lean on the default scopes, with every
# ``quiver_tpu`` renamed: under the port's defaults the port must report
# what JAX reports under its own
@pytest.mark.parametrize("source, name, rule", [
    ("""
        class Compactor:
            def run(self):
                while not self._stop.wait(self.poll_s):
                    try:
                        self._maybe_compact()
                    except Exception:
                        continue
    """, "{pkg}/stream/compactor.py", "QT007"),
    ("""
        class QoSController:
            def _admit_loop(self, q):
                while True:
                    req = q.get()
                    try:
                        self._take_tokens(req)
                    except Exception:
                        continue
    """, "{pkg}/resilience/qos.py", "QT007"),
    ("""
        from {pkg}.telemetry.export import start_http_server

        def serve():
            return start_http_server()
    """, "{pkg}/serving.py", "QT004"),
    ("""
        def persist(path, data):
            with open(path, "w") as f:
                f.write(data)
    """, "{pkg}/recovery/wal.py", "QT011"),
    ("""
        def persist(path, data):
            with open(path, "w") as f:
                f.write(data)
    """, "{pkg}/recovery/blockio.py", None),
    ("""
        import time

        def serve(fn):
            t0 = time.time()
            fn()
            return time.time() - t0
    """, "{pkg}/ops/cuda/gather_rows.py", "QT012"),
    ("""
        import torch

        def f(x):
            return x.cpu()
    """, "{pkg}/analysis/core.py", None),
])
def test_port_defaults_scope_the_port_as_jax_scopes_jax(source, name, rule,
                                                         tmp_path):
    found = {}
    for pkg, lint, config in (
            ("quiver_tpu", jax_lint.analyze_paths, jax_lint.LintConfig),
            ("quiver_tpu_torch", analyze_paths, LintConfig)):
        root = tmp_path / pkg
        r = _run(root, source.replace("{pkg}", pkg),
                 name=name.format(pkg=pkg), lint=lint, config=config)
        found[pkg] = [(f.rule, f.line, f.scope) for f in r.findings]
    assert found["quiver_tpu_torch"] == found["quiver_tpu"]
    assert [r for r, _, _ in found["quiver_tpu_torch"]] == (
        [rule] if rule else [])
