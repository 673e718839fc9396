"""The port's staging rules (QT002, QT013, QT015) and the audited
``sync-ok`` waiver against the JAX package's, case by case.

Every case of JAX's ``TestRetrace`` (``test_quiverlint_rules.py``) and of
``TestDataflow``, ``TestInterproceduralSync`` and
``TestCollectiveDiscipline`` (``test_staging_analysis.py``), and the four
``sync_*`` / ``psum_*`` fixture packages, runs here twice: the JAX
original through the JAX package's linter, a line-for-line torch
translation through the port's.  Both must report the same rule codes on
the same lines (the dataflow cases: the same residency classes).  The
torch sources stand where JAX's stand: ``jnp.asarray(xs)`` becomes
``torch.as_tensor(xs, device="cuda")`` (a DEVICE source), ``jax.jit``
becomes ``torch.compile``, ``jax.lax.psum(x, AXIS)`` over a ``pmap`` body
becomes ``dist.comm.psum(parts)`` over a mesh's devices.

The port-only cases cover each DEVICE and HOST source the torch form
adds, the builders QT002 watches in loops, and the ownership line
between QT001 and QT013.
"""

import ast
import dataclasses
import json
import textwrap
from pathlib import Path

import pytest

import quiver_tpu.analysis as jax_lint
from quiver_tpu.analysis.concurrency import build_program as jax_program
from quiver_tpu.analysis.core import ModuleContext as JaxContext
from quiver_tpu.analysis.core import load_contexts as jax_contexts
from quiver_tpu.analysis.staging import dataflow as jax_dataflow

from quiver_tpu_torch.analysis import LintConfig, analyze_paths
from quiver_tpu_torch.analysis.cli import main as lint_main
from quiver_tpu_torch.analysis.concurrency import build_program
from quiver_tpu_torch.analysis.core import ModuleContext, load_contexts
from quiver_tpu_torch.analysis.staging import dataflow
from quiver_tpu_torch.analysis.staging.dataflow import (DEVICE, HOST,
                                                        build_dataflow)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "staging"

# JAX's fixture-scoped configuration (test_staging_analysis.FIXTURE_CFG)
FIXTURE_CFG = dict(
    hot_modules=("sync_seeded/*.py", "sync_clean/*.py", "mod.py", "hot.py"),
    bitexact_modules=("psum_seeded/*.py", "psum_clean/*.py", "mod.py"))


def _lint(lint, config, root, source, name):
    p = root / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    r = lint([str(p)], config=config, root=root)
    assert r.errors == [], r.errors
    return r


def _lines(result):
    return [(f.rule, f.line) for f in result.findings]


def twin(tmp_path, jax_src, torch_src, name="mod.py", port_name=None,
         cfg=None):
    """JAX's source through JAX's linter, the torch twin through the
    port's, each under its package's defaults (plus ``cfg``); asserts
    the same (rule, line) findings and returns both results."""
    cfg = cfg or {}
    jax = _lint(jax_lint.analyze_paths, jax_lint.LintConfig(**cfg),
                tmp_path / "jax", jax_src, name)
    port = _lint(analyze_paths, LintConfig(**cfg), tmp_path / "port",
                 torch_src, port_name or name)
    assert _lines(port) == _lines(jax), (
        [f.format() for f in port.findings],
        [f.format() for f in jax.findings])
    assert [s[1:] for s in port.stale_sync_ok] == [
        s[1:] for s in jax.stale_sync_ok]
    return jax, port


def _case_names(path, cls):
    tree = ast.parse((REPO / "tests" / path).read_text())
    node = next(n for n in tree.body
                if isinstance(n, ast.ClassDef) and n.name == cls)
    return sorted(f.name[len("test_"):] for f in node.body
                  if isinstance(f, ast.FunctionDef)
                  and f.name.startswith("test_"))


# ------------------------------------------------------------------ QT002
# JAX's TestRetrace, case by case: (JAX source, torch twin, file name,
# the port's file name)
RETRACE = {
    "flags_jit_lambda": ("""
        import jax

        def make(f):
            return jax.jit(lambda x: f(x))
    """, """
        import torch

        def make(f):
            return torch.compile(lambda x: f(x))
    """, "mod.py", None),
    "flags_jit_in_loop": ("""
        import jax

        def run(fs, x):
            for f in fs:
                x = jax.jit(f)(x)
            return x
    """, """
        import torch

        def run(fs, x):
            for f in fs:
                x = torch.compile(f)(x)
            return x
    """, "mod.py", None),
    "cached_named_jit_is_clean": ("""
        import jax

        def pipeline(x):
            return x

        _fn = jax.jit(pipeline)

        def run(x):
            return _fn(x)
    """, """
        import torch

        def pipeline(x):
            return x

        _fn = torch.compile(pipeline)

        def run(x):
            return _fn(x)
    """, "mod.py", None),
    "flags_traced_param_in_shape": ("""
        import jax
        import jax.numpy as jnp

        @jax.jit
        def pad(x, n):
            return jnp.zeros((n, 4)) + x
    """, """
        import torch
        import torch.nn.functional as F

        @torch.compile
        def pad(x, n):
            return torch.zeros((n, 4)) + x
    """, "mod.py", None),
    "static_argnames_makes_shape_param_clean": ("""
        import functools
        import jax
        import jax.numpy as jnp

        @functools.partial(jax.jit, static_argnames=("n",))
        def pad(x, n):
            return jnp.zeros((n, 4)) + x
    """, """
        import functools
        import torch
        import torch.nn.functional as F

        @functools.partial(torch.compile, dynamic=True)
        def pad(x, n):
            return torch.zeros((n, 4)) + x
    """, "mod.py", None),
    "flags_jit_method_tracing_self": ("""
        import jax

        class S:
            @jax.jit
            def fwd(self, x):
                return x * self.scale
    """, """
        import torch

        class S:
            @torch.compile
            def fwd(self, x):
                return x * self.scale
    """, "mod.py", None),
    "flags_jit_in_compactor_loop": ("""
        import jax

        class Compactor:
            def run(self, graph):
                while not self._stop.is_set():
                    fold = jax.jit(lambda i: graph.merge(i))
                    fold(graph.snapshot())
    """, """
        import torch

        class Compactor:
            def run(self, graph):
                while not self._stop.is_set():
                    fold = torch.compile(lambda i: graph.merge(i))
                    fold(graph.snapshot())
    """, "quiver_tpu/stream/compactor.py",
        "quiver_tpu_torch/stream/compactor.py"),
    "snapshot_keyed_stream_cache_is_clean": ("""
        import jax

        class S:
            def _build_stream_jit(self, batch_size, windowed):
                def fn(indptr, indices, seeds, key):
                    return seeds
                return jax.jit(fn)

            def sample(self, snap, seeds, key):
                jk = ("stream", len(seeds), snap.epad)
                fn = self._jitted.get(jk)
                if fn is None:
                    fn = self._jitted[jk] = self._build_stream_jit(
                        len(seeds), False)
                return fn(snap.indptr, snap.indices, seeds, key)
    """, """
        import torch

        class S:
            def _build_stream_jit(self, batch_size, windowed):
                def fn(indptr, indices, seeds, key):
                    return seeds
                return torch.compile(fn)

            def sample(self, snap, seeds, key):
                jk = ("stream", len(seeds), snap.epad)
                fn = self._jitted.get(jk)
                if fn is None:
                    fn = self._jitted[jk] = self._build_stream_jit(
                        len(seeds), False)
                return fn(snap.indptr, snap.indices, seeds, key)
    """, "quiver_tpu/stream/sampler.py",
        "quiver_tpu_torch/stream/sampler.py"),
    "flags_jit_per_page_in_fault_loop": ("""
        import jax

        class Store:
            def fault(self, pages, frames):
                for p in pages:
                    frames = jax.jit(
                        lambda f: f.at[p].set(0))(frames)
                return frames
    """, """
        import torch

        class Store:
            def fault(self, pages, frames):
                for p in pages:
                    frames = torch.compile(
                        lambda f: f.index_fill(0, p, 0))(frames)
                return frames
    """, "quiver_tpu/ops/paged.py", "quiver_tpu_torch/ops/paged.py"),
    "page_table_as_traced_operand_is_clean": ("""
        import jax

        class Store:
            def _paged_fn(self, B):
                fn = self._cache.get(("paged", B))
                if fn is None:
                    @jax.jit
                    def fn(frames, pages, offs, rank):
                        return frames
                    self._cache[("paged", B)] = fn
                return fn

            def gather(self, frames, pages, offs, rank, B):
                return self._paged_fn(B)(frames, pages, offs, rank)
    """, """
        import torch

        class Store:
            def _paged_fn(self, B):
                fn = self._cache.get(("paged", B))
                if fn is None:
                    @torch.compile
                    def fn(frames, pages, offs, rank):
                        return frames
                    self._cache[("paged", B)] = fn
                return fn

            def gather(self, frames, pages, offs, rank, B):
                return self._paged_fn(B)(frames, pages, offs, rank)
    """, "quiver_tpu/ops/paged.py", "quiver_tpu_torch/ops/paged.py"),
}


def test_retrace_twins_cover_every_jax_case():
    assert sorted(RETRACE) == _case_names("test_quiverlint_rules.py",
                                          "TestRetrace")


@pytest.mark.parametrize("case", sorted(RETRACE))
def test_retrace_twin_is_flagged_where_jax_flags(case, tmp_path):
    jax_src, torch_src, name, port_name = RETRACE[case]
    jax, port = twin(tmp_path, jax_src, torch_src, name, port_name)
    if "flags" in case:
        assert "QT002" in [f.rule for f in port.findings]
    else:
        assert [f for f in port.findings if f.rule == "QT002"] == []
    words = {"flags_jit_lambda": "lambda", "flags_jit_in_loop": "loop",
             "flags_traced_param_in_shape": "`n`",
             "flags_jit_method_tracing_self": "self"}
    if case in words:
        assert words[case] in port.findings[0].message


# torch-only QT002 cases: (file, source, flagged lines)
BUILDERS = {
    "builders_in_loops": ("quiver_tpu_torch/serving.py", """
        import ctypes

        from .cpp import native
        from .ops.cuda import build
        from .ops.cuda.build import load_libraries

        def warm(names, srcs):
            for n in names:
                build.build_all([n])
                load_libraries([n])
                build.load(n, "entry", [])
            for s in srcs:
                native.load(s, None)
                native.build(s)
                ctypes.CDLL(str(s))
            return native.load(srcs[0], None)
    """, [10, 11, 14, 15, 16]),
    "builder_modules_loop_by_design": ("quiver_tpu_torch/ops/cuda/build.py",
                                       """
        import ctypes

        def build_all(names):
            return [n for n in names]

        def load_libraries(names):
            for n in names:
                build_all([n])
                ctypes.CDLL(n)
    """, []),
    "script_and_trace_lambdas": ("mod.py", """
        import torch

        def make(f, example):
            a = torch.jit.script(lambda x: f(x))
            b = torch.jit.trace(lambda x: f(x), example)
            return a, b, torch.jit.script(f)
    """, [5, 6]),
    "shape_methods_and_factories": ("mod.py", """
        import torch

        @torch.compile
        def pad(x, b, n, fill):
            y = x.view(b, -1) + torch.arange(n)[:, None]
            return y.new_full((b, 3), fill), torch.full((n,), fill)
    """, [6, 7]),
}


@pytest.mark.parametrize("case", sorted(BUILDERS))
def test_retrace_torch_cases(case, tmp_path):
    name, src, lines = BUILDERS[case]
    r = _lint(analyze_paths, LintConfig(rules=("QT002",)), tmp_path, src,
              name)
    assert [f.line for f in r.findings] == lines, [
        f.format() for f in r.findings]


# --------------------------------------------------------------- dataflow
# JAX's TestDataflow: (JAX source, torch twin, what is read off the
# solve) — the same residency on both sides
def _ret(key):
    return lambda prog, df, _: (df.ret.get(key) or dataflow.Val()).cls


def _param(key, name):
    return lambda prog, df, _: (df.param.get((key, name))
                                or dataflow.Val()).cls


def _classified(fkey, expr):
    def read(prog, df, _):
        v = df.classify(prog.functions[fkey], ast.parse(expr).body[0].value)
        return v.cls if v else None
    return read


DATAFLOW = {
    "device_class_crosses_return_edges": ("""
        import jax.numpy as jnp

        def make(xs):
            return jnp.asarray(xs)

        def use(xs):
            v = make(xs)
            return v
    """, """
        import torch

        def make(xs):
            return torch.as_tensor(xs, device="cuda")

        def use(xs):
            v = make(xs)
            return v
    """, [_ret("mod:make"), _classified("mod:use", "v")], DEVICE),
    "metadata_attrs_are_host": ("""
        import jax.numpy as jnp

        def shape_of(xs):
            arr = jnp.asarray(xs)
            n = arr.shape[0]
            return n
    """, """
        import torch

        def shape_of(xs):
            arr = torch.as_tensor(xs, device="cuda")
            n = arr.shape[0]
            return n
    """, [_ret("mod:shape_of")], HOST),
    "param_join_from_call_sites": ("""
        import jax.numpy as jnp

        def sink(v):
            return v

        def caller(xs):
            return sink(jnp.asarray(xs))
    """, """
        import torch

        def sink(v):
            return v

        def caller(xs):
            return sink(torch.as_tensor(xs, device="cuda"))
    """, [_param("mod:sink", "v")], DEVICE),
    "self_attr_residency_through_methods": ("""
        import jax.numpy as jnp

        class Holder:
            def __init__(self, xs):
                self.buf = jnp.asarray(xs)

            def get(self):
                return self.buf
    """, """
        import torch

        class Holder:
            def __init__(self, xs):
                self.buf = torch.as_tensor(xs, device="cuda")

            def get(self):
                return self.buf
    """, [_ret("mod:Holder.get")], DEVICE),
    "host_math_stays_host": ("""
        def tally(xs):
            total = len(xs) + 1
            return total
    """, """
        def tally(xs):
            total = len(xs) + 1
            return total
    """, [_ret("mod:tally")], HOST),
}


def _solve(tmp_path, source, contexts, program, flow):
    p = tmp_path / "mod.py"
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    ctxs = contexts([str(p)], root=tmp_path)
    return program(ctxs), flow(ctxs)


def test_dataflow_twins_cover_every_jax_case():
    assert sorted(DATAFLOW) == _case_names("test_staging_analysis.py",
                                           "TestDataflow")


@pytest.mark.parametrize("case", sorted(DATAFLOW))
def test_dataflow_twin_classifies_as_jax(case, tmp_path):
    jax_src, torch_src, reads, want = DATAFLOW[case]
    jp, jdf = _solve(tmp_path / "jax", jax_src, jax_contexts, jax_program,
                     jax_dataflow.build_dataflow)
    jax_got = [read(jp, jdf, None) for read in reads]
    pp, pdf = _solve(tmp_path / "port", torch_src, load_contexts,
                     build_program, build_dataflow)
    port_got = [read(pp, pdf, None) for read in reads]
    assert port_got == jax_got == [want] * len(reads)


# ------------------------------------------------------------------ QT013
SYNC = {
    "cast_of_helper_device_return_flagged": ("""
        import jax.numpy as jnp

        def _scores(xs):
            return jnp.asarray(xs).sum()

        def mean(xs):
            return float(_scores(xs))
    """, """
        import torch

        def _scores(xs):
            return torch.as_tensor(xs, device="cuda").sum()

        def mean(xs):
            return float(_scores(xs))
    """, "mod.py", ["QT013"]),
    "direct_cast_stays_qt001_territory": ("""
        import jax.numpy as jnp

        def mean(xs):
            return float(jnp.asarray(xs).sum())
    """, """
        import torch

        def mean(xs):
            return float(torch.as_tensor(xs, device="cuda").sum())
    """, "mod.py", ["QT001"]),
    "cold_module_origin_not_flagged": ("""
        import jax.numpy as jnp

        def _scores(xs):
            return jnp.asarray(xs).sum()

        def mean(xs):
            return float(_scores(xs))
    """, """
        import torch

        def _scores(xs):
            return torch.as_tensor(xs, device="cuda").sum()

        def mean(xs):
            return float(_scores(xs))
    """, "cold.py", []),
    "implicit_bool_coercion_flagged": ("""
        import jax.numpy as jnp

        def _mask(xs):
            return jnp.asarray(xs) > 0

        def any_hit(xs):
            if _mask(xs).any():
                return True
            return False
    """, """
        import torch

        def _mask(xs):
            return torch.as_tensor(xs, device="cuda") > 0

        def any_hit(xs):
            if _mask(xs).any():
                return True
            return False
    """, "mod.py", ["QT013"]),
    "sync_ok_waiver_suppresses": ("""
        import jax.numpy as jnp

        def _scores(xs):
            return jnp.asarray(xs).sum()

        def mean(xs):
            # quiverlint: sync-ok[epoch boundary readback]
            return float(_scores(xs))
    """, """
        import torch

        def _scores(xs):
            return torch.as_tensor(xs, device="cuda").sum()

        def mean(xs):
            # quiverlint: sync-ok[epoch boundary readback]
            return float(_scores(xs))
    """, "mod.py", []),
    "stale_sync_ok_reported": ("""
        def mean(xs):
            # quiverlint: sync-ok[nothing here syncs anymore]
            return float(sum(xs))
    """, """
        def mean(xs):
            # quiverlint: sync-ok[nothing here syncs anymore]
            return float(sum(xs))
    """, "mod.py", []),
    "directive_in_string_is_not_a_waiver": ('''
        def helper():
            """Waive with `# quiverlint: sync-ok[reason]`."""
            return 1
    ''', '''
        def helper():
            """Waive with `# quiverlint: sync-ok[reason]`."""
            return 1
    ''', "mod.py", []),
}


def test_sync_twins_cover_every_jax_case():
    assert sorted(SYNC) == _case_names("test_staging_analysis.py",
                                       "TestInterproceduralSync")


@pytest.mark.parametrize("case", sorted(SYNC))
def test_sync_twin_is_flagged_where_jax_flags(case, tmp_path):
    jax_src, torch_src, name, rules = SYNC[case]
    jax, port = twin(tmp_path, jax_src, torch_src, name, cfg=FIXTURE_CFG)
    assert sorted(f.rule for f in port.findings) == rules
    if case == "sync_ok_waiver_suppresses":
        assert [f.rule for f in port.suppressed] == ["QT013"]
        assert port.stale_sync_ok == []
    if case == "stale_sync_ok_reported":
        assert [(ln, r) for _, ln, r in port.stale_sync_ok] == [
            (3, "nothing here syncs anymore")]


# ------------------------------------------------------------------ QT015
COLLECTIVES = {
    "float_psum_in_bitexact_module_flagged": ("""
        import jax
        from jax.sharding import Mesh

        AXIS = "shard"

        def _combine(x):
            return jax.lax.psum(x, AXIS)

        def run(x, devices):
            mesh = Mesh(devices, (AXIS,))
            with mesh:
                return jax.pmap(_combine, axis_name=AXIS)(x)
    """, """
        from quiver_tpu_torch.dist.comm import psum
        from quiver_tpu_torch.utils.mesh import Mesh

        AXIS = "shard"

        def _combine(x):
            return psum(x)

        def run(x, devices):
            mesh = Mesh(devices, (AXIS,))
            parts = [x.to(d) for d in mesh.axis_devices(AXIS)]
            return _combine(parts)
    """, "mod.py", ["QT015"]),
    "int_psum_and_pmax_clean": ("""
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh

        AXIS = "shard"

        def _combine(x, mask):
            payload = jax.lax.pmax(x, AXIS)
            count = jax.lax.psum(mask.astype(jnp.int32), AXIS)
            return payload, count

        def run(x, mask, devices):
            mesh = Mesh(devices, (AXIS,))
            with mesh:
                return jax.pmap(_combine, axis_name=AXIS)(x, mask)
    """, """
        import torch
        from quiver_tpu_torch.dist.comm import pmax, psum
        from quiver_tpu_torch.utils.mesh import Mesh

        AXIS = "shard"

        def _combine(x, mask):
            payload = pmax(x)
            count = psum([m.to(torch.int32) for m in mask])
            return payload, count

        def run(x, mask, devices):
            mesh = Mesh(devices, (AXIS,))
            devs = mesh.axis_devices(AXIS)
            return _combine([t.to(d) for t, d in zip(x, devs)], mask)
    """, "mod.py", []),
    "undeclared_axis_name_flagged": ("""
        import jax
        from jax.sharding import Mesh

        def _combine(x):
            return jax.lax.pmax(x, "sahrd")

        def run(x, devices):
            mesh = Mesh(devices, ("shard",))
            with mesh:
                return jax.pmap(_combine, axis_name="shard")(x)
    """, """
        from quiver_tpu_torch.dist.comm import pmax
        from quiver_tpu_torch.utils.mesh import Mesh

        def _combine(x, mesh):
            return pmax([x.to(d) for d in mesh.axis_devices("sahrd")])

        def run(x, devices):
            mesh = Mesh(devices, ("shard",))
            parts = _combine(x, mesh)
            return parts
    """, "cold.py", ["QT015"]),
    "float_psum_outside_bitexact_scope_allowed": ("""
        import jax
        from jax.sharding import Mesh

        def _combine(x):
            return jax.lax.psum(x, "shard")

        def run(x, devices):
            mesh = Mesh(devices, ("shard",))
            with mesh:
                return jax.pmap(_combine, axis_name="shard")(x)
    """, """
        from quiver_tpu_torch.dist.comm import psum
        from quiver_tpu_torch.utils.mesh import Mesh

        def _combine(x):
            return psum(x)

        def run(x, devices):
            mesh = Mesh(devices, ("shard",))
            parts = [x.to(d) for d in mesh.axis_devices("shard")]
            return _combine(parts)
    """, "cold.py", []),
}


def test_collective_twins_cover_every_jax_case():
    assert sorted(COLLECTIVES) == _case_names("test_staging_analysis.py",
                                              "TestCollectiveDiscipline")


@pytest.mark.parametrize("case", sorted(COLLECTIVES))
def test_collective_twin_is_flagged_where_jax_flags(case, tmp_path):
    jax_src, torch_src, name, rules = COLLECTIVES[case]
    _, port = twin(tmp_path, jax_src, torch_src, name, cfg=FIXTURE_CFG)
    assert sorted(f.rule for f in port.findings) == rules
    if case == "undeclared_axis_name_flagged":
        assert "sahrd" in port.findings[0].message


# the port's own collective cases: (file, source, flagged lines)
TORCH_COLLECTIVES = {
    "proven_integer_parts": ("mod.py", """
        import torch
        from quiver_tpu_torch.dist.comm import psum

        def combine(outs, masks, dev):
            a = psum([o[2].to(torch.int32) for o in outs], dev)
            b = psum([m.int() for m in masks])
            c = psum([m.long() + 1 for m in masks])
            d = psum([torch.zeros(3, dtype=torch.int64), masks[0] > 0])
            e = psum((o.sum(1).to(dtype=torch.int32) for o in outs))
            return a, b, c, d, e
    """, []),
    "float_parts": ("mod.py", """
        import torch
        from quiver_tpu_torch.dist.comm import psum

        def combine(outs, dev):
            a = psum([o[2] for o in outs], dev)
            b = psum([o.float() for o in outs])
            c = psum([o.to(torch.float32) for o in outs])
            return a, b, c
    """, [6, 7, 8]),
    "function_local_import_and_reexport": ("mod.py", """
        from quiver_tpu_torch import dist

        def combine(outs):
            from quiver_tpu_torch.dist.comm import psum
            return psum(outs), dist.psum(outs)
    """, [6, 6]),
    "shape_polymorphic_operands": ("cold.py", """
        import torch
        from quiver_tpu_torch.dist.comm import all_to_all, ppermute

        def exchange(parts, ring):
            a = all_to_all([p.nonzero() for p in parts])
            b = ppermute([p[p > 0] for p in parts], ring)
            c = all_to_all([torch.unique(p) for p in parts])
            return a, b, c, all_to_all(parts)
    """, [6, 7, 8]),
    "axis_accessors_resolve_constants_and_defaults": ("cold.py", """
        from quiver_tpu_torch.utils.mesh import Mesh, make_mesh

        DATA = "data"

        class Sharded:
            def __init__(self, mesh, axis: str = "shrad"):
                self.axis = DATA
                self.devices = mesh.axis_devices(self.axis)
                self.n = int(mesh.shape[axis])

        def build(devs):
            return make_mesh((DATA, "shard"), devices=devs)

        def row_shard(mesh, axis="shard"):
            return mesh.axis_devices(axis), row_shard(mesh, "dat")
    """, [10, 16]),
}


@pytest.mark.parametrize("case", sorted(TORCH_COLLECTIVES))
def test_collective_torch_cases(case, tmp_path):
    name, src, lines = TORCH_COLLECTIVES[case]
    r = _lint(analyze_paths, LintConfig(rules=("QT015",),
                                        **FIXTURE_CFG), tmp_path, src, name)
    assert [f.line for f in r.findings] == lines, [
        f.format() for f in r.findings]


# ------------------------------------------------------- fixture packages
# JAX's on-disk packages, each rewritten into torch line for line
_TORCH_LINES = {
    "sync": [("import jax.numpy as jnp", "import torch"),
             ("jnp.asarray(xs)", 'torch.as_tensor(xs, device="cuda")')],
    "psum": [("import jax.numpy as jnp\n", "import torch\n"),
             ("import jax\n",
              "from quiver_tpu_torch.dist.comm import pmax, psum\n"),
             ("from jax.sharding import Mesh",
              "from quiver_tpu_torch.utils.mesh import Mesh"),
             ("jax.lax.pmax(x, AXIS)", "pmax(x)"),
             ("jax.lax.psum(mask.astype(jnp.int32), AXIS)",
              "psum([m.to(torch.int32) for m in mask])"),
             ("jax.lax.psum(x, AXIS)", "psum(x)"),
             ("    with mesh:\n", "    devs = mesh.axis_devices(AXIS)\n"),
             ("        return jax.pmap(_combine, axis_name=AXIS)(x, mask)",
              "    return _combine([t.to(d) for t, d in zip(x, devs)], "
              "mask)"),
             ("        return jax.pmap(_combine, axis_name=AXIS)(x)",
              "    return _combine([x.to(d) for d in devs])")],
}


def _torch_package(pkg: str, root: Path) -> Path:
    out = root / pkg
    out.mkdir(parents=True)
    for src in sorted((FIXTURES / pkg).glob("*.py")):
        text = src.read_text()
        for old, new in _TORCH_LINES[pkg.split("_")[0]]:
            text = text.replace(old, new)
        assert "jax" not in text.split('"""', 2)[-1], text
        (out / src.name).write_text(text)
    return out


@pytest.mark.parametrize("pkg, expected", [
    ("sync_seeded", ["QT013"]), ("sync_clean", []),
    ("psum_seeded", ["QT015"]), ("psum_clean", [])])
def test_fixture_package_twins(pkg, expected, tmp_path):
    jax = jax_lint.analyze_paths([str(FIXTURES / pkg)],
                                 config=jax_lint.LintConfig(**FIXTURE_CFG),
                                 root=FIXTURES)
    port = analyze_paths([str(_torch_package(pkg, tmp_path))],
                         config=LintConfig(**FIXTURE_CFG), root=tmp_path)
    assert port.errors == [] and jax.errors == []
    assert [(f.rule, f.path, f.line) for f in port.findings] == [
        (f.rule, f.path, f.line) for f in jax.findings]
    assert sorted(f.rule for f in port.findings) == expected
    assert [f.rule for f in port.suppressed] == [f.rule
                                                 for f in jax.suppressed]
    assert port.stale_sync_ok == jax.stale_sync_ok == []


# --------------------------------------------------------- sync_ok() parity
SYNC_OK_SOURCES = {
    "same_line": """
        x = float(y)  # quiverlint: sync-ok[response boundary]
    """,
    "comment_block_above": """
        def f(y):
            # quiverlint: sync-ok[epoch boundary: one readback per epoch]
            # (the reason may run on)
            # over several comment lines
            return float(y)
    """,
    "inside_strings": '''
        def f():
            """Waive with `# quiverlint: sync-ok[reason]`."""
            msg = "# quiverlint: sync-ok[not a waiver]"
            return msg  # quiverlint: sync-ok[a real one]
    ''',
    "stale_and_two_on_a_line": """
        def f(y):
            # quiverlint: sync-ok[left behind after a refactor]
            return sum(y)

        z = 1  # quiverlint: ignore[QT001] -- quiverlint: sync-ok[both]
    """,
    "next_to_an_ignore": """
        def f(r):
            # quiverlint: ignore[QT001] -- sample_sub answers numpy
            # quiverlint: sync-ok[host subgraph export]
            return r.n_id[: int(r.num_nodes)].cpu().numpy()
    """,
    "untokenizable_falls_back_to_lines": """
        s = '''unterminated
        # quiverlint: sync-ok[seen by the line scan]
    """,
}


@pytest.mark.parametrize("case", sorted(SYNC_OK_SOURCES))
def test_sync_ok_is_the_jax_parser(case, tmp_path):
    source = textwrap.dedent(SYNC_OK_SOURCES[case])
    # untokenizable text: the directive is still read line by line (the
    # contexts parse the terminated text; the scan reads the open one)
    p = tmp_path / "mod.py"
    parsed = source
    if case == "untokenizable_falls_back_to_lines":
        parsed = source + "'''\n"
    jax = JaxContext(p, "mod.py", parsed, jax_lint.LintConfig())
    port = ModuleContext(p, "mod.py", parsed, LintConfig())
    for ctx in (jax, port):        # the text the directive scan reads
        ctx.source, ctx.lines = source, source.splitlines()
    assert port.sync_ok() == jax.sync_ok()
    assert "not a waiver" not in json.dumps(port.sync_ok())
    if case != "inside_strings":
        assert port.sync_ok()


# ------------------------------------------------ the port's own sources
def _port_tree(root: Path, files: dict) -> Path:
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return root


# a kernel wrapper module (counts its launches through a helper), a
# hot module and a cold one
SOURCES_TREE = {
    "quiver_tpu_torch/__init__.py": "",
    "quiver_tpu_torch/ops/__init__.py": "",
    "quiver_tpu_torch/ops/cuda/__init__.py": "",
    "quiver_tpu_torch/ops/cuda/k.py": """
        def _launch(x):
            k.launches += 1
            return x

        def k_plain(x):
            return x

        def k(x):
            if x.device.type == "cpu":
                return k_plain(x)
            return _launch(x)

        k.launches = 0
    """,
    "quiver_tpu_torch/feature.py": """
        import numpy as np
        import torch

        def on_card(n, dev):
            return torch.zeros(n, device=dev)

        def on_cpu(n):
            return torch.zeros(n, device="cpu")

        def moved(a):
            return torch.from_numpy(a).cuda()

        def moved_to(a, dev):
            return torch.from_numpy(a).to(dev, non_blocking=True)

        def staged(a):
            return torch.from_numpy(a), torch.tensor([1, 2]), np.ones(3)
    """,
    "quiver_tpu_torch/models/use.py": """
        import torch

        from ..feature import moved, moved_to, on_card, on_cpu, staged
        from ..ops.cuda.k import k, k_plain

        def kernel_result(x):
            y = k(x)
            return int(y.sum()), y.cpu()

        def plain_result(x):
            return int(k_plain(x).sum())

        def device_kw(n, dev):
            return float(on_card(n, dev).sum()), bool(on_cpu(n).any())

        def cuda_and_to(a, dev):
            return moved(a).tolist(), moved_to(a, dev).to("cpu")

        def host_sources(a):
            t, u, v = staged(a)
            h = on_card(3, "cuda").cpu()
            return int(t.sum()), u.tolist(), float(v.sum()), h.item()

        def annotated(x: torch.Tensor, n: int):
            return int(x.sum()), x.cpu(), n

        def card_operand(a, dev):
            z = torch.cat([torch.from_numpy(a), on_card(3, dev)])
            return z.item(), torch.from_numpy(a).long().item()

        def containers(n, dev):
            d, xs, t = {}, [], on_card(n, dev)
            d["a"] = on_card(n, dev)
            xs.append(on_card(n, dev))
            t[0] = 0
            return int(d["a"].sum()), float(xs[0].sum()), bool(t.any())

        def positions(n, dev):
            a, b = on_card(n, dev), 3
            pair = (n, on_card(n, dev))
            return int(a.sum()), int(b), int(pair[0]), int(pair[1].sum())
    """,
}


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    root = _port_tree(tmp_path_factory.mktemp("sources"), SOURCES_TREE)
    result = analyze_paths(["quiver_tpu_torch"], root=root)
    ctxs = load_contexts(["quiver_tpu_torch"], root=root)
    return result, build_dataflow(ctxs)


@pytest.mark.parametrize("fn, lines", [
    ("kernel_result", [9, 9]),       # a kernel entry's result: DEVICE
    ("plain_result", []),            # the plain version names no device
    ("device_kw", [15]),             # device= not the CPU; "cpu" is host
    ("cuda_and_to", [18, 18]),       # .cuda(), .to(dev): DEVICE
    ("host_sources", [22]),          # the .cpu() itself; then host
    ("annotated", []),               # a tensor annotation names no device
    ("card_operand", [30]),          # a card operand makes a card result
    ("containers", [37, 37, 37]),    # stored, appended; t[0] = 0 keeps t
    ("positions", [42, 42]),         # each tuple position its own value
])
def test_port_sources_are_flagged_where_they_reach(sources, fn, lines):
    result, _ = sources
    got = [f.line for f in result.findings
           if f.rule == "QT013" and f.scope == fn]
    assert got == lines, [f.format() for f in result.findings]


def test_port_sources_classify(sources):
    _, df = sources
    key = "quiver_tpu_torch.models.use"

    def cls(fn, expr):
        v = df.classify(df.prog.functions[f"{key}:{fn}"],
                        ast.parse(expr).body[0].value)
        return v.cls if v else None

    assert sorted(df.kernel_entries) == ["quiver_tpu_torch.ops.cuda.k:k"]
    assert cls("kernel_result", "k(x)") == DEVICE
    assert df.ret["quiver_tpu_torch.feature:on_card"].cls == DEVICE
    assert df.ret["quiver_tpu_torch.feature:on_card"].hot
    assert df.ret["quiver_tpu_torch.feature:on_cpu"].cls == HOST
    assert df.ret["quiver_tpu_torch.feature:moved"].cls == DEVICE
    assert df.ret["quiver_tpu_torch.feature:moved_to"].cls == DEVICE
    assert df.ret["quiver_tpu_torch.feature:staged"].elts is not None
    assert [v.cls for v in df.ret["quiver_tpu_torch.feature:staged"].elts
            ] == [HOST, HOST, HOST]
    assert cls("host_sources", "on_card(3, 'cuda').cpu()") == HOST
    assert cls("annotated", "x") not in (DEVICE, HOST)
    assert cls("card_operand", "torch.from_numpy(a).long()") == HOST


def test_qt001_and_qt013_never_report_one_line(tmp_path):
    """Every coercion shape in a hot module and in a cold one: each
    flagged line carries one code."""
    root = _port_tree(tmp_path, {
        "quiver_tpu_torch/__init__.py": "",
        "quiver_tpu_torch/serving.py": """
            import numpy as np
            import torch

            def _logits(n, dev):
                return torch.ones(n, device=dev)

            def answer(n, dev):
                out = _logits(n, dev)
                loc = torch.ones(n, device=dev)
                a = out.cpu()
                b = int(out.sum())
                c = out.to("cpu")
                d = int(loc.sum())
                e = np.asarray(out.cpu())
                f = float(_logits(n, dev).max().item())
                if out.any():
                    pass
                return a, b, c, d, e, f, out.tolist(), loc.tolist()
        """,
        "quiver_tpu_torch/pipeline.py": """
            from .serving import _logits

            def consume(n, dev):
                out = _logits(n, dev)
                return out.cpu(), int(out.sum()), out.to("cpu")
        """,
    })
    result = analyze_paths(["quiver_tpu_torch"], root=root)
    by_line = {}
    for f in result.findings:
        by_line.setdefault((f.path, f.line), set()).add(f.rule)
    assert all(len(rules) == 1 for rules in by_line.values()), by_line
    rules = {r for rs in by_line.values() for r in rs}
    assert rules == {"QT001", "QT013"}
    hot = {ln: rs for (p, ln), rs in by_line.items() if "serving" in p}
    # line 19 holds a QT013 coercion (out) and a QT001 one (loc): the
    # line is QT001's
    assert hot == {11: {"QT001"}, 12: {"QT013"}, 13: {"QT001"},
                   14: {"QT001"}, 15: {"QT001"}, 16: {"QT013"},
                   17: {"QT013"}, 19: {"QT001"}}, hot
    cold = sorted(ln for (p, ln) in by_line if "pipeline" in p)
    assert cold == [6]
    assert len([f for f in result.findings
                if "pipeline" in f.path]) == 3


def test_stale_sync_ok_fails_the_cli_only_under_strict(tmp_path, capsys):
    root = _port_tree(tmp_path, {
        "quiver_tpu_torch/sampler.py": """
            def _nothing_syncs_here(xs):
                # quiverlint: sync-ok[left behind after a refactor]
                return sum(xs)
        """})
    args = ["quiver_tpu_torch", "--root", str(root), "--no-baseline"]
    assert lint_main(args) == 0
    capsys.readouterr()
    assert lint_main(args + ["--strict-baseline"]) == 1
    out = capsys.readouterr().out
    assert "stale sync-ok waiver (suppresses nothing): " \
           "quiver_tpu_torch/sampler.py:3 [left behind after a refactor]" \
           in out
    assert lint_main(args + ["--strict-baseline", "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["stale_sync_ok"] == [{
        "path": "quiver_tpu_torch/sampler.py", "line": 3,
        "reason": "left behind after a refactor"}]
    # the audit runs only with QT013 in the rule set
    assert lint_main(args + ["--strict-baseline", "--rules", "QT001"]) == 0


def test_defaults_hold_the_port_as_jax_holds_jax():
    """The configuration fields the three rules read keep JAX's shape,
    on the port's paths."""
    jax_cfg = dataclasses.asdict(jax_lint.LintConfig())
    port_cfg = dataclasses.asdict(LintConfig())
    assert set(port_cfg) == set(jax_cfg)
    assert port_cfg["bitexact_modules"] == tuple(
        p.replace("quiver_tpu/", "quiver_tpu_torch/")
        for p in jax_cfg["bitexact_modules"])
