"""The port stands alone: it imports no JAX and nothing of ``quiver_tpu``,
and its entry points default to the CUDA card, raising where there is
none instead of running on the CPU."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import quiver_tpu_torch as qt

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN or top == "quiver_tpu"


def _port_files():
    files = sorted((ROOT / "quiver_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "walk_sweep.py",
                    ROOT / "pipeline_compare.py", ROOT / "b2_sweep.py"]


# the JAX package named as a word ("quiver_tpu", "quiver_tpu/cpp", but not
# "quiver_tpu_torch"), and the one form a port string may take: a
# ``file.py:line`` citation of a TPU kernel, which nothing opens
_JAX_PKG = re.compile(r"(?<![\w])quiver_tpu(?![\w])")
_CITATION = re.compile(r"^quiver_tpu/[\w/]+\.py:\d+$")


def _strings_into_jax_package(source: str, name: str = "<src>"):
    """Every string constant of ``source`` but docstrings that names the
    JAX package (a path or module string: a build reading its sources is
    an import by another name), citations excepted."""
    tree = ast.parse(source, filename=name)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)):
                docs.add(id(first.value))
    return [f"{name}:{node.lineno} {node.value[:80]!r}"
            for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs and _JAX_PKG.search(node.value)
            and not _CITATION.match(node.value)]


def test_import_leaves_jax_out():
    code = ("import sys, quiver_tpu_torch, quiver_tpu_torch.ops.cuda.build; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r} or m.split('.')[0] == 'quiver_tpu']; "
            "print(bad)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_forbidden_imports_in_source():
    assert (ROOT / "chip_smoke.py").exists()
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_walk_covers_the_budgeted_store():
    """The source walk reaches the feature-store modules, including the
    port's own copy of the numpy-only ``ColdRowCache``."""
    walked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for mod in ("config.py", "feature.py", "ops/coldcache.py",
                "ops/paged.py", "ops/cuda/page_gather.py",
                "utils/staging.py"):
        assert f"quiver_tpu_torch/{mod}" in walked, mod
    from quiver_tpu_torch.ops import coldcache, paged

    assert coldcache.ColdRowCache.__module__.startswith("quiver_tpu_torch")
    assert paged.ColdRowCache is coldcache.ColdRowCache


def test_walk_covers_the_training_slice():
    """The source walk and the subprocess import reach the training slice:
    the gather modes with kernels B3 and B4, the train step, the loader,
    the prefetcher (with the port's own ``join_and_reap``) and the fused
    pipeline."""
    walked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    mods = ("ops/fastgather.py", "ops/cuda/element_gather.py",
            "ops/cuda/lane_select.py", "parallel/train.py",
            "parallel/prefetch.py", "loader.py", "pipeline.py",
            "utils/shutdown.py", "utils/synthetic.py")
    for mod in mods:
        assert f"quiver_tpu_torch/{mod}" in walked, mod
    names = ", ".join("quiver_tpu_torch." + m[:-3].replace("/", ".")
                      for m in mods)
    code = (f"import sys, {names}; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r} or m.split('.')[0] == 'quiver_tpu'])")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    from quiver_tpu_torch.parallel import prefetch
    from quiver_tpu_torch.utils import shutdown

    assert prefetch.join_and_reap is shutdown.join_and_reap


def test_walk_covers_the_sampler_surface():
    """The source walk and the subprocess import reach the modules of
    exact dedup, the weighted sampler and the blocked gather."""
    walked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    mods = ("ops/blockgather.py", "ops/reindex.py", "ops/prob.py",
            "ops/sample.py", "sampler.py", "config.py")
    for mod in mods:
        assert f"quiver_tpu_torch/{mod}" in walked, mod
    names = ", ".join("quiver_tpu_torch." + m[:-3].replace("/", ".")
                      for m in mods)
    code = (f"import sys, {names}; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r} or m.split('.')[0] == 'quiver_tpu'])")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_matcher():
    assert _forbidden("quiver_tpu") and _forbidden("quiver_tpu.ops.sample")
    assert _forbidden("jax.numpy") and _forbidden("flax.linen")
    assert not _forbidden("quiver_tpu_torch.ops")
    assert not _forbidden("quiver_tpu_torch")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = qt.CSRTopo(indptr=np.array([0, 1, 2]), indices=np.array([1, 0]))
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.GraphSageSampler(topo, [2])
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.Feature()
    with pytest.raises(RuntimeError, match="CUDA"):
        topo.to_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.sample_neighbors(torch.zeros(128, dtype=torch.int32),
                            torch.zeros(128, dtype=torch.int32),
                            torch.zeros(2, dtype=torch.int32), 2, (1, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.parallel.AsyncNeighborSampler(topo, 2)


def test_walk_covers_the_model_families():
    """The source walk and the subprocess import reach GAT, GCN, R-GAT,
    exact inference and the hetero sampler."""
    walked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    mods = ("hetero.py", "models/layers.py", "models/gat.py",
            "models/gcn.py", "models/rgat.py", "models/inference.py",
            "models/convert.py")
    for mod in mods:
        assert f"quiver_tpu_torch/{mod}" in walked, mod
    names = ", ".join("quiver_tpu_torch." + m[:-3].replace("/", ".")
                      for m in mods)
    code = (f"import sys, {names}; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r} or m.split('.')[0] == 'quiver_tpu'])")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_model_families_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rel = ("a", "r", "a")
    topo = qt.HeteroCSRTopo(
        {rel: qt.CSRTopo(indptr=np.array([0, 1, 2]),
                         indices=np.array([1, 0]))}, {"a": 2})
    for make in (lambda: qt.GATConv(4, 4), lambda: qt.GAT(4, 4, 2),
                 lambda: qt.GCNConv(4, 4), lambda: qt.GCN(4, 4, 2),
                 lambda: qt.RGAT({"a": 4}, 4, 2, 1, [[rel]]),
                 lambda: qt.HeteroGraphSageSampler(topo, 2, num_hops=1,
                                                   seed_type="a"),
                 lambda: qt.HeteroFeature.from_cpu_tensors(
                     {"a": np.zeros((2, 3), np.float32)}),
                 lambda: qt.full_graph_inference(
                     qt.GCN(3, 4, 2, device="cpu"), None,
                     np.zeros((2, 3), np.float32), np.array([0, 1, 2]),
                     np.array([1, 0]))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_graphsage_defaults_to_the_card(monkeypatch):
    """``GraphSAGE`` and ``SAGEConv`` resolve their device as the other
    families do: the card by default, raising where there is none; the
    CPU only when named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: qt.SAGEConv(4, 4), lambda: qt.GraphSAGE(4, 4, 2),
                 lambda: qt.GraphSAGE(4, 4, 2, edge_dim=3)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    model = qt.GraphSAGE(4, 8, 2, num_layers=2, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_no_strings_point_into_the_jax_package():
    bad = []
    for path in _port_files():
        bad += _strings_into_jax_package(path.read_text(), path.name)
    assert not bad, bad


def test_jax_package_string_matcher():
    src = ('"""Counterpart of ``quiver_tpu/cpp/native.py``."""\n'
           'A = ROOT / "quiver_tpu" / "cpp" / "csrc"\n'
           'B = "quiver_tpu/cpp/csrc/quiver_cpu.cpp"\n'
           'C = f"{ROOT}/quiver_tpu/cpp"\n'
           'D = "quiver_tpu.cpp.native"\n'
           'E = "quiver_tpu/ops/pallas/gather_kernel.py:63"\n'
           'F = "quiver_tpu_torch/cpp/csrc"\n'
           'def f():\n    """reads quiver_tpu/serving.py"""\n')
    found = _strings_into_jax_package(src)
    assert sorted(f.split()[0] for f in found) == [
        "<src>:2", "<src>:3", "<src>:4", "<src>:5"], found


def test_native_source_is_the_jax_copy():
    """The port builds its own copy of the host sampler's source, byte for
    byte the JAX package's, so a later change to either one shows here."""
    from quiver_tpu_torch.cpp import native

    port = ROOT / "quiver_tpu_torch" / "cpp" / "csrc" / "quiver_cpu.cpp"
    assert native.SRC == port.resolve()
    assert port.read_bytes() == (
        ROOT / "quiver_tpu" / "cpp" / "csrc" / "quiver_cpu.cpp").read_bytes()


def test_walk_covers_the_host_sampler_slice():
    """The source walk and the subprocess import reach the host sampler,
    UVA, the CPU lane, the mixed sampler, interop, partitioning and the
    process hand-off."""
    walked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    mods = ("cpp/native.py", "uva.py", "neighbour_num.py", "mixed.py",
            "serving.py", "interop.py", "partition.py",
            "multiprocessing/reductions.py")
    for mod in mods:
        assert f"quiver_tpu_torch/{mod}" in walked, mod
    assert "b2_sweep.py" in walked
    names = ", ".join("quiver_tpu_torch." + m[:-3].replace("/", ".")
                      for m in mods)
    code = (f"import sys, {names}; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r} or m.split('.')[0] == 'quiver_tpu'])")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_host_slice_defaults_to_the_card(monkeypatch):
    """The new entry points resolve their device as the others do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = qt.CSRTopo(indptr=np.array([0, 1, 2]), indices=np.array([1, 0]))
    for make in (lambda: qt.GraphSageSampler(topo, [2], mode="CPU"),
                 lambda: qt.GraphSageSampler(topo, [2], mode="UVA",
                                             uva_budget=4),
                 lambda: qt.UVAGraph(topo, 4),
                 lambda: qt.generate_neighbour_num(topo, [2]),
                 lambda: qt.MixedGraphSageSampler(topo, [2], None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_walk_covers_the_safeguards_slice():
    """The source walk and the subprocess import reach serving's
    safeguards and telemetry (every module of ``resilience/`` and
    ``telemetry/``) and the last utilities (trace, rng, checkpoint); no
    string of theirs points into the JAX package."""
    walked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    mods = tuple(
        f"{pkg}/{name}.py" for pkg, names in (
            ("resilience", ("__init__", "errors", "retry", "deadline",
                            "lanes", "breaker", "chaos", "shutdown", "qos")),
            ("telemetry", ("__init__", "registry", "noop", "spans",
                           "flightrec", "timeline", "slo", "export",
                           "profile")),
            ("utils", ("trace", "rng", "checkpoint", "shutdown")))
        for name in names)
    bad = []
    for mod in mods:
        assert f"quiver_tpu_torch/{mod}" in walked, mod
        path = ROOT / "quiver_tpu_torch" / mod
        bad += _strings_into_jax_package(path.read_text(), mod)
    assert not bad, bad
    names = ", ".join("quiver_tpu_torch." + m[:-3].replace("/", ".")
                      .replace(".__init__", "") for m in mods)
    code = (f"import sys, {names}; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r} or m.split('.')[0] == 'quiver_tpu'])")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_walk_covers_the_streaming_slice():
    """The source walk and the subprocess import reach every module of
    ``stream/`` and ``recovery/`` (and the CRC-32C source, a file of the
    port); no string of theirs points into the JAX package, and the
    copies of the JAX package's numpy-only modules are the port's own."""
    walked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    mods = tuple(
        f"{pkg}/{name}.py" for pkg, names in (
            ("stream", ("__init__", "delta", "graph", "compactor",
                        "ingest")),
            ("recovery", ("__init__", "errors", "registry", "blockio", "wal",
                          "checkpoint", "manager")))
        for name in names)
    bad = []
    for mod in mods:
        assert f"quiver_tpu_torch/{mod}" in walked, mod
        path = ROOT / "quiver_tpu_torch" / mod
        bad += _strings_into_jax_package(path.read_text(), mod)
    assert not bad, bad
    assert (ROOT / "quiver_tpu_torch" / "cpp" / "csrc" / "crc32c.cpp").exists()
    names = ", ".join("quiver_tpu_torch." + m[:-3].replace("/", ".")
                      .replace(".__init__", "") for m in mods)
    code = (f"import sys, {names}; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r} or m.split('.')[0] == 'quiver_tpu'])")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    from quiver_tpu_torch.recovery import blockio, wal
    from quiver_tpu_torch.stream import delta

    for mod in (delta, blockio, wal):
        assert mod.__name__.startswith("quiver_tpu_torch.")


def test_streaming_entry_points_default_to_the_card(monkeypatch):
    """A streaming graph is host state; its snapshot and a sampler over it
    resolve their device as every entry point does."""
    from quiver_tpu_torch.stream import StreamingGraph

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = qt.CSRTopo(indptr=np.array([0, 1, 2]), indices=np.array([1, 0]))
    g = StreamingGraph(topo)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            g.snapshot()
        with pytest.raises(RuntimeError, match="CUDA"):
            qt.GraphSageSampler(g, [2])
        assert g.snapshot("cpu").tomb.device.type == "cpu"
    finally:
        g.close()


def test_walk_covers_the_sharding_slice():
    """The source walk and the subprocess import reach every module of
    ``mesh/``, ``dist/``, ``utils/mesh.py`` and ``recovery/shardwal.py``;
    none names the JAX package in a string, and importing them loads no
    JAX."""
    walked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    mods = tuple(
        f"{pkg}/{name}.py" for pkg, names in (
            ("mesh", ("__init__", "topology", "feature", "sampler")),
            ("dist", ("__init__", "comm", "buckets", "init", "feature",
                      "sampler", "ring", "hier", "e2e")),
            ("utils", ("mesh",)), ("recovery", ("shardwal",)))
        for name in names)
    bad = []
    for mod in mods:
        assert f"quiver_tpu_torch/{mod}" in walked, mod
        path = ROOT / "quiver_tpu_torch" / mod
        bad += _strings_into_jax_package(path.read_text(), mod)
    assert not bad, bad
    names = ", ".join("quiver_tpu_torch." + m[:-3].replace("/", ".")
                      .replace(".__init__", "") for m in mods)
    code = (f"import sys, {names}; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r} or m.split('.')[0] == 'quiver_tpu'])")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    from quiver_tpu_torch.recovery import shardwal

    assert shardwal.__name__.startswith("quiver_tpu_torch.")


def test_sharding_entry_points_default_to_the_card(monkeypatch):
    """Meshes default to the cards, so every sharded structure built
    without CPU devices raises where there is no card; a CPU mesh runs."""
    from quiver_tpu_torch.mesh import MeshFeature, MeshSampler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = np.zeros((8, 2), np.float32)
    for make in (lambda: qt.make_mesh(("data",)),
                 lambda: qt.make_hybrid_mesh(),
                 lambda: qt.MeshTopo(),
                 lambda: MeshFeature(table, n_shards=2),
                 lambda: MeshSampler(np.array([0, 1, 2]), np.array([1, 0]),
                                     n_shards=2),
                 lambda: qt.Feature(cache_policy="ici_shard")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    cpu = qt.make_mesh(("shard",), devices=[torch.device("cpu")] * 2)
    assert MeshFeature(table, n_shards=2, mesh=cpu)[[0, 7]].shape == (2, 2)
