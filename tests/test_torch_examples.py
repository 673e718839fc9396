"""Port parity, the user entry points: the nine modules of
``quiver_tpu_torch.examples``, counterparts of the JAX package's example
scripts.

- Every example runs on the CPU through ``main([...] + ["--device",
  "cpu"])`` at the tiny sizes ``tests/test_examples.py`` gives its JAX
  script (the DGL one at ``tests/test_interop.py``'s), prints its summary
  line and ends with finite losses.
- Data parity, bitwise: the graph, features, labels, splits and first
  seed batch each example builds equal the JAX script's for the same
  flags (the products example's fallback against the JAX file's own
  ``load_dataset``; the others against ``quiver_tpu.utils.synthetic`` and
  the script's numpy lines, repeated here).
- The math that lives only in an example: the unsup pair loss and cosine
  probe against the JAX script's formulas on the same embeddings of
  carried weights (``rtol = 1e-5``), and the DGL fallback's
  ``TorchSAGEConv`` against the JAX script's class (torch in both: bit
  for bit).
- Without a card, the default ``--device cuda`` raises before anything is
  printed.
"""

import contextlib
import importlib
import importlib.util
import io
import math
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu import telemetry as jtel
from quiver_tpu.hetero import HeteroCSRTopo as JaxHeteroTopo
from quiver_tpu.models import GraphSAGE as FlaxSAGE
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.synthetic import community_graph as jax_community
from quiver_tpu.utils.synthetic import synthetic_csr as jax_synthetic_csr
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.examples import EXAMPLES
from quiver_tpu_torch.resilience import qos as pqos

ROOT = Path(__file__).resolve().parents[1]

# tests/test_examples.py's sizes for each JAX script; the DGL one is
# tests/test_interop.py::TestDGLBlocks::test_fallback_sage_learns's
ARGS = {
    "reddit_sage": ["--synthetic-nodes", "2000", "--epochs", "1",
                    "--batch-size", "128", "--cache", "5M"],
    "graph_sage_unsup": ["--nodes", "1500", "--steps", "6",
                         "--batch-size", "64"],
    "papers100M_dist": ["--nodes", "3000", "--edges", "30000", "--steps",
                        "2", "--batch-size", "8", "--dim", "8",
                        "--mesh-devices", "8"],
    "mag240m_rgat": ["--papers", "800", "--authors", "400",
                     "--institutions", "50", "--steps", "3",
                     "--batch-size", "16"],
    "preprocess_partition": ["--nodes", "2000", "--edges", "20000",
                             "--hosts", "4"],
    "serving_reddit": ["--nodes", "1500", "--edges", "15000", "--clients",
                       "2", "--requests-per-client", "4"],
    "ogbn_products_sage": ["--force-synthetic", "--synthetic-nodes", "3000",
                           "--epochs", "1", "--batch-size", "128",
                           "--cache", "10M"],
    "big_graph_single_chip": ["--nodes", "3000", "--deg", "8", "--dim", "16",
                              "--batch-size", "64", "--steps", "4",
                              "--graph-budget", "60K",
                              "--feature-budget", "100K"],
    "dgl_products_sage": ["--nodes", "3000", "--steps", "12",
                          "--batch-size", "128"],
}

# the line each example ends with (its summary), as the JAX script prints it
SUMMARY = {
    "reddit_sage": r"^epoch 0: [\d.]+s, loss [\d.]+, batch acc [\d.]+$",
    "graph_sage_unsup": (r"^intra-community cos sim -?[\d.]+ vs inter "
                         r"-?[\d.]+$"),
    "papers100M_dist": (r"^2 DP steps x 8 replicas x 8 seeds in [\d.]+s "
                        r"\(\d+ ms/step\)$"),
    "mag240m_rgat": r"^3 R-GAT steps in [\d.]+s \(\d+ ms/step\)$",
    "preprocess_partition": (r"^load_quiver_feature_partition round-trip "
                             r"OK; feed `book` to PartitionInfo"),
    "serving_reddit": r"^served 8: avg [\d.]+ms p99 [\d.]+ms \d+ rps$",
    "ogbn_products_sage": r"^full-graph val acc: [\d.]+$",
    "big_graph_single_chip": (r"^4 steps in [\d.]+s \(\d+ ms/step\), final "
                              r"loss [\d.]+$"),
    "dgl_products_sage": (r"^12 steps in [\d.]+s; loss [\d.]+ -> [\d.]+ "
                          r"\(block_specs fallback\)$"),
}
HAS_LOSSES = {"reddit_sage", "graph_sage_unsup", "papers100M_dist",
              "mag240m_rgat", "ogbn_products_sage", "big_graph_single_chip",
              "dgl_products_sage"}

_JAX_TELEMETRY_DEFAULT = jtel.enabled()


def _reset_both():
    ptel.set_enabled(True)
    ptel.reset()
    pqos.reset()
    jtel.reset()


@pytest.fixture(scope="module", autouse=True)
def _fresh_singletons():
    """Both packages' registries (the port's with its tracer, recorder,
    timeline, profile, watchdog and breakers) and the port's QoS
    controller start empty and are emptied again when the file ends;
    JAX's telemetry switch is set back."""
    _reset_both()
    yield
    _reset_both()
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


def _module(name):
    return importlib.import_module(f"quiver_tpu_torch.examples.{name}")


def _args(name, tmp=None):
    argv = list(ARGS[name])
    if name == "preprocess_partition":
        argv += ["--out", str(tmp)]
    return argv


@pytest.fixture(scope="module")
def runs(_fresh_singletons, tmp_path_factory):
    """Each example run once on the CPU: its exit status, printed lines
    and report."""
    out = {}
    for name in EXAMPLES:
        buf, report = io.StringIO(), {}
        with contextlib.redirect_stdout(buf):
            rc = _module(name).main(
                _args(name, tmp_path_factory.mktemp(name))
                + ["--device", "cpu"], report=report)
        out[name] = SimpleNamespace(rc=rc, lines=buf.getvalue().splitlines(),
                                    report=report)
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(runs, name):
    run = runs[name]
    assert run.rc == 0
    assert re.match(SUMMARY[name], run.lines[-1]), run.lines[-1]
    if name in HAS_LOSSES:
        losses = run.report["losses"]
        assert losses and all(math.isfinite(x) for x in losses)
    if name == "dgl_products_sage":
        # the example's own assert held: the loss fell
        losses = run.report["losses"]
        assert np.mean(losses[-5:]) < losses[0]
        assert run.lines[0] == "dgl available: False"
    if name == "graph_sage_unsup":
        rep = run.report
        assert math.isfinite(rep["intra"]) and math.isfinite(rep["inter"])
    if name == "serving_reddit":
        assert run.report["served"] == 8
    if name == "ogbn_products_sage":
        assert run.lines[0] == "[synthetic fallback: --force-synthetic]"
        assert "using fused on-device pipeline" in run.lines
    if name == "big_graph_single_chip":
        assert run.lines[0].startswith("uva split: {'hot_edges': ")


def test_every_example_has_a_module_and_a_readme_row():
    readme = (ROOT / "quiver_tpu_torch" / "examples" / "README.md").read_text()
    jax_scripts = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    assert sorted(EXAMPLES) == jax_scripts
    for name in EXAMPLES:
        assert f"python -m quiver_tpu_torch.examples.{name}" in readme, name
        assert callable(_module(name).main)


@pytest.mark.parametrize("name", EXAMPLES)
def test_without_a_card_the_default_device_raises(name, capsys,
                                                  monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _module(name).main(list(ARGS[name]))
    assert capsys.readouterr().out == ""


# -- data parity ---------------------------------------------------------------

def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.kind == b.dtype.kind
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a.view(np.int32), b.astype(
            a.dtype).view(np.int32))
    else:
        np.testing.assert_array_equal(a, b)


def _same_topo(port, jax_topo):
    _same(port.indptr, np.asarray(jax_topo.indptr))
    _same(port.indices, np.asarray(jax_topo.indices))
    assert port.node_count == jax_topo.node_count


def _parse(name):
    return _module(name).parse_args(_args(name, "unused")
                                    + ["--device", "cpu"])


def test_reddit_data_matches_jax(runs):
    args = _parse("reddit_sage")
    topo, feat, labels, train = _module("reddit_sage").make_data(args)
    n_cls = 41
    jtopo, jfeat, jlab = jax_community(2000, n_cls, intra_deg=30,
                                       inter_deg=10, feat_extra=602 - n_cls)
    jtrain = np.random.default_rng(0).permutation(
        jtopo.node_count)[: jtopo.node_count // 2]
    _same_topo(topo, jtopo)
    _same(feat, jfeat)
    _same(labels, jlab)
    _same(train, jtrain)
    np.random.default_rng(1).shuffle(jtrain)  # the first epoch's shuffle
    _same(runs["reddit_sage"].report["first_seeds"], jtrain[:128])


def test_products_data_matches_the_jax_load_dataset(runs):
    spec = importlib.util.spec_from_file_location(
        "_jax_ogbn_products_sage", ROOT / "examples" / "ogbn_products_sage.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        want = jmod.load_dataset("/nonexistent", synthetic_nodes=3000,
                                 force_synthetic=True)
        got = _module("ogbn_products_sage").load_dataset(
            "/nonexistent", synthetic_nodes=3000, force_synthetic=True)
    assert buf.getvalue().splitlines() == [
        "[synthetic fallback: --force-synthetic]"] * 2
    _same_topo(got[0], want[0])
    for g, w in zip(got[1:6], want[1:6]):
        _same(g, w)
    assert got[6] == want[6] == 47
    train = want[3]
    order = np.random.default_rng(1).permutation(len(train))
    _same(runs["ogbn_products_sage"].report["first_seeds"],
          train[order[:128]])


def test_products_without_files_falls_back(tmp_path, capsys):
    """No OGB file under ``--root``: the same fallback line, with the
    reason, and the synthetic arrays; nothing is fetched."""
    mod = _module("ogbn_products_sage")
    got = mod.load_dataset(str(tmp_path), synthetic_nodes=500)
    line = capsys.readouterr().out.strip()
    assert line.startswith("[synthetic fallback: no ogbn-products files "
                           f"under {tmp_path}")
    want = mod.load_dataset(str(tmp_path), synthetic_nodes=500,
                            force_synthetic=True)
    _same(got[1], want[1])
    assert list(tmp_path.iterdir()) == []


def test_products_reads_ogb_files_on_disk(tmp_path, capsys):
    """OGB's raw files under ``--root`` are read (edges symmetrized, as
    PyG's ``to_undirected``), with no fallback line."""
    import gzip

    mod = _module("ogbn_products_sage")
    rng = np.random.default_rng(4)
    n = 40
    edges = rng.integers(0, n, (120, 2))
    feat = rng.normal(size=(n, 100)).astype(np.float32)
    labels = rng.integers(0, 47, n)
    split = {"train": np.arange(20), "valid": np.arange(20, 30),
             "test": np.arange(30, 40)}
    base = tmp_path / "ogbn_products"
    rows = {"edge": edges, "feat": feat, "label": labels[:, None], **{
        k: v[:, None] for k, v in split.items()}}
    for key, rel in mod.OGB_FILES.items():
        path = base / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        with gzip.open(path, "wt") as f:
            np.savetxt(f, rows[key], delimiter=",",
                       fmt="%.9g" if key == "feat" else "%d")
    topo, x, y, tr, va, te, n_cls = mod.load_dataset(str(tmp_path))
    assert capsys.readouterr().out == "" and n_cls == 47
    want = JaxTopo(edge_index=np.stack([
        np.concatenate([edges[:, 0], edges[:, 1]]),
        np.concatenate([edges[:, 1], edges[:, 0]])]))
    _same_topo(topo, want)
    _same(x, feat)
    _same(y, labels.astype(np.int32))
    for got, k in zip((tr, va, te), ("train", "valid", "test")):
        _same(got, split[k])


@pytest.mark.parametrize("name, argv, line", [
    ("ogbn_products_sage", ["--force-synthetic", "--synthetic-nodes",
                            "3000", "--epochs", "1", "--batch-size", "128",
                            "--cache", "10M", "--dp"],
     r"^epoch 0: [\d.]+s \(11 rounds x 1 replicas x 128\), loss [\d.]+$"),
    ("papers100M_dist", ["--nodes", "3000", "--edges", "30000", "--steps",
                         "2", "--batch-size", "8", "--dim", "8",
                         "--mesh-devices", "4", "--hier", "2"],
     r"^hier: last-batch DCN crossings \d+, drops 0$"),
])
def test_data_parallel_and_hierarchical_flags(name, argv, line, capsys):
    """The JAX scripts' other modes: products ``--dp`` (every visible
    device; one CPU device here) and papers ``--hier 2`` over a ``[2, 2]``
    mesh."""
    report = {}
    assert _module(name).main(argv + ["--device", "cpu"],
                              report=report) == 0
    out = capsys.readouterr().out.splitlines()
    assert re.match(line, out[-1]), out[-1]
    assert all(math.isfinite(x) for x in report["losses"])


def test_unsup_data_matches_jax(runs):
    args = _parse("graph_sage_unsup")
    topo, feat, comm = _module("graph_sage_unsup").make_data(args)
    jtopo, jfeat, jcomm = jax_community(1500, 16, intra_deg=8, inter_deg=2)
    _same_topo(topo, jtopo)
    _same(feat, jfeat)
    _same(comm, jcomm)
    rng = np.random.default_rng(0)
    B = 64
    src_all = np.repeat(np.arange(jtopo.node_count),
                        np.asarray(jtopo.degree))
    eids = rng.integers(0, jtopo.edge_count, B)
    u, v = src_all[eids], np.asarray(jtopo.indices)[eids].astype(np.int64)
    neg = rng.integers(0, jtopo.node_count, B)
    _same(runs["graph_sage_unsup"].report["first_seeds"],
          np.concatenate([u, v, neg]))


def test_papers_data_matches_jax(runs):
    args = _parse("papers100M_dist")
    nd = 8
    topo, feat, labels, g2h, _ = _module("papers100M_dist").make_data(
        args, nd)
    rng = np.random.default_rng(0)
    deg = np.maximum(rng.lognormal(2.0, 1.0, 3000), 1).astype(np.int64)
    deg = (deg * 30000 / deg.sum()).astype(np.int64) + 1
    src = np.repeat(np.arange(3000), deg)
    dst = rng.integers(0, 3000, len(src))
    jtopo = JaxTopo(edge_index=np.stack([src, dst]))
    jfeat = rng.normal(size=(3000, 8)).astype(np.float32)
    jlab = rng.integers(0, 32, 3000)
    jg2h = rng.integers(0, nd, jtopo.node_count).astype(np.int32)
    _same_topo(topo, jtopo)
    _same(feat, jfeat)
    _same(labels, jlab)
    _same(g2h, jg2h)
    _same(runs["papers100M_dist"].report["first_seeds"],
          rng.integers(0, jtopo.node_count, (nd, 8)))


def test_mag_data_matches_jax(runs):
    args = _parse("mag240m_rgat")
    mod = _module("mag240m_rgat")
    eid, counts, dims, tables, labels, _ = mod.make_data(args)
    rng = np.random.default_rng(0)

    def edges(n_src, n_dst, avg):
        deg = rng.poisson(avg, n_dst)
        dst = np.repeat(np.arange(n_dst), deg)
        return np.stack([rng.integers(0, n_src, len(dst)), dst])

    jcounts = {"paper": 800, "author": 400, "institution": 50}
    jeid = {
        mod.CITES: edges(800, 800, 8),
        mod.WRITES: edges(400, 800, 4),
        mod.EMPLOYS: edges(50, 400, 2),
    }
    jdims = {"paper": 64, "author": 32, "institution": 16}
    jtables = {t: rng.normal(size=(jcounts[t], jdims[t])).astype(np.float32)
               for t in jcounts}
    jlab = rng.integers(0, 20, 800)
    assert counts == jcounts and dims == jdims
    ptopo = qt.HeteroCSRTopo.from_edge_index_dict(eid, counts)
    jtopo = JaxHeteroTopo.from_edge_index_dict(jeid, jcounts)
    for rel in jeid:
        _same(eid[rel], jeid[rel])
        _same_topo(ptopo.relations[rel], jtopo.relations[rel])
    for t in jcounts:
        _same(tables[t], jtables[t])
    _same(labels, jlab)
    _same(runs["mag240m_rgat"].report["first_seeds"],
          rng.integers(0, 800, 16))


def test_serving_data_matches_jax(runs):
    args = _parse("serving_reddit")
    topo, feat = _module("serving_reddit").make_data(args)
    rng = np.random.default_rng(0)
    deg = np.maximum(rng.lognormal(2, 1, 1500), 1).astype(np.int64)
    deg = (deg * 15000 / deg.sum()).astype(np.int64) + 1
    src = np.repeat(np.arange(1500), deg)
    dst = rng.integers(0, 1500, len(src))
    _same_topo(topo, JaxTopo(edge_index=np.stack([src, dst])))
    _same(feat, rng.normal(size=(1500, 64)).astype(np.float32))
    crng = np.random.default_rng(0)  # client 0's first request
    _same(runs["serving_reddit"].report["first_seeds"],
          crng.integers(0, 1500, crng.integers(1, 32)))


def test_partition_data_matches_jax(runs):
    args = _parse("preprocess_partition")
    topo, feature, _ = _module("preprocess_partition").make_data(args)
    indptr, indices = jax_synthetic_csr(2000, 20000)
    _same_topo(topo, JaxTopo(indptr=indptr, indices=indices))
    rng = np.random.default_rng(0)
    _same(feature, rng.normal(size=(2000, 32)).astype(np.float32))
    train = rng.permutation(2000)[:1000]
    _same(runs["preprocess_partition"].report["first_seeds"],
          np.array_split(train, 4)[0])
    sizes = runs["preprocess_partition"].report["sizes"]
    assert sum(sizes) == 2000 and len(sizes) == 4


def test_big_graph_data_matches_jax(runs):
    args = _parse("big_graph_single_chip")
    topo, feat, labels, train = _module("big_graph_single_chip").make_data(
        args)
    rng = np.random.default_rng(0)
    indptr, indices = jax_synthetic_csr(3000, 3000 * 8, 0)
    _same_topo(topo, JaxTopo(indptr=indptr, indices=indices))
    _same(feat, rng.normal(size=(3000, 16)).astype(np.float32))
    _same(labels, rng.integers(0, 16, 3000))
    jtrain = rng.choice(3000, 300, replace=False)
    _same(train, jtrain)
    # the loader's generator (seed 0) shuffles once for the first batch
    # the script peeks at, then again for the training epoch
    loader_rng = np.random.default_rng(0)
    order = jtrain.copy()
    loader_rng.shuffle(order)
    loader_rng.shuffle(order)
    _same(runs["big_graph_single_chip"].report["first_seeds"], order[:64])


def test_dgl_data_matches_jax(runs):
    args = _parse("dgl_products_sage")
    topo, feat, labels = _module("dgl_products_sage").make_data(args)
    jtopo, jfeat, jlab = jax_community(3000, 16, intra_deg=8, inter_deg=2,
                                       noise=0.6, feat_extra=16, seed=0)
    _same_topo(topo, jtopo)
    _same(feat, jfeat)
    _same(labels, jlab)
    _same(runs["dgl_products_sage"].report["first_seeds"],
          np.random.default_rng(1).integers(0, jtopo.node_count, 128))


# -- the math that lives only in an example ----------------------------------

def _jax_embeddings(seed_count):
    """One sampled batch of the unsup graph through JAX's sampler, the
    Flax encoder's embeddings, and the port encoder with the same weights
    on the same blocks."""
    args = _parse("graph_sage_unsup")
    topo, feat, comm = _module("graph_sage_unsup").make_data(args)
    seeds = np.random.default_rng(5).integers(0, topo.node_count,
                                              seed_count)
    jt = JaxTopo(indptr=topo.indptr, indices=topo.indices)
    jb = JaxSampler(jt, [10, 5], gather_mode="xla", sample_rng="hash",
                    dedup="none").sample(seeds, key=make_key(2))
    x = feat[np.asarray(jb.n_id)]
    flax = FlaxSAGE(hidden=64, out_dim=32, num_layers=2, dropout=0.0)
    params = flax.init(make_key(1), jnp.asarray(x), jb.layers)
    z_jax = np.asarray(flax.apply(params, jnp.asarray(x), jb.layers))
    port = qt.GraphSAGE(feat.shape[1], 64, 32, num_layers=2, dropout=0.0,
                        device="cpu")
    port.load_state_dict(qt.sage_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    blocks = tuple(qt.LayerBlock(
        nbr_local=torch.from_numpy(np.asarray(b.nbr_local).copy()),
        mask=torch.from_numpy(np.asarray(b.mask).copy()),
        num_targets=torch.tensor(int(np.asarray(b.num_targets))))
        for b in jb.layers)
    port.eval()
    with torch.no_grad():
        z_port = port(torch.from_numpy(x), blocks)
    return seeds, comm, z_jax, z_port


def test_unsup_pair_loss_and_probe_match_jax_formulas():
    B = 64
    _, _, z_jax, z_port = _jax_embeddings(3 * B)
    np.testing.assert_allclose(z_port.numpy(), z_jax, rtol=1e-5,
                               atol=1e-5)
    # graph_sage_unsup.py's loss_fn, on JAX's embeddings
    z = jnp.asarray(z_jax)
    zu, zv, zn = z[:B], z[B:2 * B], z[2 * B:]
    pos = jax.nn.log_sigmoid((zu * zv).sum(-1))
    neg = jax.nn.log_sigmoid(-(zu * zn).sum(-1))
    want = float(-(pos + neg).mean())
    got = _module("graph_sage_unsup").pair_loss(z_port, B)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_unsup_cosine_probe_matches_jax_formula():
    seeds, comm, z_jax, z_port = _jax_embeddings(192)
    # graph_sage_unsup.py's probe, on JAX's embeddings
    z = z_jax / np.linalg.norm(z_jax, axis=1, keepdims=True)
    same = comm[seeds[:, None]] == comm[seeds[None, :]]
    sims = z @ z.T
    want = (sims[same].mean(), sims[~same].mean())
    got = _module("graph_sage_unsup").cosine_probe(
        z_port.numpy(), comm, seeds)
    np.testing.assert_allclose(got, want, rtol=1e-5)


class _JaxScriptSAGEConv(torch.nn.Module):
    """``examples/dgl_products_sage.py``'s ``TorchSAGEConv`` (:83-100), as
    the JAX script defines it inside ``main``."""

    def __init__(self, din, dout):
        super().__init__()
        self.w_self = torch.nn.Linear(din, dout)
        self.w_neigh = torch.nn.Linear(din, dout, bias=False)

    def forward(self, spec, h, h_dst):
        src, dst, _, _, n_dst = spec
        agg = torch.zeros((n_dst, h.shape[1]), dtype=h.dtype)
        cnt = torch.zeros((n_dst, 1), dtype=h.dtype)
        idx = torch.from_numpy(dst.astype(np.int64))
        agg.index_add_(0, idx, h[torch.from_numpy(
            src.astype(np.int64))])
        cnt.index_add_(0, idx, torch.ones((len(dst), 1)))
        mean = agg / cnt.clamp(min=1)
        return self.w_self(h_dst) + self.w_neigh(mean)


def test_dgl_fallback_conv_is_the_jax_scripts_bit_for_bit():
    from quiver_tpu_torch.interop import block_specs

    mod = _module("dgl_products_sage")
    args = _parse("dgl_products_sage")
    topo, feat, _ = mod.make_data(args)
    sampler = qt.GraphSageSampler(topo, [10, 5], device="cpu")
    batch = sampler.sample(np.random.default_rng(3).integers(
        0, topo.node_count, 128))
    specs = block_specs(batch)
    x = torch.from_numpy(feat[batch.n_id.numpy()])
    torch.manual_seed(7)
    want_conv = _JaxScriptSAGEConv(feat.shape[1], 64)
    got_conv = mod.TorchSAGEConv(feat.shape[1], 64, device="cpu")
    got_conv.load_state_dict(want_conv.state_dict())
    for spec in specs:
        h_dst = x[: spec[4]]
        want = want_conv(spec, x, h_dst)
        got = got_conv(spec, x, h_dst)
        assert torch.equal(got, want)
    # the two-layer model as the script stacks it
    torch.manual_seed(8)
    model = mod.SpecSAGE(feat.shape[1], 16, device="cpu")
    l1 = _JaxScriptSAGEConv(feat.shape[1], 64)
    l2 = _JaxScriptSAGEConv(64, 16)
    l1.load_state_dict(model.l1.state_dict())
    l2.load_state_dict(model.l2.state_dict())
    h = torch.from_numpy(feat[batch.n_id.numpy()])
    for layer, spec in zip((l1, l2), specs):
        h = layer(spec, h, h[: spec[4]])
        if layer is l1:
            h = torch.relu(h)
    assert torch.equal(model(specs, torch.from_numpy(
        feat[batch.n_id.numpy()])), h)
