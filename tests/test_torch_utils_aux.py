"""Port parity: ``utils/trace.py``, ``utils/rng.py`` and
``utils/checkpoint.py`` of the port against the JAX package's.

- ``latest_checkpoint`` picks JAX's step on the same directory listings,
  and ``load_checkpoint`` resolves a root and a leaf by JAX's rules.
- A checkpoint round trip restores the model and the optimizer bitwise,
  and a fresh model and optimizer restored from it take a next step whose
  loss equals the original's bit for bit.
- A JAX-format checkpoint (pickle or orbax) is refused with a reason.
- ``default_impl`` reads ``QUIVER_TPU_PRNG`` as JAX's does; ``make_key``
  seeds a generator and refuses names JAX does not know.
- ``trace_scope`` aggregates as JAX's, ``Timer`` and ``show_tensor_info``
  print, and ``profile_trace`` writes a Chrome trace.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from quiver_tpu import telemetry as jtel
from quiver_tpu.utils import checkpoint as jckpt
from quiver_tpu.utils import rng as jrng
from quiver_tpu.utils import trace as jtrace

import quiver_tpu_torch as qt
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.parallel import make_train_step
from quiver_tpu_torch.utils import checkpoint as pckpt
from quiver_tpu_torch.utils import rng as prng
from quiver_tpu_torch.utils import trace as ptrace

_JAX_TELEMETRY_DEFAULT = jtel.enabled()


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """The tracers and registries are process-wide in both packages: each
    test starts and ends with them empty and the trace switches off;
    JAX's telemetry is back at its process default after."""
    for tel in (ptel, jtel):
        tel.set_enabled(True)
        tel.reset()
    yield
    for trace in (ptrace, jtrace):
        trace.set_enabled(False)
    for tel in (ptel, jtel):
        tel.reset()
    ptel.set_enabled(True)
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


LISTINGS = [
    ["ckpt_1.pkl", "ckpt_10.pkl", "ckpt_2.pkl"],
    ["ckpt_3", "ckpt_12", "ckpt_7.pkl"],
    ["ckpt_5.pkl", "ckpt_9.pkl.tmp", "ckpt_x.pkl", "notes.txt", "ckpt_"],
    ["ckpt_4.tmp", "other_8.pkl"],
    [],
]


@pytest.mark.parametrize("names", LISTINGS)
def test_latest_checkpoint_matches_jax(tmp_path, names):
    for n in names:
        path = tmp_path / n
        if "." in n:
            path.write_bytes(b"")
        else:
            path.mkdir()
    assert pckpt.latest_checkpoint(str(tmp_path)) == \
        jckpt.latest_checkpoint(str(tmp_path))
    assert pckpt.latest_checkpoint(str(tmp_path / "missing")) is None


def _model_and_batch(seed=0):
    indptr, indices = qt.synthetic_csr(120, 900, seed=seed)
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    sampler = qt.GraphSageSampler(topo, [3, 2], device="cpu", seed=seed)
    feat = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (120, 5)).astype(np.float32))
    batch = sampler.sample(np.arange(16))
    x = feat[batch.n_id.long()]
    labels = torch.from_numpy(np.random.default_rng(1).integers(
        0, 3, 16).astype(np.int64))
    mask = torch.ones(16, dtype=torch.bool)
    return x, batch.layers, labels, mask


def _state(seed):
    torch.manual_seed(seed)
    model = qt.GraphSAGE(5, 8, 3, num_layers=2, device="cpu")
    return qt.TrainState.create(model, lr=1e-2)


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    x, blocks, labels, mask = _model_and_batch()
    st = _state(0)
    step = make_train_step(st.model, st.optimizer, seed=3)
    for _ in range(3):
        step(x, blocks, labels, mask)
    path = pckpt.save_checkpoint(str(tmp_path), st, 3,
                                 extra={"epoch": 1, "note": "a"})
    assert os.path.basename(path) == "ckpt_3.pt"
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    fresh = _state(7)
    got, at = pckpt.load_checkpoint(str(tmp_path), fresh)
    assert got is fresh and at == 3
    for a, b in zip(st.model.state_dict().values(),
                    fresh.model.state_dict().values()):
        assert torch.equal(a, b)
    so, fo = st.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert so["param_groups"] == fo["param_groups"]
    for k in so["state"]:
        for name, v in so["state"][k].items():
            assert torch.equal(v, fo["state"][k][name]), (k, name)
    # the next step, from each, with the same dropout generator seed
    a = make_train_step(st.model, st.optimizer, seed=11)(
        x, blocks, labels, mask)
    b = make_train_step(fresh.model, fresh.optimizer, seed=11)(
        x, blocks, labels, mask)
    assert torch.equal(a, b)
    payload = pckpt.load_checkpoint(path)
    assert payload["step"] == 3 and payload["extra"] == {"epoch": 1,
                                                         "note": "a"}


class _Opaque:
    """A class that only unpickling arbitrary code could rebuild."""


def test_checkpoint_load_runs_no_pickled_code(tmp_path):
    """Loading reads with ``weights_only=True``: a checkpoint whose
    ``extra`` holds an arbitrary object is refused, not rebuilt."""
    st = _state(0)
    pckpt.save_checkpoint(str(tmp_path), st, 1, extra={"obj": _Opaque()})
    with pytest.raises(pickle.UnpicklingError):
        pckpt.load_checkpoint(str(tmp_path), _state(1))
    with pytest.raises(pickle.UnpicklingError):
        pckpt.load_checkpoint(str(tmp_path))


def test_jax_checkpoints_are_refused(tmp_path):
    root = tmp_path / "ckpts"
    root.mkdir()
    (root / "ckpt_4.pkl").write_bytes(b"")
    with pytest.raises(ValueError, match="JAX package"):
        pckpt.load_checkpoint(str(root))
    leaf = tmp_path / "ckpt_leaf"
    leaf.mkdir()
    (leaf / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="JAX package"):
        pckpt.load_checkpoint(str(leaf))
    empty = tmp_path / "ckpt_root"  # a root named like a leaf, no children
    empty.mkdir()
    for load in (pckpt.load_checkpoint, jckpt.load_checkpoint):
        with pytest.raises(FileNotFoundError):
            load(str(empty))


def test_rng_names_match_jax(monkeypatch):
    monkeypatch.delenv("QUIVER_TPU_PRNG", raising=False)
    assert prng.default_impl() == jrng.default_impl() == "threefry2x32"
    monkeypatch.setenv("QUIVER_TPU_PRNG", "rbg")
    assert prng.default_impl() == jrng.default_impl() == "rbg"
    g = prng.make_key(5, device="cpu")
    assert isinstance(g, torch.Generator) and g.initial_seed() == 5
    assert torch.equal(torch.rand(4, generator=g), torch.rand(
        4, generator=prng.make_key(5, impl="threefry2x32", device="cpu")))
    with pytest.raises(ValueError, match="PRNG"):
        prng.make_key(0, impl="philox", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prng.make_key(0)


def test_trace_utilities_match_jax(tmp_path):
    lines = []
    for trace in (ptrace, jtrace):
        trace.reset_trace()
        with trace.trace_scope("off"):
            pass
        trace.set_enabled(True)
        assert trace.enabled()
        for _ in range(3):
            with trace.trace_scope("a"):
                with trace.trace_scope("b"):
                    pass
        with trace.trace_scope("t", block=None):
            pass
        lines.append({k: v["count"] for k, v in trace.trace_summary().items()})
        trace.reset_trace()
        assert trace.trace_summary() == {}
        trace.set_enabled(False)
        with trace.Timer("x", printer=lines.append):
            pass
    assert lines[0] == lines[2] == {"a": 3, "b": 3, "t": 1}
    assert lines[1].startswith("[timer] x: ")
    ptrace.set_enabled(True)
    with ptrace.trace_scope("blocked", block=[torch.ones(2)]):
        pass
    assert ptrace.trace_summary()["blocked"]["count"] == 1
    out = []
    t = torch.zeros(2, 3)
    assert ptrace.show_tensor_info(t, "z", printer=out.append) is t
    assert out == ["z: shape=(2, 3) dtype=torch.float32 device=cpu"]
    with ptrace.profile_trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (written,) = os.listdir(tmp_path / "prof")
    doc = json.load(open(tmp_path / "prof" / written))
    assert doc["traceEvents"]


# the A13 names (ROADMAP §A, item 4): sharding across devices
_A13_NAMES = {"DistFeature", "PartitionInfo", "TpuComm", "DistGraphSampler",
              "RingFeature", "distributed_initialize", "make_hybrid_mesh",
              "HierFeature", "MeshTopo", "make_mesh"}


def test_port_exports_every_jax_top_level_name():
    """Every name of JAX's ``__all__`` (``quiver_tpu/__init__.py:100``)
    is in the port's ``__all__`` and importable from it, the A13 names
    included; ``make_key`` is the port's own."""
    import quiver_tpu

    missing = set(quiver_tpu.__all__) - set(qt.__all__)
    assert not missing, sorted(missing)
    for name in quiver_tpu.__all__:
        assert getattr(qt, name).__module__.startswith("quiver_tpu_torch")
    assert qt.make_key is prng.make_key
    assert _A13_NAMES <= set(qt.__all__)
