"""Port parity: ``quiver_tpu_torch.recovery.shardwal`` (per-shard WAL
segments under one group manifest) against the JAX package's
``tests/test_mesh.py::TestShardGroupWAL`` cases, and byte for byte against
the JAX package's ``ShardGroupWAL`` on the same appends: every segment and
the manifest."""

import os

import pytest

from quiver_tpu import telemetry as jtel
from quiver_tpu.recovery.shardwal import ShardGroupWAL as JaxGroupWAL
from quiver_tpu.recovery.shardwal import load_manifest as jax_load_manifest

from quiver_tpu_torch import recovery
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.recovery.errors import RecoveryError
from quiver_tpu_torch.recovery.shardwal import (GroupManifest, ShardGroupWAL,
                                                load_manifest,
                                                shard_wal_root)

_JAX_TELEMETRY_DEFAULT = jtel.enabled()


@pytest.fixture(autouse=True)
def _fresh_registries():
    """Both packages' registries start and end empty (the WAL ticks its
    gauges and counters); JAX's telemetry returns to its default."""
    for tel in (ptel, jtel):
        tel.set_enabled(True)
        tel.reset()
    yield
    for tel in (ptel, jtel):
        tel.reset()
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_exported_from_recovery():
    assert recovery.ShardGroupWAL is ShardGroupWAL
    assert "ShardGroupWAL" in recovery.__all__
    assert shard_wal_root("/g", 3) == os.path.join("/g", "shard-03")
    with pytest.raises(ValueError):
        shard_wal_root("/g", -1)
    with pytest.raises(ValueError):
        ShardGroupWAL("/nonexistent-never-made", n_shards=0)
    with pytest.raises(RecoveryError, match="entries"):
        GroupManifest(2, [1])


def test_coherent_replay_stops_at_manifest(tmp_path):
    w = ShardGroupWAL(str(tmp_path), n_shards=2, group="g1", fsync="off")
    for i in range(4):
        w.append(0, f"a{i}".encode())
    w.append(1, b"b0")
    m = w.publish_manifest()
    assert m.lsns == [3, 0]
    # writes after the group commit point are the un-acked tail
    w.append(0, b"a4")
    w.append(1, b"b1")
    assert [p for _lsn, p in w.replay(0)] == [b"a0", b"a1", b"a2", b"a3"]
    assert [p for _lsn, p in w.replay(1)] == [b"b0"]
    assert w.tail_lsns() == [1, 1]
    st = w.stats()
    assert st["last_lsns"] == [4, 1] and st["manifest"]["lsns"] == [3, 0]
    w.close()


def test_no_manifest_replays_nothing(tmp_path):
    w = ShardGroupWAL(str(tmp_path), n_shards=2, fsync="off")
    w.append(0, b"x")
    assert list(w.replay(0)) == []
    assert w.tail_lsns() == [1, 0]
    w.close()


def test_manifest_survives_reopen_and_versions(tmp_path):
    w = ShardGroupWAL(str(tmp_path), n_shards=2, fsync="off")
    w.append(0, b"x")
    v1 = w.publish_manifest().version
    w.append(1, b"y")
    v2 = w.publish_manifest().version
    assert v2 == v1 + 1
    w.close()
    # a fresh process resumes versioning past what is on disk
    w2 = ShardGroupWAL(str(tmp_path), n_shards=2, fsync="off")
    assert load_manifest(str(tmp_path)).version == v2
    assert w2.publish_manifest().version == v2 + 1
    assert [p for _lsn, p in w2.replay(1)] == [b"y"]
    w2.close()


def test_garbage_manifest_is_loud(tmp_path):
    (tmp_path / "group-manifest.json").write_bytes(b"{torn")
    with pytest.raises(RecoveryError, match="manifest"):
        load_manifest(str(tmp_path))
    assert load_manifest(str(tmp_path / "none")) is None


def test_truncate_through_manifest(tmp_path):
    w = ShardGroupWAL(str(tmp_path), n_shards=1, fsync="off",
                      segment_bytes=64)
    for i in range(40):
        w.append(0, b"payload-%d" % i)
    w.publish_manifest()
    assert w.truncate_through_manifest() > 0
    lsns = [lsn for lsn, _p in w.replay(0)]
    assert lsns == sorted(lsns) and lsns[-1] == 39
    w.close()


@pytest.mark.parametrize("n_shards,segment_bytes", [(2, 64), (4, 1 << 20)])
def test_files_are_jax_bytes(tmp_path, n_shards, segment_bytes):
    """The same appends and publishes through both packages leave the
    same files, byte for byte; each package reads the other's group."""
    roots = {k: str(tmp_path / k) for k in ("jax", "port")}
    logs = {"jax": JaxGroupWAL(roots["jax"], n_shards=n_shards, group="g",
                               fsync="off", segment_bytes=segment_bytes),
            "port": ShardGroupWAL(roots["port"], n_shards=n_shards,
                                  group="g", fsync="off",
                                  segment_bytes=segment_bytes)}
    for i in range(30):
        for w in logs.values():
            assert w.append(i % n_shards, b"op-%03d" % i) == i // n_shards
        if i in (9, 21):
            ms = [w.publish_manifest().to_dict() for w in logs.values()]
            assert ms[0] == ms[1]
    for w in logs.values():
        w.close()
    jf, pf = _files(roots["jax"]), _files(roots["port"])
    assert sorted(jf) == sorted(pf)
    for name in jf:
        assert jf[name] == pf[name], name
    # cross-reading: the port replays JAX's group through its watermark
    cross = ShardGroupWAL(roots["jax"], n_shards=n_shards, fsync="off",
                          segment_bytes=segment_bytes)
    jm = jax_load_manifest(roots["jax"])
    assert load_manifest(roots["jax"]).to_dict() == jm.to_dict()
    for s in range(n_shards):
        got = [p for _lsn, p in cross.replay(s)]
        assert len(got) == jm.lsns[s] + 1
    cross.close()
