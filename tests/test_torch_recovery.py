"""Port parity: ``quiver_tpu_torch.recovery`` (block I/O and CRC-32C, the
WAL, checkpoints, coldcache state, durable ingest, the recovery manager,
the program registry, ``/healthz``) against the JAX package's
``tests/test_recovery.py`` and against the JAX objects.

* **Bytes** — for the same appends, WAL segments are byte-for-byte JAX's;
  for the same graph and coldcache state, checkpoint files are too; each
  package replays the other's log and restores the other's snapshot to
  the same graph (base, tombstones, delta order, version).
* **CRC-32C** — the native slicing-by-8 (``cpp/csrc/crc32c.cpp``) and the
  plain table walk equal JAX's ``crc32c`` on every input, whole and
  continued.
* **Zero acked loss** — an acked edge op replays; a kill -9 (a child that
  imports only the port) loses no acked op.
* **Crash debris** — torn tails and corrupt records are counted, never
  fatal; skewed or corrupt snapshots are typed refusals.
* **Warm restart** — coldcache residency restores with the row values a
  fresh gather returns (overlay and paged store); the registry counts the
  port's builds and a sealed registry refuses a late one.

Samplers run ``gather_mode="xla"``; JAX's ``sample_rng="hash"``.
"""

import json
import os
import signal
import struct
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from quiver_tpu import config as jconfig
from quiver_tpu import telemetry as jtel
from quiver_tpu.feature import Feature as JaxFeature
from quiver_tpu.ops.coldcache import ColdRowCache as JaxColdRowCache
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.recovery import blockio as jblockio
from quiver_tpu.recovery import checkpoint as jckpt
from quiver_tpu.recovery import manager as jmanager
from quiver_tpu.recovery import wal as jwal
from quiver_tpu.recovery.registry import (
    get_program_registry as jax_registry)
from quiver_tpu.resilience import chaos as jchaos
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.stream import StreamingGraph as JaxGraph
from quiver_tpu.telemetry import flightrec as jflightrec
from quiver_tpu.telemetry import metric_key
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch import config as pconfig
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.cpp import native
from quiver_tpu_torch.ops.coldcache import ColdRowCache
from quiver_tpu_torch.recovery import blockio
from quiver_tpu_torch.recovery.checkpoint import (
    CHECKPOINT_FORMAT, load_checkpoint, read_checkpoint, restore_graph,
    save_checkpoint)
from quiver_tpu_torch.recovery.errors import (
    RecoveryDeadlineExceeded, RecoveryError, RetraceBudgetExceeded,
    SnapshotFormatError, WALError, WALWriteError)
from quiver_tpu_torch.recovery.manager import (
    RecoveryManager, health_status, set_active)
from quiver_tpu_torch.recovery.registry import get_program_registry
from quiver_tpu_torch.recovery.wal import (
    WriteAheadLog, decode_edge_op, encode_abort, encode_edge_op)
from quiver_tpu_torch.resilience import chaos
from quiver_tpu_torch.stream import IngestLane, StreamingGraph
from quiver_tpu_torch.telemetry import flightrec as pflightrec

REPO = Path(__file__).resolve().parents[1]
_JAX_TELEMETRY_DEFAULT = jtel.enabled()


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """Both packages' registries, chaos plans, recorders, active managers
    and sealed program registries start and end clean; JAX's telemetry is
    on for the test and back at its process default after."""
    jcfg = jconfig.get_config()
    saved = {k: getattr(jcfg, k) for k in ("recovery_deadline_s",)}
    for tel, ch, rec in ((ptel, chaos, pflightrec),
                         (jtel, jchaos, jflightrec)):
        tel.set_enabled(True)
        tel.reset()
        ch.uninstall()
        rec.reset()
    yield
    for tel, ch, rec in ((ptel, chaos, pflightrec),
                         (jtel, jchaos, jflightrec)):
        ch.uninstall()
        rec.set_version_provider(None)
        rec.reset()
        tel.reset()
    for reg in (get_program_registry(), jax_registry()):
        reg.unseal()
    get_program_registry().disable_persistent_cache()
    set_active(None)
    jmanager.set_active(None)
    jconfig.update(**saved)
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


def counter(name, tel=ptel, **labels):
    return tel.snapshot()["counters"].get(metric_key(name, labels), 0)


def _ring(n=64, jax_side=False):
    src = np.arange(n, dtype=np.int64)
    ei = np.stack([src, (src + 1) % n])
    return JaxTopo(edge_index=ei) if jax_side else qt.CSRTopo(edge_index=ei)


def _graph(**kw):
    return StreamingGraph(_ring(), delta_capacity=kw.pop("cap", 512), **kw)


def _words(key, n_hops):
    return np.array([[int(np.asarray(w)) for w in _fold_key_words(k)]
                     for k in jax.random.split(key, n_hops)], np.uint32)


def _assert_same_samples(ga, gb, rounds=3):
    """Port graphs, or a port graph and a JAX graph, sample alike."""
    def draw(g, s):
        if isinstance(g, JaxGraph):
            b = JaxSampler(g, sizes=[5, 3], gather_mode="xla",
                           sample_rng="hash").sample(np.arange(8),
                                                     key=make_key(s))
            return np.asarray(b.n_id), np.asarray(b.n_id_mask)
        b = qt.GraphSageSampler(g, [5, 3], device="cpu",
                                gather_mode="xla").sample(
            np.arange(8), key_words=_words(make_key(s), 2))
        return b.n_id.numpy(), b.n_id_mask.numpy()

    for s in range(rounds):
        for x, y in zip(draw(ga, s), draw(gb, s)):
            np.testing.assert_array_equal(x, y)


def _same_graph(a, b):
    """The same base, tombstones, live delta edges in order, version."""
    np.testing.assert_array_equal(a.base.indptr, b.base.indptr)
    np.testing.assert_array_equal(a.base.indices, b.base.indices)
    np.testing.assert_array_equal(a._tomb, b._tomb)
    for x, y in zip(a._delta.live_edges(), b._delta.live_edges()):
        if x is None or y is None:
            assert x is None and y is None
        else:
            np.testing.assert_array_equal(x, y)
    assert a.version == b.version and a.has_ts == b.has_ts
    if a.has_ts:
        np.testing.assert_array_equal(a._base_ts, b._base_ts)


def _drain(lane, n, timeout=10.0):
    return [lane.results.get(timeout=timeout) for _ in range(n)]


# ---------------------------------------------------------------- blockio
class TestBlockIO:
    def test_crc32c_known_answer(self):
        assert blockio.crc32c(b"123456789") == 0xE3069283
        assert blockio.crc32c_plain(b"123456789") == 0xE3069283
        assert blockio.crc32c(b"") == 0 == blockio.crc32c_plain(b"")

    @pytest.mark.parametrize("n", [1, 7, 8, 9, 63, 64, 65, 4099, 100_003])
    def test_crc32c_native_and_plain_equal_jax(self, n):
        data = np.random.default_rng(n).integers(
            0, 256, n, dtype=np.uint8).tobytes()
        want = jblockio.crc32c(data)
        assert blockio.crc32c(data) == want
        if n < 10_000:  # the table walk is slow: about 0.1 s a 100 kB
            assert blockio.crc32c_plain(data) == want
        assert blockio.crc32c(memoryview(data)) == want
        assert blockio.crc32c(np.frombuffer(data, np.uint8)) == want

    def test_crc32c_incremental(self):
        data = np.random.default_rng(2).integers(
            0, 256, 5000, dtype=np.uint8).tobytes()
        for cut in (0, 1, 8, 13, 4096, 5000):
            got = blockio.crc32c(data[cut:], blockio.crc32c(data[:cut]))
            assert got == jblockio.crc32c(data)
            assert blockio.crc32c_plain(
                data[cut:], blockio.crc32c_plain(data[:cut])) == got
        # a previous value from JAX continues the same run
        assert blockio.crc32c(b" world", jblockio.crc32c(b"hello")) == \
            jblockio.crc32c(b"hello world")

    def test_crc32c_is_a_native_library_built_with_gxx(self):
        blockio.crc32c(b"x")
        assert native._library_path(blockio.CRC_SRC).exists()
        assert blockio.CRC_SRC.parent == native.SRC.parent
        assert "crc32c" in native._libs

    def test_record_round_trip_both_ways(self, tmp_path):
        payloads = [b"a", b"bb" * 100, b""]
        for writer, reader in ((blockio, jblockio), (jblockio, blockio)):
            p = tmp_path / f"seg-{writer.__name__}"
            with open(p, "ab") as f:
                for pl in payloads:
                    writer.write_record(f, pl)
            got = [(k, pl) for k, _o, pl in
                   reader.scan_records(p.read_bytes())]
            assert got == [("ok", pl) for pl in payloads]
        assert (tmp_path / f"seg-{blockio.__name__}").read_bytes() == \
            (tmp_path / f"seg-{jblockio.__name__}").read_bytes()

    def test_torn_tail_stops_scan(self, tmp_path):
        p = tmp_path / "seg"
        with open(p, "ab") as f:
            blockio.write_record(f, b"first")
            blockio.write_record(f, b"second-record-payload")
        torn = p.read_bytes()[:-5]
        assert [k for k, _o, _p in blockio.scan_records(torn)] == \
            ["ok", "torn"]

    def test_corrupt_record_resyncs_when_frame_holds(self, tmp_path):
        p = tmp_path / "seg"
        with open(p, "ab") as f:
            blockio.write_record(f, b"victim-payload")
            blockio.write_record(f, b"survivor")
        data = bytearray(p.read_bytes())
        data[blockio.RECORD_HEADER_SIZE] ^= 0xFF
        scanned = list(blockio.scan_records(bytes(data)))
        assert [k for k, _o, _p in scanned] == ["corrupt", "ok"]
        assert scanned[1][2] == b"survivor"

    def test_suspect_length_is_torn_not_seek(self):
        hdr = struct.Struct("<2sII").pack(b"QW", 4, 0xDEADBEEF)
        assert [k for k, _o, _p in blockio.scan_records(
            hdr + b"ABCDgarbage-not-a-frame")] == ["torn"]

    def test_atomic_publish(self, tmp_path):
        target = tmp_path / "pub.bin"
        blockio.atomic_publish(str(target), b"v1")
        blockio.atomic_publish(str(target), [b"v", memoryview(b"2"),
                                             np.frombuffer(b"!", np.uint8)])
        assert target.read_bytes() == b"v2!"
        assert not blockio.atomic_publish(str(target), b"v3",
                                          exclusive=True)
        assert target.read_bytes() == b"v2!"
        assert [n for n in os.listdir(tmp_path) if ".tmp." in n] == []


# ---------------------------------------------------------------- WAL
def _ops():
    return [encode_edge_op("add", [1, 2], [3, 4]),
            encode_edge_op("remove", [5], [6]),
            encode_edge_op("add", np.array([7], np.int32), [9], ts=[123]),
            encode_abort(1)]


class TestWAL:
    def test_append_replay_round_trip(self, tmp_path):
        w = WriteAheadLog(tmp_path / "wal", fsync="always")
        assert w.append(encode_edge_op("add", [1, 2], [3, 4])) == 0
        assert w.append(encode_edge_op("remove", [5], [6])) == 1
        w.close()
        w2 = WriteAheadLog(tmp_path / "wal")
        recs = list(w2.replay())
        assert [lsn for lsn, _ in recs] == [0, 1]
        op, src, dst, ts = decode_edge_op(recs[0][1])
        assert (op, ts) == ("add", None)
        assert src.tolist() == [1, 2] and dst.tolist() == [3, 4]
        assert w2.next_lsn == 2
        w2.close()

    def test_edge_codec_matches_jax(self):
        for args in ((("add", [1, 2], [3, 4]), {}),
                     (("remove", np.array([7], np.int32), [9]),
                      dict(ts=np.array([123], np.int16)))):
            got = encode_edge_op(*args[0], **args[1])
            assert got == jwal.encode_edge_op(*args[0], **args[1])
            for a, b in zip(decode_edge_op(got), jwal.decode_edge_op(got)):
                if b is None or isinstance(b, str):
                    assert a == b
                else:
                    assert a.dtype == np.int64
                    np.testing.assert_array_equal(a, b)
        assert encode_abort(41) == jwal.encode_abort(41)
        with pytest.raises(WALError):
            decode_edge_op(encode_edge_op("add", [1], [2])[:-3])
        with pytest.raises(WALError):
            encode_edge_op("frobnicate", [1], [2])

    @pytest.mark.parametrize("segment_bytes", [64, 4 << 20])
    def test_segments_are_jax_bytes_both_ways(self, tmp_path,
                                              segment_bytes):
        """The same appends make the same files; each package replays the
        other's log record for record."""
        roots = {}
        for name, mod in (("port", None), ("jax", jwal)):
            root = tmp_path / name
            W = WriteAheadLog if mod is None else mod.WriteAheadLog
            w = W(root, segment_bytes=segment_bytes, fsync="always")
            for payload in _ops() * 3:
                w.append(payload)
            w.close()
            roots[name] = root
        names = sorted(os.listdir(roots["port"]))
        assert names == sorted(os.listdir(roots["jax"]))
        assert (len(names) > 1) == (segment_bytes == 64)
        for n in names:
            assert (roots["port"] / n).read_bytes() == \
                (roots["jax"] / n).read_bytes()
        for W, root in ((WriteAheadLog, roots["jax"]),
                        (jwal.WriteAheadLog, roots["port"])):
            w = W(root)
            assert list(w.replay()) == list(enumerate(_ops() * 3))
            w.close()

    def test_segment_rotation_and_truncation(self, tmp_path):
        root = tmp_path / "wal"
        w = WriteAheadLog(root, segment_bytes=64, fsync="off")
        for i in range(8):
            w.append(encode_edge_op("add", [i], [i + 1]))
        assert len(os.listdir(root)) > 1
        assert [lsn for lsn, _ in w.replay()] == list(range(8))
        w.roll()
        removed = w.truncate_through(w.last_lsn)
        assert removed >= 1
        assert counter("recovery_wal_truncated_segments_total") == removed
        assert list(w.replay()) == []
        w.close()

    def test_torn_tail_detected_on_replay(self, tmp_path):
        root = tmp_path / "wal"
        w = WriteAheadLog(root, fsync="always")
        for i in range(3):
            w.append(encode_edge_op("add", [i], [i + 1]))
        w.close()
        seg = os.path.join(root, sorted(os.listdir(root))[-1])
        with open(seg, "rb+") as f:
            f.truncate(os.path.getsize(seg) - 4)
        w2 = WriteAheadLog(root)
        assert [lsn for lsn, _ in w2.replay()] == [0, 1]
        assert counter("recovery_wal_torn_tails_total") >= 1
        assert w2.next_lsn == 2
        w2.close()

    def test_corrupt_record_skipped_with_telemetry(self, tmp_path):
        root = tmp_path / "wal"
        w = WriteAheadLog(root, fsync="always")
        for i in range(3):
            w.append(encode_edge_op("add", [i], [i + 1]))
        w.close()
        seg = os.path.join(root, sorted(os.listdir(root))[0])
        with open(seg, "rb+") as f:
            f.seek(blockio.RECORD_HEADER_SIZE)
            b = f.read(1)
            f.seek(blockio.RECORD_HEADER_SIZE)
            f.write(bytes([b[0] ^ 0xFF]))
        w2 = WriteAheadLog(root)
        assert [lsn for lsn, _ in w2.replay()] == [1, 2]
        assert counter("recovery_wal_corrupt_records_total") == 1
        assert w2.next_lsn == 3
        w2.close()

    def test_fsync_fault_is_typed_error(self, tmp_path):
        w = WriteAheadLog(tmp_path / "wal", fsync="always")
        chaos.install(chaos.ChaosPlan(seed=7).fail(
            "recovery.fsync", exc=OSError("disk gone"), times=1))
        with pytest.raises(WALWriteError):
            w.append(encode_edge_op("add", [1], [2]))
        assert isinstance(w.append(encode_edge_op("add", [1], [2])), int)
        w.close()

    def test_closed_wal_refuses_appends(self, tmp_path):
        w = WriteAheadLog(tmp_path / "wal")
        w.close()
        with pytest.raises(WALWriteError):
            w.append(b"late")

    def test_reused_segment_after_torn_first_record(self, tmp_path):
        root = tmp_path / "wal"
        w = WriteAheadLog(root, fsync="always")
        w.append(encode_edge_op("add", [1], [2]))
        w.close()
        seg = os.path.join(root, sorted(os.listdir(root))[-1])
        with open(seg, "rb+") as f:
            f.truncate(3)
        w2 = WriteAheadLog(root)
        assert w2.next_lsn == 0
        assert counter("recovery_wal_torn_tails_total") == 1
        assert [w2.append(encode_edge_op("add", [i], [i + 1]))
                for i in range(3)] == [0, 1, 2]
        assert [lsn for lsn, _ in w2.replay()] == [0, 1, 2]
        w2.close()
        w3 = WriteAheadLog(root)
        assert w3.next_lsn == 3
        w3.close()

    def test_batch_policy_reaches_page_cache_per_append(self, tmp_path):
        root = tmp_path / "wal"
        w = WriteAheadLog(root, fsync="batch", batch_bytes=1 << 20)
        w.append(encode_edge_op("add", [1], [2]))
        seg = os.path.join(root, sorted(os.listdir(root))[0])
        with open(seg, "rb") as f:
            assert [k for k, _o, _p in blockio.scan_records(f.read())] == \
                ["ok"]
        w.close()

    def test_fsync_fault_ignored_under_policy_off(self, tmp_path):
        w = WriteAheadLog(tmp_path / "wal", fsync="off")
        chaos.install(chaos.ChaosPlan(seed=7).fail(
            "recovery.fsync", exc=OSError("disk gone"), times=100))
        for i in range(3):
            w.append(encode_edge_op("add", [i], [i + 1]))
        w.sync()
        assert counter("recovery_wal_fsyncs_total") == 0
        assert [lsn for lsn, _ in w.replay()] == [0, 1, 2]
        w.close()

    def test_default_policy_fsyncs_every_append(self, tmp_path):
        w = WriteAheadLog(tmp_path / "wal")
        assert w.fsync_policy == "always"
        for i in range(4):
            w.append(encode_edge_op("add", [i], [i + 1]))
        assert counter("recovery_wal_fsyncs_total") == 4
        w.close()


# ---------------------------------------------------------------- snapshots
def _mutated(jax_side=False, with_ts=False):
    topo = _ring(jax_side=jax_side)
    ts = np.arange(topo.edge_count) * 3 if with_ts else None
    G = JaxGraph if jax_side else StreamingGraph
    g = G(topo, edge_ts=ts, delta_capacity=512)
    g.add_edges([0, 1, 9], [5, 7, 9], ts=[4, 5, 6] if with_ts else None)
    g.remove_edges([2], [3])
    g.remove_edges([1], [7])
    return g


class TestCheckpoint:
    def test_round_trip_bit_identical_sampling(self, tmp_path):
        g = _mutated()
        save_checkpoint(tmp_path, g, wal_lsn=41)
        ckpt = load_checkpoint(str(tmp_path))
        assert ckpt.wal_lsn == 41
        g2 = restore_graph(ckpt)
        _same_graph(g, g2)
        _assert_same_samples(g, g2)

    @pytest.mark.parametrize("with_ts", [False, True])
    def test_files_are_jax_bytes_and_restore_both_ways(self, tmp_path,
                                                       with_ts):
        gp, gj = _mutated(with_ts=with_ts), _mutated(True, with_ts)
        pp = save_checkpoint(tmp_path / "p", gp, wal_lsn=17)
        pj = jckpt.save_checkpoint(str(tmp_path / "j"), gj, wal_lsn=17)
        assert os.path.basename(pp) == os.path.basename(pj)
        assert Path(pp).read_bytes() == Path(pj).read_bytes()
        from_jax = restore_graph(read_checkpoint(pj))
        from_port = jckpt.restore_graph(jckpt.read_checkpoint(pp))
        _same_graph(from_jax, gp)
        _same_graph(from_port, gj)
        _assert_same_samples(from_jax, from_port)

    def test_on_disk_dtypes_are_endianness_pinned(self, tmp_path):
        path = save_checkpoint(tmp_path, _mutated(), wal_lsn=0)
        raw = open(path, "rb").read()
        prefix = struct.Struct("<4sII")
        magic, fmt, hdr_len = prefix.unpack_from(raw)
        assert magic == b"QCKP" and fmt == CHECKPOINT_FORMAT
        header = json.loads(raw[prefix.size:prefix.size + hdr_len])
        assert header["arrays"]
        assert all(s["dtype"].startswith("<") for s in header["arrays"])
        assert header["crc"] == blockio.crc32c(raw[prefix.size + hdr_len:])
        assert header["crc"] == blockio.crc32c_plain(
            raw[prefix.size + hdr_len:])

    def test_version_skew_is_typed_refusal(self, tmp_path):
        path = save_checkpoint(tmp_path, _mutated(), wal_lsn=0)
        raw = bytearray(open(path, "rb").read())
        struct.pack_into("<I", raw, 4, CHECKPOINT_FORMAT + 13)
        blockio.atomic_publish(path, bytes(raw))
        with pytest.raises(SnapshotFormatError, match="not supported"):
            read_checkpoint(path)

    def test_corrupt_body_and_bad_magic_refuse(self, tmp_path):
        path = save_checkpoint(tmp_path, _mutated(), wal_lsn=0)
        raw = bytearray(open(path, "rb").read())
        raw[-1] ^= 0xFF
        blockio.atomic_publish(path, bytes(raw))
        with pytest.raises(SnapshotFormatError, match="checksum"):
            read_checkpoint(path)
        blockio.atomic_publish(path, b"PKZZ" + bytes(raw[4:]))
        with pytest.raises(SnapshotFormatError, match="magic"):
            read_checkpoint(path)
        blockio.atomic_publish(path, b"QC")
        with pytest.raises(SnapshotFormatError):
            read_checkpoint(path)

    def test_load_falls_back_past_corrupt_newest(self, tmp_path):
        g = _mutated()
        good = save_checkpoint(tmp_path, g, wal_lsn=5)
        g.add_edges([3], [9])
        newest = save_checkpoint(tmp_path, g, wal_lsn=9)
        assert newest != good
        raw = bytearray(open(newest, "rb").read())
        raw[-1] ^= 0xFF
        blockio.atomic_publish(newest, bytes(raw))
        ckpt = load_checkpoint(str(tmp_path))
        assert ckpt.path == good and ckpt.wal_lsn == 5
        assert counter("recovery_checkpoint_load_errors_total") == 1

    def test_all_corrupt_raises_not_none(self, tmp_path):
        path = save_checkpoint(tmp_path, _mutated(), wal_lsn=0)
        blockio.atomic_publish(path, b"QCKPgarbage")
        with pytest.raises(SnapshotFormatError):
            load_checkpoint(str(tmp_path))
        assert load_checkpoint(str(tmp_path / "empty")) is None

    def test_retention_prunes_old_snapshots(self, tmp_path):
        g = _graph()
        for i in range(4):
            g.add_edges([i], [i + 2])
            save_checkpoint(tmp_path, g, wal_lsn=i, keep=2)
        assert len([n for n in os.listdir(tmp_path)
                    if n.endswith(".qgr")]) == 2


# ---------------------------------------------------------------- coldcache
def _features(jax_side, feats, paged=False):
    F = JaxFeature if jax_side else qt.Feature
    kw = {} if jax_side else dict(device="cpu")
    f = F(device_cache_size=16, cache_unit="rows", **kw).from_cpu_tensor(
        feats)
    if paged:
        f.enable_paging(page_rows=4, pool_pages=4)
    else:
        f.enable_cold_cache(rows=8, admit_threshold=1)
    return f


class TestColdcacheState:
    def test_cache_state_round_trip_matches_jax(self):
        states = []
        for C in (ColdRowCache, JaxColdRowCache):
            c = C(capacity=8, n_rows=100, admit_threshold=2)
            ids = np.array([3, 7, 11], dtype=np.int64)
            for _ in range(2):
                hit, _ = c.probe(ids)
                c.admit(ids[~hit])
            states.append(c.export_state())
        assert states[0].keys() == states[1].keys()
        for k, v in states[0].items():
            np.testing.assert_array_equal(v, states[1][k], err_msg=k)
            assert type(v) is type(states[1][k]) or isinstance(v, np.ndarray)
        c2 = ColdRowCache(capacity=8, n_rows=100, admit_threshold=2)
        c2.restore_state(states[1])  # JAX's state restores in the port
        hit, _ = c2.probe(np.array([3, 7, 11]))
        assert hit.all() and c2.hand == states[1]["hand"]
        assert c2.resident_bytes(24) == 3 * 24

    def test_geometry_mismatch_refuses(self):
        state = ColdRowCache(capacity=8, n_rows=100).export_state()
        with pytest.raises(ValueError, match="capacity"):
            ColdRowCache(capacity=4, n_rows=100).restore_state(state)
        with pytest.raises(ValueError, match="cold-row"):
            ColdRowCache(capacity=8, n_rows=50).restore_state(state)

    @pytest.mark.parametrize("paged", [False, True])
    def test_feature_restore_refills_rows_of_a_fresh_gather(self, paged):
        feats = np.random.default_rng(3).standard_normal(
            (64, 8)).astype(np.float32)
        f = _features(False, feats, paged)
        hot_ids = np.array([40, 41, 42, 43, 50], dtype=np.int64)
        for _ in range(3):
            f[hot_ids]
        state = f.export_coldcache_state()
        assert state is not None and (state["node_of"] >= 0).any()
        assert state.get("kind") == ("paged" if paged else None)
        f2 = _features(False, feats, paged)
        warmed = f2.restore_coldcache_state(state)
        per = 4 if paged else 1
        assert warmed == int((state["node_of"] >= 0).sum()) * per
        if paged:
            fresh, got = f.paged.frames, f2.paged.frames
        else:
            fresh, got = f._overlay, f2._overlay
        assert torch.equal(got, fresh)  # bitwise the gathered values
        before = (ptel.snapshot()["counters"].get(
            "feature_page_faults_total", 0) if paged
            else f2.cold_cache.hits)
        out = f2[hot_ids]
        assert torch.equal(out, torch.from_numpy(feats[hot_ids]))
        after = (ptel.snapshot()["counters"].get(
            "feature_page_faults_total", 0) if paged
            else f2.cold_cache.hits)
        assert after == before if paged else after > before

    def test_overlay_state_and_checkpoint_bytes_match_jax(self, tmp_path):
        feats = np.random.default_rng(4).standard_normal(
            (64, 8)).astype(np.float32)
        ids = np.array([40, 41, 42, 43, 60, 61], dtype=np.int64)
        paths = []
        for jax_side, save, d in ((False, save_checkpoint, "p"),
                                  (True, jckpt.save_checkpoint, "j")):
            f = _features(jax_side, feats)
            for _ in range(3):
                f[ids]
            g = _mutated(jax_side)
            paths.append(save(str(tmp_path / d), g, wal_lsn=3,
                              coldcaches={"feat": f.export_coldcache_state()}))
        assert Path(paths[0]).read_bytes() == Path(paths[1]).read_bytes()
        f2 = _features(False, feats)
        warmed = f2.restore_coldcache_state(
            read_checkpoint(paths[1]).coldcaches["feat"])
        assert warmed == 6
        assert torch.equal(f2[ids], torch.from_numpy(feats[ids]))

    def test_paged_state_into_unpaged_build_starts_cold(self):
        feats = np.random.default_rng(5).standard_normal(
            (64, 8)).astype(np.float32)
        f = _features(False, feats, paged=True)
        f[np.array([40, 50])]
        state = f.export_coldcache_state()
        assert _features(False, feats).restore_coldcache_state(state) == 0
        assert qt.Feature(device_cache_size=64, cache_unit="rows",
                          device="cpu").from_cpu_tensor(
            feats).restore_coldcache_state(None) == 0


# ---------------------------------------------------------------- ingest
class TestDurableIngest:
    def test_ack_implies_durable_and_replayable(self, tmp_path):
        g = _graph()
        wal = WriteAheadLog(tmp_path / "wal", fsync="always")
        lane = IngestLane(g, wal=wal).start()
        for i in range(6):
            lane.submit([i], [(i + 7) % 64])
        assert all(o[0] == "ok" for _, o in _drain(lane, 6))
        lane.stop()
        for W, G, topo in ((WriteAheadLog, StreamingGraph, _ring()),
                           (jwal.WriteAheadLog, JaxGraph, _ring(64, True))):
            w2 = W(tmp_path / "wal")
            g2 = G(topo, delta_capacity=512)
            decode = (decode_edge_op if W is WriteAheadLog
                      else jwal.decode_edge_op)
            for _lsn, payload in w2.replay():
                op, src, dst, _ts = decode(payload)
                g2.add_edges(src, dst) if op == "add" \
                    else g2.remove_edges(src, dst)
            _assert_same_samples(g, g2)
            w2.close()
        wal.close()

    def test_wal_fault_answers_request_and_skips_apply(self, tmp_path):
        g = _graph()
        wal = WriteAheadLog(tmp_path / "wal", fsync="always")
        lane = IngestLane(g, wal=wal).start()
        v0 = g.version
        chaos.install(chaos.ChaosPlan(seed=1).fail(
            "recovery.fsync", exc=OSError("dead disk"), times=1))
        lane.submit([1], [2])
        _item, out = lane.results.get(timeout=10)
        assert isinstance(out, WALWriteError)
        assert g.version == v0
        lane.submit([1], [2])
        assert lane.results.get(timeout=10)[1][0] == "ok"
        lane.stop()
        wal.close()

    def test_volatile_lane_unchanged_without_wal(self):
        lane = IngestLane(_graph()).start()
        lane.submit([0], [9])
        assert lane.results.get(timeout=10)[1][0] == "ok"
        lane.stop()


# ---------------------------------------------------------------- manager
def _factory(cap=512):
    return lambda: StreamingGraph(_ring(), delta_capacity=cap)


def _ingest(mgr, ops, **lane_kw):
    g = mgr.graph
    lane = IngestLane(g, **lane_kw).start()
    mgr.attach_lane(lane)
    for src, dst, op in ops:
        lane.submit(src, dst, op=op)
    outs = _drain(lane, len(ops))
    return lane, outs


class TestRecoveryManager:
    def test_boot_cycle_and_replay_equivalence(self, tmp_path):
        root = str(tmp_path / "r")
        mgr = RecoveryManager(root, graph_factory=_factory())
        g = mgr.boot()
        ops = [([i], [(i + 3) % 64], "add") for i in range(5)]
        lane, outs = _ingest(mgr, ops + [([1], [2], "remove")])
        assert all(o[0] == "ok" for _, o in outs)
        lane.stop()
        mgr.close()
        mgr2 = RecoveryManager(root, graph_factory=_factory())
        g2 = mgr2.boot()
        assert mgr2.state == "serving"
        _same_graph(g, g2)
        _assert_same_samples(g, g2)
        mgr2.close()
        # JAX's manager replays the port's log to the same graph
        jm = jmanager.RecoveryManager(
            root, graph_factory=lambda: JaxGraph(_ring(64, True),
                                                 delta_capacity=512))
        jg = jm.boot()
        _same_graph(g, jg)
        jm.close()

    def test_checkpoint_barrier_truncates_replay(self, tmp_path):
        root = str(tmp_path / "r")
        mgr = RecoveryManager(root, graph_factory=_factory())
        g = mgr.boot()
        lane, _ = _ingest(mgr, [([i], [i + 9], "add") for i in range(4)])
        path = mgr.checkpoint()
        assert os.path.basename(path) == f"ckpt-{g.version:012d}.qgr"
        for i in range(2):
            lane.submit([i + 20], [i + 30])
        _drain(lane, 2)
        lane.stop()
        mgr.close()
        mgr2 = RecoveryManager(root, graph_factory=_factory())
        g2 = mgr2.boot()
        assert mgr2.health()["replayed_records"] == 2
        _same_graph(g, g2)
        mgr2.close()

    def test_boot_survives_torn_and_corrupt_wal(self, tmp_path):
        root = str(tmp_path / "r")
        mgr = RecoveryManager(root, graph_factory=_factory())
        mgr.boot()
        lane, _ = _ingest(mgr, [([i], [i + 1], "add") for i in range(4)])
        lane.stop()
        mgr.close()
        wal_root = os.path.join(root, "wal")
        seg = os.path.join(wal_root, sorted(os.listdir(wal_root))[0])
        with open(seg, "rb+") as f:
            f.seek(blockio.RECORD_HEADER_SIZE)
            b = f.read(1)
            f.seek(blockio.RECORD_HEADER_SIZE)
            f.write(bytes([b[0] ^ 0xFF]))
            f.truncate(os.path.getsize(seg) - 3)
        mgr2 = RecoveryManager(root, graph_factory=_factory())
        g2 = mgr2.boot()
        assert mgr2.state == "serving"
        assert counter("recovery_wal_corrupt_records_total") == 1
        assert counter("recovery_wal_torn_tails_total") == 1
        assert g2.version == 2
        mgr2.close()

    def test_nacked_apply_is_aborted_not_replayed(self, tmp_path):
        root = str(tmp_path / "r")
        mgr = RecoveryManager(root, graph_factory=_factory(cap=2))
        g = mgr.boot()
        lane, outs = _ingest(mgr, [([1], [2], "add"), ([3], [4], "add")],
                             compact_on_full=False)
        lane.submit([5], [6])
        assert isinstance(lane.results.get(timeout=10)[1], BufferError)
        assert counter("recovery_wal_abort_records_total") == 1
        live_version = g.version
        lane.stop()
        mgr.close()
        mgr2 = RecoveryManager(root, graph_factory=_factory(cap=2))
        g2 = mgr2.boot()
        assert counter("recovery_replay_aborted_total") == 1
        assert g2.version == live_version == 2
        _same_graph(g, g2)
        mgr2.close()

    def test_replay_deadline_is_typed(self, tmp_path):
        root = str(tmp_path / "r")
        mgr = RecoveryManager(root, graph_factory=_factory())
        mgr.boot()
        lane, _ = _ingest(mgr, [([0], [1], "add")])
        lane.stop()
        mgr.close()
        with pconfig.override(recovery_deadline_s=1e-9):
            mgr2 = RecoveryManager(root, graph_factory=_factory())
            mgr2.boot_degraded()
            with pytest.raises(RecoveryDeadlineExceeded):
                mgr2.finish_boot()
        assert counter("recovery_deadline_exceeded_total") == 1
        mgr2.close()

    def test_health_ladder_and_staleness(self, tmp_path):
        assert health_status() == {"state": "serving", "ready": True,
                                   "stale": False, "managed": False}
        mgr = RecoveryManager(str(tmp_path / "r"), graph_factory=_factory())
        mgr.boot_degraded()
        h = health_status()
        assert h["managed"] and h["state"] == "replaying"
        assert h["stale"] and not h["ready"]
        seen = []
        mgr.finish_boot(warmup=lambda g: seen.append(mgr.state))
        assert seen == ["warming"]
        h = health_status()
        assert h["ready"] and h["state"] == "serving" and not h["stale"]
        assert h["graph_version"] == 0 and h["wal_next_lsn"] == 0
        mgr.close()
        assert not health_status()["managed"]

    def test_no_root_and_no_factory_refuse(self, tmp_path):
        with pconfig.override(recovery_dir=""):
            with pytest.raises(RecoveryError, match="durability root"):
                RecoveryManager()
        with pconfig.override(recovery_dir=str(tmp_path / "env")):
            assert RecoveryManager().root == str(tmp_path / "env")
        mgr = RecoveryManager(str(tmp_path / "r"))
        with pytest.raises(RecoveryError, match="graph_factory"):
            mgr.boot_degraded()

    def test_periodic_checkpointer_reaps(self, tmp_path):
        mgr = RecoveryManager(str(tmp_path / "r"), graph_factory=_factory())
        mgr.boot()
        mgr.start_checkpointer(interval_s=0.05)
        ckpt_dir = os.path.join(str(tmp_path / "r"), "ckpt")
        deadline = time.time() + 5
        while time.time() < deadline and not os.listdir(ckpt_dir):
            time.sleep(0.02)
        assert os.listdir(ckpt_dir)
        mgr.close()
        assert mgr._ckpt_thread is None
        assert counter("serving_thread_leak_total",
                       component="recovery.checkpointer") == 0

    def test_attach_feature_restores_its_checkpointed_state(self, tmp_path):
        root = str(tmp_path / "r")
        feats = np.random.default_rng(6).standard_normal(
            (64, 8)).astype(np.float32)
        f = _features(False, feats)
        ids = np.array([40, 41, 50], dtype=np.int64)
        for _ in range(2):
            f[ids]
        mgr = RecoveryManager(root, graph_factory=_factory())
        mgr.boot()
        assert mgr.attach_feature("feat", f) == 0  # nothing to restore yet
        mgr.checkpoint()
        mgr.close()
        mgr2 = RecoveryManager(root, graph_factory=_factory())
        mgr2.boot()
        f2 = _features(False, feats)
        assert mgr2.attach_feature("feat", f2) == 3
        assert counter("recovery_coldcache_rows_restored_total") == 3
        assert torch.equal(f2._overlay, f._overlay)
        mgr2.close()

    def test_adopt_folds_only_past_the_applied_watermark(self, tmp_path):
        root = str(tmp_path / "r")
        mgr = RecoveryManager(root, graph_factory=_factory())
        g = mgr.boot()
        lane, _ = _ingest(mgr, [([i], [i + 5], "add") for i in range(5)])
        lane.stop()
        mgr.close()
        follower = _factory()()
        for i in range(3):  # a follower that applied LSNs 0..2
            follower.add_edges([i], [i + 5])
        mgr2 = RecoveryManager(root, graph_factory=_factory())
        assert mgr2.adopt(follower, applied_lsn=2) == 2
        assert mgr2.state == "serving" and mgr2.graph is follower
        _same_graph(g, follower)
        mgr2.close()


# ---------------------------------------------------------------- registry
class TestProgramRegistry:
    def test_counts_hits_misses_builds(self):
        reg = get_program_registry()
        c = reg.cache("t_unit")
        assert c.get("k") is None
        c["k"] = "prog"
        assert "k" in c and c["k"] == "prog"
        assert c.get("k") == "prog"
        st = reg.stats()["t_unit"]
        assert st["builds"] == 1 and st["hits"] == 2 and st["misses"] == 1
        assert counter("registry_builds_total", subsystem="t_unit") == 1
        assert counter("registry_hits_total", subsystem="t_unit") == 2
        assert counter("registry_misses_total", subsystem="t_unit") == 1
        assert reg.export_metrics()["t_unit"]["size"] == 1
        gauges = ptel.snapshot()["gauges"]
        assert gauges[metric_key("registry_programs_total",
                                 {"subsystem": "t_unit"})] == 1.0

    def test_setdefault_builds_once(self):
        reg = get_program_registry()
        c = reg.cache("t_setdefault")
        assert c.setdefault("b", 1) == 1
        assert c.setdefault("b", 2) == 1
        assert reg.stats()["t_setdefault"]["builds"] == 1

    def test_seal_budget_gates_late_builds(self):
        reg = get_program_registry()
        c = reg.cache("t_seal")
        c["warm"] = 1
        reg.seal(budget=1)
        assert ptel.snapshot()["gauges"][
            metric_key("registry_sealed_state", {})] == 1.0
        c["one-late-build-allowed"] = 2
        with pytest.raises(RetraceBudgetExceeded):
            c["second-late-build"] = 3
        assert counter("registry_retraces_post_seal_total",
                       subsystem="t_seal") == 2
        reg.unseal()
        c["fine-again"] = 4
        with pconfig.override(recovery_retrace_budget=-1):
            reg.seal()  # count only
            c["counted-not-raised"] = 5
        reg.unseal()

    def test_sampler_entries_are_registered_under_jax_keys(self):
        reg = get_program_registry()
        g = _graph()
        s = qt.GraphSageSampler(g, [5, 3], device="cpu", gather_mode="xla")
        before = reg.stats()["sampler"]
        for i in range(2):
            s.sample(np.arange(4), key_words=_words(make_key(i), 2))
        st = reg.stats()["sampler"]
        assert st["builds"] - before["builds"] == 1
        assert st["hits"] - before["hits"] >= 1
        assert list(s._programs) == [("stream", 4, 128, 128, False, False)]
        frozen = qt.GraphSageSampler(_ring(), [5, 3], device="cpu")
        before = reg.stats()["sampler"]
        frozen.sample(np.arange(6))  # a frozen pipeline: JAX's key B
        frozen.sample(np.arange(6))
        assert list(frozen._programs) == [6]
        st = reg.stats()["sampler"]
        assert st["builds"] - before["builds"] == 1
        assert st["hits"] - before["hits"] == 1

    def test_native_library_is_a_build_and_seal_refuses_a_late_one(
            self, tmp_path, monkeypatch):
        """A library loaded after ``seal(budget=0)`` fails as a cold
        compile fails in JAX; one already loaded is a hit."""
        reg = get_program_registry()
        blockio.crc32c(b"warm")
        src = tmp_path / "late_lib.cpp"
        src.write_text('extern "C" int qt_late() { return 7; }\n')
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
        reg.seal(budget=0)
        assert blockio.crc32c(b"123456789") == 0xE3069283  # no build
        with pytest.raises(RetraceBudgetExceeded):
            native.load(src, lambda lib: None)
        assert counter("registry_retraces_post_seal_total",
                       subsystem="native") == 1

    def test_persistent_cache_is_the_build_directory(self, tmp_path,
                                                     monkeypatch):
        """``enable_persistent_cache(dir)`` builds into ``dir``;
        ``persistent_cache_hits`` counts libraries found there built."""
        reg = get_program_registry()
        src = tmp_path / "pc_lib.cpp"
        src.write_text('extern "C" int qt_pc() { return 3; }\n')
        cache = tmp_path / "pcache"
        assert reg.enable_persistent_cache(str(cache))
        assert reg.persistent_cache_dir == str(cache)
        hits = reg.persistent_cache_hits
        lib = native.load(src, lambda lib: None)
        assert lib.qt_pc() == 3
        assert native._library_path(src).parent == cache
        assert reg.persistent_cache_hits == hits
        monkeypatch.delitem(native._libs, "pc_lib")
        native.load(src, lambda lib: None)
        assert reg.persistent_cache_hits == hits + 1
        from quiver_tpu_torch.ops.cuda import build
        assert build._lib_path("window_sample").parent == cache
        reg.disable_persistent_cache()
        assert build._lib_path("window_sample").parent == build.BUILD_DIR

    def test_boot_enables_the_configured_cache(self, tmp_path):
        with pconfig.override(recovery_cache_dir=str(tmp_path / "cc")):
            mgr = RecoveryManager(str(tmp_path / "r"),
                                  graph_factory=_factory())
            mgr.boot(seal=True)
        reg = get_program_registry()
        assert reg.persistent_cache_dir == str(tmp_path / "cc")
        assert reg.sealed
        mgr.close()


# ---------------------------------------------------------------- /healthz
class TestMetricsEndpoint:
    def test_healthz_503_while_replaying_200_serving(self, tmp_path):
        from urllib.error import HTTPError
        from urllib.request import urlopen

        from quiver_tpu_torch.telemetry.export import start_http_server

        srv = start_http_server()
        try:
            doc = json.loads(urlopen(f"{srv.url}/healthz", timeout=5).read())
            assert doc["ready"] and not doc["managed"]
            mgr = RecoveryManager(str(tmp_path / "r"),
                                  graph_factory=_factory())
            mgr.boot_degraded()
            with pytest.raises(HTTPError) as ei:
                urlopen(f"{srv.url}/healthz", timeout=5)
            assert ei.value.code == 503
            body = json.loads(ei.value.read())
            assert body["state"] == "replaying" and body["stale"]
            mgr.finish_boot()
            doc = json.loads(urlopen(f"{srv.url}/healthz", timeout=5).read())
            assert doc["ready"] and doc["state"] == "serving"
            mgr.close()
        finally:
            srv.close()


# ---------------------------------------------------------------- kill -9
N_NODES = 64
_CHILD = r"""
import sys
import numpy as np
from quiver_tpu_torch.recovery.manager import RecoveryManager
from quiver_tpu_torch.resilience import chaos
from quiver_tpu_torch.stream import IngestLane, StreamingGraph
from quiver_tpu_torch.utils.topology import CSRTopo

root, n = sys.argv[1], int(sys.argv[2])
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "flax", "optax", "quiver_tpu")]
print("MODULES", ",".join(bad) or "-", flush=True)

def factory():
    src = np.arange(n, dtype=np.int64)
    return StreamingGraph(CSRTopo(edge_index=np.stack([src, (src + 1) % n])),
                          delta_capacity=4096)

chaos.install(chaos.ChaosPlan(seed=1234).fail(
    "recovery.fsync", exc=OSError("chaos: disk hiccup"),
    times=2, after=7, every=9))
mgr = RecoveryManager(root, graph_factory=factory)
g = mgr.boot()
lane = IngestLane(g).start()
mgr.attach_lane(lane)
print("READY", flush=True)
i = 0
while True:
    lane.submit([i % n], [(i * 7 + 3) % n])
    _item, out = lane.results.get(timeout=30)
    if isinstance(out, tuple) and out[0] == "ok":
        print(f"ACK {i} {g.version}", flush=True)
    else:
        print(f"NACK {i} {type(out).__name__}", flush=True)
    i += 1
"""


def test_sigkill_loses_no_acked_edges(tmp_path):
    """A child that imports only the port acks edge ops under transient
    fsync faults and is killed with SIGKILL; the recovered graph holds
    every acked op, is the deterministic op prefix of its version, and
    JAX's manager recovers the same graph from the same root."""
    root = str(tmp_path / "r")
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1")
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, root,
                             str(N_NODES)], cwd=str(REPO), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    acked, nacked = [], 0
    try:
        assert proc.stdout.readline().strip() == "MODULES -"
        assert proc.stdout.readline().strip() == "READY", proc.stderr.read()
        deadline = time.time() + 120
        while len(acked) < 25:
            assert time.time() < deadline, "child too slow"
            line = proc.stdout.readline()
            assert line, "child died early: " + proc.stderr.read()
            parts = line.split()
            if parts[0] == "ACK":
                acked.append((int(parts[1]), int(parts[2])))
            else:
                nacked += 1
    finally:
        if proc.poll() is None:
            os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    assert proc.returncode == -signal.SIGKILL
    assert nacked >= 1, "the chaos plan never fired"

    def make():
        src = np.arange(N_NODES, dtype=np.int64)
        return StreamingGraph(qt.CSRTopo(edge_index=np.stack(
            [src, (src + 1) % N_NODES])), delta_capacity=4096)

    mgr = RecoveryManager(root, graph_factory=make)
    g = mgr.boot()
    version = int(g.version)
    assert version >= acked[-1][1]
    assert version > max(i for i, _v in acked)
    ref = make()
    for i in range(version):
        ref.add_edges([i % N_NODES], [(i * 7 + 3) % N_NODES])
    _same_graph(ref, g)
    _assert_same_samples(ref, g)
    mgr.close()
    jm = jmanager.RecoveryManager(root, graph_factory=lambda: JaxGraph(
        _ring(N_NODES, True), delta_capacity=4096))
    _same_graph(g, jm.boot())
    jm.close()
