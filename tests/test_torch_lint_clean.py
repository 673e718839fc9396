"""The port must lint clean under its own gate.

Pre-existing, justified findings live in ``quiverlint_torch.baseline.json``
(only the counterpart of the JAX package's one baselined entry); anything
new fails here.  The injected-violation cases prove the gate has teeth
end to end (``python -m`` exit codes): every violation goes into one copy
of the port, which the CLI lints once, and each case finds its own.
"""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from quiver_tpu_torch.analysis import analyze_paths
from quiver_tpu_torch.analysis import baseline as baseline_mod

REPO = Path(__file__).resolve().parents[1]
TARGET = "quiver_tpu_torch"
BASELINE = REPO / baseline_mod.DEFAULT_BASELINE_NAME

# (file, rule, appended source): one violation a rule, each in its own
# function or class so the cases cannot mask one another
INJECTED = [
    ("quiver_tpu_torch/sampler.py", "QT001",
     "\n\ndef _leaky(x):\n"
     "    return x.cpu()\n"),
    ("quiver_tpu_torch/ops/paged.py", "QT001",
     "\n\ndef _pageable(a, dev):\n"
     "    return torch.from_numpy(a).to(dev)\n"),
    ("quiver_tpu_torch/resilience/lanes.py", "QT003",
     "\n\nclass _InjGuarded:\n"
     "    _guarded_by = {\"_items\": \"_lock\"}\n"
     "\n"
     "    def __init__(self):\n"
     "        self._lock = threading.Lock()\n"
     "        self._items = []\n"
     "\n"
     "    def add(self, x):\n"
     "        self._items.append(x)\n"),
    ("quiver_tpu_torch/mixed.py", "QT004",
     "\n\nimport http.server  # noqa: E402\n"),
    ("quiver_tpu_torch/uva.py", "QT005",
     "\n\ndef _inj_defaults(xs=[]):\n"
     "    return xs\n"),
    ("quiver_tpu_torch/feature.py", "QT008",
     "\n\ndef _racy_publish(feat: \"Feature\"):\n"
     "    feat.hot = None\n"),
    ("quiver_tpu_torch/serving.py", "QT009",
     "\n\nclass _Inverted:\n"
     "    def __init__(self):\n"
     "        self._qa = threading.Lock()\n"
     "        self._qb = threading.Lock()\n"
     "\n"
     "    def fwd(self):\n"
     "        with self._qa:\n"
     "            with self._qb:\n"
     "                pass\n"
     "\n"
     "    def bwd(self):\n"
     "        with self._qb:\n"
     "            with self._qa:\n"
     "                pass\n"),
    ("quiver_tpu_torch/neighbour_num.py", "QT006",
     "\n\ndef _bad_metric(bucket):\n"
     "    from . import telemetry\n"
     "    telemetry.counter(f\"serving_bucket_{bucket}_total\").inc()\n"),
    ("quiver_tpu_torch/stream/ingest.py", "QT007",
     "\n\ndef _doomed_loop(q):\n"
     "    while True:\n"
     "        try:\n"
     "            q.get()\n"
     "        except Exception:\n"
     "            continue\n"),
    ("quiver_tpu_torch/fleet/router.py", "QT010",
     "\n\nclass _InjOrphan:\n"
     "    def start(self):\n"
     "        self._t = threading.Thread(target=self._run_orphan)\n"
     "        self._t.start()\n"
     "\n"
     "    def _run_orphan(self):\n"
     "        return None\n"),
    ("quiver_tpu_torch/recovery/wal.py", "QT011",
     "\n\ndef _sneaky_sidecar(path):\n"
     "    with open(path, \"w\") as f:\n"
     "        f.write(\"unframed, unchecksummed\")\n"),
    ("quiver_tpu_torch/parallel/train.py", "QT012",
     "\n\ndef _wall_timed(fn):\n"
     "    import time\n"
     "    t0 = time.time()\n"
     "    fn()\n"
     "    return time.time() - t0\n"),
    ("quiver_tpu_torch/loader.py", "QT002",
     "\n\ndef _retracey(f, xs):\n"
     "    for x in xs:\n"
     "        x = torch.compile(f)(x)\n"
     "    return x\n"),
    # the card value crosses a function boundary, so QT001's local
    # tracking can't see it — only the staging dataflow can
    ("quiver_tpu_torch/sampler.py", "QT013",
     "\n\ndef _inj_gather_scores(xs):\n"
     "    return torch.as_tensor(xs, device=\"cuda\").sum()\n"
     "\n"
     "def _inj_mean_score(xs):\n"
     "    return float(_inj_gather_scores(xs)) / max(len(xs), 1)\n"),
    # float psum in a bit-exactness module (mesh/*): the order of the
    # additions varies with the shard layout
    ("quiver_tpu_torch/mesh/sampler.py", "QT015",
     "\n\ndef _inj_allsum(outs):\n"
     "    return psum([o.float() for o in outs])\n"),
    ("quiver_tpu_torch/hetero.py", "QT014",
     "\n\nfrom .recovery.registry import program_cache  # noqa: E402\n"
     "\n"
     "class _InjExecCache:\n"
     "    def __init__(self):\n"
     "        self._fns = program_cache(\"inj\", owner=self)\n"
     "\n"
     "    def get(self, ids):\n"
     "        n = int(ids.shape[0])\n"
     "        if n not in self._fns:\n"
     "            self._fns[n] = object()\n"
     "        return self._fns[n]\n"),
]


def _cli(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "QUIVER_SANITIZE"}
    return subprocess.run(
        [sys.executable, "-m", "quiver_tpu_torch.analysis", TARGET, *args],
        capture_output=True, text=True, timeout=300, cwd=str(cwd),
        env=dict(env, PYTHONPATH=str(REPO)))


# a waiver that suppresses nothing: stale, and a failure only under
# --strict-baseline
STALE_SYNC_OK = ("quiver_tpu_torch/serving.py",
                 "\n\ndef _nothing_syncs_here(xs):\n"
                 "    # quiverlint: sync-ok[left behind after a refactor]\n"
                 "    return sum(xs)\n")


def test_port_lints_clean_against_baseline():
    result = analyze_paths([TARGET], root=REPO)
    assert result.errors == []
    baseline = baseline_mod.load(BASELINE)
    new, known = baseline_mod.partition(result.findings, baseline)
    assert new == [], "new quiverlint findings:\n" + "\n".join(
        f.format() for f in new)
    # the baseline holds only the counterpart of JAX's one entry
    assert [(f.rule, f.path, f.scope) for f in baseline] == [
        ("QT001", "quiver_tpu_torch/parallel/prefetch.py",
         "AsyncNeighborSampler.sample")]
    assert baseline_mod.stale(result.findings, baseline) == []
    assert result.stale_sync_ok == []
    # every waiver the port carries is a reasoned one
    for f in result.suppressed:
        line = _directive_of(f)
        assert "--" in line or re.search(r"sync-ok\[[^\]]*\w", line), \
            f"waiver without a reason: {f.format()}"


def _directive_of(f):
    lines = (REPO / f.path).read_text().splitlines()
    i = f.line - 1
    while i >= 0 and "quiverlint: ignore[" not in lines[i] and not (
            f.rule == "QT013" and "quiverlint: sync-ok[" in lines[i]):
        i -= 1
    assert i >= 0, f"no directive above {f.format()}"
    return lines[i]


def test_cli_strict_baseline_exits_zero_on_the_port():
    proc = _cli(REPO, "--strict-baseline")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 new finding(s), 1 baselined" in proc.stdout


@pytest.fixture(scope="module")
def injected(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_copy")
    shutil.copytree(REPO / TARGET, root / TARGET,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BASELINE, root / BASELINE.name)
    spans = {}      # case index -> (relpath, first line, last line)
    for i, (relpath, _, appended) in enumerate(INJECTED + [
            STALE_SYNC_OK[:1] + (None,) + STALE_SYNC_OK[1:]]):
        target = root / relpath
        text = target.read_text()
        first = len(text.splitlines()) + 1
        target.write_text(text + appended)
        spans[i] = (relpath, first, len((text + appended).splitlines()))
    proc = _cli(root, "--strict-baseline", "--format", "json")
    return proc, spans


def test_injected_violations_fail_the_cli(injected):
    proc, spans = injected
    assert proc.returncode == 1, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["stale"] == [] and doc["rule_hash_mismatch"] == []
    assert len(doc["baselined"]) == 1
    # the stale waiver is reported where it was appended, and only it
    relpath, first, last = spans[len(INJECTED)]
    assert [(s["path"], first <= s["line"] <= last, s["reason"])
            for s in doc["stale_sync_ok"]] == [
        (relpath, True, "left behind after a refactor")]
    assert {f["rule"] for f in doc["findings"]} == {
        code for _, code, _ in INJECTED}


@pytest.mark.parametrize("relpath, code, appended", INJECTED,
                         ids=[f"{c}-{p.split('/')[-1]}"
                              for p, c, _ in INJECTED])
def test_each_injected_violation_is_found(injected, relpath, code,
                                          appended):
    proc, spans = injected
    doc = json.loads(proc.stdout)
    i = next(i for i, case in enumerate(INJECTED)
             if case == (relpath, code, appended))
    path, first, last = spans[i]
    # a finding in the case's own lines, or one elsewhere in its file
    # outside every case's lines (a race is reported at the access it
    # races with)
    others = [(a, b) for p, a, b in spans.values() if p == path]
    hits = [f for f in doc["findings"] if f["path"] == path and (
        first <= f["line"] <= last
        or not any(a <= f["line"] <= b for a, b in others))]
    assert [f["rule"] for f in hits] == [code], doc["findings"]
