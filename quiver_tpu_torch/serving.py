"""GNN serving on the card (counterpart of ``quiver_tpu/serving.py``).

Stages are threads in one process sharing ``queue.Queue``s: a
:class:`RequestBatcher` routes client streams onto the device lane or the
CPU lane, a :class:`HybridSampler` samples the CPU lane's requests on the
host, and an :class:`InferenceServer` runs both lanes.  Its device thread
drains the device lane, coalesces queued requests into one pass, pads the
pass to a bucketed batch size and runs it through one of two forms:

  * fused, when the feature holds the whole table on the device: sample
    -> ``lookup_device`` -> model, with one host sync per chunk;
  * unfused, for a budgeted feature: sample on the device, read ``n_id``
    back once, gather through ``Feature.__getitem__`` (the staged merge,
    the overlay or the paged store), then the model.  The server turns
    the cold-row overlay on for such a feature, as the JAX package does.

Bucketing is kept although CUDA kernels take any shape: the hop-2 hash
counters are ``b*k + j`` over a frontier whose length follows the padded
batch, so the padding is part of what a pass computes for given key words.
Each pass draws its key words from the server's own seeded generator.

Its CPU thread takes the host sampler's batches (already padded to a
bucket) and runs ``feature[n_id]`` (kernel B2 for a whole-table feature)
and the model, sliced to the request's length.  ``"Auto"`` routing sends a
request to the CPU lane when the sum of ``neighbour_num`` over its ids is
at most ``threshold``; :func:`calibrate_threshold` measures both lanes to
pick one.

Not ported yet (ROADMAP A11): deadlines, shedding lanes, breakers and
failover (``cpu_sampler=``), chaos points, QoS (``qos=``), the flight
recorder and the timeline.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from .config import get_config
from .feature import Feature
from .sampler import GraphSageSampler
from .telemetry import Counter, Histogram
from .utils.shutdown import join_and_reap

__all__ = ["RequestBatcher", "HybridSampler", "InferenceServer",
           "InferenceServer_Debug", "ServingRequest", "calibrate_threshold"]

_LANES = ("Auto", "CPU", "Device", "Preparation")

_log = logging.getLogger(__name__)
_STOP = object()


@dataclass
class ServingRequest:
    ids: np.ndarray
    client: int
    seq: int
    t_enqueue: float = field(default_factory=time.perf_counter)


def _next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _pad_to_bucket(ids: np.ndarray, buckets: Sequence[int]) -> np.ndarray:
    """``ids`` padded with its first id (0 when empty) to the next bucket;
    at or above the top bucket it is returned as it is."""
    b = _next_bucket(len(ids), buckets)
    if len(ids) >= b:
        return ids
    return np.concatenate([ids, np.full(b - len(ids), ids[0] if len(ids)
                                        else 0, dtype=ids.dtype)])


def _not_ported(name: str):
    raise NotImplementedError(f"{name}= is not ported yet (ROADMAP A11)")


class RequestBatcher:
    """Route per-client request streams to the CPU or the device lane.

    Args:
      stream_queues: input queues, one per client; items are
        :class:`ServingRequest`s or bare id arrays.
      neighbour_num: ``[N]`` expected expansion per node
        (:func:`quiver_tpu_torch.generate_neighbour_num`).
      threshold: in ``"Auto"`` mode a request whose summed
        ``neighbour_num`` is at most this goes to the CPU lane; without
        ``neighbour_num`` every request goes to the device lane.
      mode: ``"Auto"``, ``"CPU"``, ``"Device"`` or ``"Preparation"`` (every
        request to both lanes).
      result_queue: where a payload that cannot be routed is answered,
        as ``(request, exception)``.
      qos: not ported yet (ROADMAP A11); must be ``None``.
    """

    def __init__(self, stream_queues: List["queue.Queue"],
                 neighbour_num: Optional[np.ndarray] = None,
                 threshold: float = 0.0, mode: str = "Auto",
                 result_queue: Optional["queue.Queue"] = None, qos=None):
        if mode not in _LANES:
            raise ValueError(f"mode must be one of {_LANES}, got {mode!r}")
        if qos is not None:
            _not_ported("qos")
        self.stream_queues = stream_queues
        self.neighbour_num = neighbour_num
        self.threshold = threshold
        self.mode = mode
        self.result_queue = result_queue
        self.cpu_batched_queue: "queue.Queue" = queue.Queue()
        self.device_batched_queue: "queue.Queue" = queue.Queue()
        self._threads: List[threading.Thread] = []

    def _route(self, req: ServingRequest):
        if self.mode == "CPU":
            self.cpu_batched_queue.put(req)
        elif self.mode == "Device":
            self.device_batched_queue.put(req)
        elif self.mode == "Preparation":
            self.cpu_batched_queue.put(req)
            self.device_batched_queue.put(req)
        else:
            load = (float(self.neighbour_num[req.ids].sum())
                    if self.neighbour_num is not None else float("inf"))
            if load <= self.threshold:
                self.cpu_batched_queue.put(req)
            else:
                self.device_batched_queue.put(req)

    def _worker(self, q: "queue.Queue"):
        while True:
            item = q.get()
            if item is _STOP:
                break
            try:
                if not isinstance(item, ServingRequest):
                    item = ServingRequest(ids=np.asarray(item), client=-1,
                                          seq=-1)
                self._route(item)
            except Exception as e:  # noqa: BLE001 -- the stream must survive
                _log.exception("unroutable serving payload")
                if self.result_queue is not None:
                    self.result_queue.put((item, e))

    def start(self):
        for q in self.stream_queues:
            t = threading.Thread(target=self._worker, args=(q,), daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> List[threading.Thread]:
        """Stop the stream threads; returns any that did not exit."""
        for q in self.stream_queues:
            q.put(_STOP)
        leaked = join_and_reap(self._threads, 5.0, component="batcher")
        self.cpu_batched_queue.put(_STOP)
        self.device_batched_queue.put(_STOP)
        return leaked


class HybridSampler:
    """The CPU lane's sampler workers: take requests from the batcher's
    CPU queue, pad each to a serving bucket, sample it with
    ``cpu_sampler`` (a ``GraphSageSampler(mode="CPU")``) and put
    ``(request, SampledBatch, seconds)`` on ``sampled_queue``.

    Padding keeps the model's input shapes to one per bucket, as in the
    JAX package; the server slices each answer back to the request's
    length.  With ``feature``, each batch's rows are prefetched
    (``Feature.prefetch``; nothing for a whole-table feature).  A failed
    sample is answered on ``result_queue`` as ``(request, exception)``.
    """

    def __init__(self, cpu_sampler: GraphSageSampler,
                 cpu_batched_queue: "queue.Queue", num_workers: int = 2,
                 buckets: Optional[Sequence[int]] = None,
                 feature: Optional[Feature] = None,
                 result_queue: Optional["queue.Queue"] = None):
        self.sampler = cpu_sampler
        self.inq = cpu_batched_queue
        self.result_queue = result_queue
        self.sampled_queue: "queue.Queue" = queue.Queue()
        self.num_workers = num_workers
        self.feature = feature
        self.buckets = tuple(get_config().serving_buckets if buckets is None
                             else buckets)
        self.failed = Counter("serving_requests_error{lane=cpu}")
        self._threads: List[threading.Thread] = []

    def _pad(self, ids: np.ndarray) -> np.ndarray:
        return _pad_to_bucket(ids, self.buckets)

    def _loop(self):
        while True:
            item = self.inq.get()
            if item is _STOP:
                self.inq.put(_STOP)  # for the sibling workers
                break
            t0 = time.perf_counter()
            try:
                batch = self.sampler.sample(self._pad(np.asarray(item.ids)))
                dt = time.perf_counter() - t0
                if self.feature is not None:
                    self.feature.prefetch(batch.n_id)
            except Exception as e:  # noqa: BLE001 -- the worker must survive
                _log.exception("CPU-lane sample failed")
                self.failed.inc()
                if self.result_queue is not None:
                    self.result_queue.put((item, e))
                continue
            self.sampled_queue.put((item, batch, dt))

    def start(self):
        for _ in range(self.num_workers):
            t = threading.Thread(target=self._loop, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> List[threading.Thread]:
        """Stop the workers; returns any that did not exit."""
        self.inq.put(_STOP)
        leaked = join_and_reap(self._threads, 5.0, component="sampler")
        self.sampled_queue.put(_STOP)
        return leaked


class InferenceServer:
    """Device lane: coalesce -> pad to a bucket -> forward -> answer; CPU
    lane: presampled batch -> ``feature[n_id]`` -> model -> answer.

    Args:
      sampler: the device lane's :class:`GraphSageSampler` (a UVA or CPU
        sampler takes the unfused form).
      feature: a :class:`Feature` on the same device.
      model: an ``nn.Module`` called as ``model(x, blocks)``.
      device_batched_queue: the batcher's device lane.
      cpu_sampled_queue: a :class:`HybridSampler`'s ``sampled_queue``, or
        ``None`` for no CPU lane.
      result_queue: answers go here as ``(request, logits ndarray)`` or
        ``(request, exception)``.
      max_coalesce: most requests one pass may take.
      fused: take the fused form (``None``: when the feature holds the
        whole table on the device and the sampler is in device mode).
      seed: seed of the generator that draws every pass's key words.
      cpu_sampler, qos: failover and QoS, not ported yet (ROADMAP A11);
        must be ``None``.
    """

    def __init__(self, sampler: GraphSageSampler, feature: Feature,
                 model: torch.nn.Module,
                 device_batched_queue: "queue.Queue",
                 cpu_sampled_queue: Optional["queue.Queue"] = None,
                 result_queue: Optional["queue.Queue"] = None,
                 max_coalesce: Optional[int] = None,
                 fused: Optional[bool] = None, seed: int = 0,
                 cpu_sampler=None, qos=None):
        if cpu_sampler is not None:
            _not_ported("cpu_sampler")
        if qos is not None:
            _not_ported("qos")
        if feature.device != sampler.device:
            raise ValueError(f"feature on {feature.device}, sampler on "
                             f"{sampler.device}")
        cfg = get_config()
        self.BUCKETS = tuple(cfg.serving_buckets)
        self.max_coalesce = (cfg.max_coalesce if max_coalesce is None
                             else max_coalesce)
        self.sampler = sampler
        self.feature = feature
        self.model = model.to(sampler.device).eval()
        self.device_q = device_batched_queue
        self.cpu_q = cpu_sampled_queue
        self.result_queue = result_queue or queue.Queue()
        self.served = Counter("serving_requests_ok")
        self.failed = Counter("serving_requests_error")
        # serving_request_seconds{lane}: each lane's end-to-end latency
        self.lane_latency = {lane: Histogram(
            f"serving_request_seconds{{lane={lane}}}")
            for lane in ("device", "cpu")}
        self._rng = np.random.default_rng(seed)
        if fused is None:
            fused = (feature.node_count > 0
                     and feature.cache_count >= feature.node_count
                     and sampler.mode == "GPU")
        self._fused = fused
        if not fused:
            self._maybe_enable_cold_cache(feature)
        self._threads: List[threading.Thread] = []
        self._stopped = threading.Event()

    @staticmethod
    def _maybe_enable_cold_cache(feature: Feature):
        """Attach the cold-row overlay to a budgeted feature in the
        unfused lane: recurring requests keep touching the same cold
        rows.  ``cold_cache_size`` ``"off"``, ``"0"`` or ``"none"`` in
        the config vetoes it."""
        if (feature.node_count <= 0
                or feature.cache_count >= feature.node_count
                or feature.cold_cache is not None):
            return
        if str(get_config().cold_cache_size).lower() in ("0", "off", "none"):
            return
        feature.enable_cold_cache()

    # -- one pass ------------------------------------------------------
    def _pad_ids(self, ids: np.ndarray) -> np.ndarray:
        return _pad_to_bucket(ids, self.BUCKETS)

    def draw_key_words(self) -> np.ndarray:
        """``[L, 2]`` uint32 key words for one pass (``[L, 3]`` for a UVA
        sampler: the third word seeds each hop's host tier)."""
        width = 3 if self.sampler.mode == "UVA" else 2
        return self._rng.integers(
            0, 2**32, size=(len(self.sampler.sizes), width), dtype=np.uint32)

    def fused_forward(self, padded_ids: np.ndarray,
                      key_words: np.ndarray) -> torch.Tensor:
        """Sample -> ``lookup_device`` -> model for one padded pass, on the
        device, with no host round trip between the stages (the feature
        must hold the whole table on the device).  The sampler's dedup,
        caps and edge weights apply, as in the unfused lane."""
        s = self.sampler
        with torch.inference_mode():
            n_id, _, _, blocks, _ = s.pipeline(s.seed_tensor(padded_ids),
                                               key_words)
            x = self.feature.lookup_device(n_id)
            return self.model(x, blocks)

    def unfused_forward(self, padded_ids: np.ndarray,
                        key_words: np.ndarray,
                        split: Optional[dict] = None) -> torch.Tensor:
        """Sample on the device -> one read-back of ``n_id`` ->
        ``feature[n_id]`` -> model, for one padded pass.  ``split`` gets
        the wall seconds of ``sample`` and ``gather``."""
        with torch.inference_mode():
            t0 = time.perf_counter()
            batch = self.sampler.sample(padded_ids, key_words=key_words)
            t1 = time.perf_counter()
            x = self.feature[batch.n_id.cpu().numpy()]
            t2 = time.perf_counter()
            out = self.model(x, batch.layers)
        if split is not None:
            split["sample"] = t1 - t0
            split["gather"] = t2 - t1
        return out

    def _run_bucketed(self, ids: np.ndarray, stages: Optional[dict] = None,
                      log: Optional[list] = None) -> np.ndarray:
        """One padded device pass per chunk of at most the top bucket, so
        every pass has one of the bucketed sizes.  ``stages`` adds up wall
        seconds by stage: ``infer`` for a fused pass; ``sample``,
        ``gather`` and ``infer`` (model and answer read-back), which
        partition an unfused pass.  ``log`` collects each chunk's
        ``(padded_ids, key_words)``."""
        top = self.BUCKETS[-1]
        outs = []
        for off in range(0, max(len(ids), 1), top):
            chunk = ids[off: off + top]
            padded = self._pad_ids(chunk)
            kw = self.draw_key_words()
            split: dict = {}
            t0 = time.perf_counter()
            out = (self.fused_forward(padded, kw) if self._fused else
                   self.unfused_forward(padded, kw, split))
            # the answer's host sync (the fused lane's only one)
            outs.append(out[: len(chunk)].cpu().numpy())
            if stages is not None:
                split["infer"] = (time.perf_counter() - t0
                                  - sum(split.values()))
                for stage, dt in split.items():
                    stages[stage] = stages.get(stage, 0.0) + dt
            if log is not None:
                log.append((padded, kw))
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def _infer_presampled(self, req: ServingRequest, batch,
                          stages: Optional[dict] = None) -> np.ndarray:
        """The CPU lane's forward: ``feature[batch.n_id]`` (the ids stay on
        the device) -> model, sliced to the request's length and read
        back.  ``stages`` gets ``gather`` and ``infer`` wall seconds."""
        with torch.inference_mode():
            t0 = time.perf_counter()
            x = self.feature[batch.n_id]
            t1 = time.perf_counter()
            out = self.model(x, batch.layers)[: len(req.ids)].cpu().numpy()
        if stages is not None:
            stages["gather"] = stages.get("gather", 0.0) + t1 - t0
            stages["infer"] = (stages.get("infer", 0.0)
                               + time.perf_counter() - t1)
        return out

    def warmup(self, example_node: int = 0):
        """Run every bucket once before traffic: builds the kernels and
        fills the allocator's cache, so no request pays for either."""
        for b in self.BUCKETS:
            self._run_bucketed(np.full(b, example_node, dtype=np.int64))
        return self

    # -- the lane ------------------------------------------------------
    def _drain_coalesce(self, first: ServingRequest) -> List[ServingRequest]:
        """Pull queued requests (non-blocking) into one pass while the top
        bucket has room."""
        reqs = [first]
        budget = self.BUCKETS[-1] - len(first.ids)
        while len(reqs) < self.max_coalesce and budget > 0:
            try:
                item = self.device_q.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                self.device_q.put(_STOP)  # re-post for the loop to see
                break
            if len(item.ids) > budget:
                self.device_q.put(item)
                break
            reqs.append(item)
            budget -= len(item.ids)
        return reqs

    def _infer_coalesced(self, reqs: List[ServingRequest],
                         stages: Optional[dict] = None,
                         log: Optional[list] = None) -> List[np.ndarray]:
        ids = np.concatenate([np.asarray(r.ids) for r in reqs])
        out = self._run_bucketed(ids, stages, log)
        outs, off = [], 0
        for r in reqs:
            outs.append(out[off: off + len(r.ids)])
            off += len(r.ids)
        return outs

    def _device_loop(self):
        while not self._stopped.is_set():
            item = self.device_q.get()
            if item is _STOP:
                break
            reqs = (self._drain_coalesce(item) if self.max_coalesce > 1
                    else [item])
            t_deq = time.perf_counter()
            stages: dict = {}
            try:
                outs = self._infer_coalesced(reqs, stages)
            except Exception as e:  # noqa: BLE001 -- the lane must survive
                _log.exception("device pass failed")
                for r in reqs:
                    self.failed.inc()
                    self.result_queue.put((r, e))
                continue
            t_done = time.perf_counter()
            for r, o in zip(reqs, outs):
                self._record_request(r, "device", stages, t_deq, t_done)
                self.result_queue.put((r, o))

    def _cpu_loop(self):
        while not self._stopped.is_set():
            item = self.cpu_q.get()
            if item is _STOP:
                break
            req, batch, sample_dt = item
            stages = {"sample": float(sample_dt)}
            try:
                out = self._infer_presampled(req, batch, stages)
            except Exception as e:  # noqa: BLE001 -- the lane must survive
                _log.exception("CPU-lane forward failed")
                self.failed.inc()
                self.result_queue.put((req, e))
                continue
            self._record_request(req, "cpu", stages, None,
                                 time.perf_counter())
            self.result_queue.put((req, out))

    def _record_request(self, req: ServingRequest, lane: str, stages: dict,
                        t_dequeue: Optional[float], t_done: float):
        """Returns ``(e2e_seconds, stages with queue_wait)``.  Without a
        dequeue stamp (the CPU lane, which sampled before this server saw
        the request) ``queue_wait`` is what the stages leave of e2e."""
        self.served.inc()
        e2e = max(t_done - req.t_enqueue, 0.0)
        self.lane_latency[lane].observe(e2e)
        full = dict(stages)
        if t_dequeue is not None:
            full["queue_wait"] = max(t_dequeue - req.t_enqueue, 0.0)
        else:
            full["queue_wait"] = max(e2e - sum(full.values()), 0.0)
        return e2e, full

    def start(self):
        loops = [self._device_loop]
        if self.cpu_q is not None:
            loops.append(self._cpu_loop)
        for loop in loops:
            t = threading.Thread(target=loop, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> List[threading.Thread]:
        """Stop the lane threads; returns any that did not exit."""
        self._stopped.set()
        self.device_q.put(_STOP)
        if self.cpu_q is not None:
            self.cpu_q.put(_STOP)
        return join_and_reap(self._threads, 10.0, component="server")


class InferenceServer_Debug(InferenceServer):
    """Latency-instrumented server.  ``stats()`` returns avg / p50 / p99
    latency, throughput and ``stage_breakdown_ms`` (queue_wait, and infer
    or sample / gather / infer; mean and total), the JAX package's keys.
    ``pass_log`` keeps, for each served device pass, the ``(client, seq)``
    of its requests and each chunk's ``(padded_ids, key_words)``, and
    ``cpu_log`` each CPU-lane request's ``(client, seq, batch)``, so an
    answer can be recomputed directly."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._lock = threading.Lock()
        self._hist = Histogram("serving_debug_latency")
        self._stage_acc: dict = {}  # stage -> [count, total_s]
        self._t_first = None
        self._t_last = None
        self._count = 0
        self.pass_log: collections.deque = collections.deque(maxlen=1024)
        self.cpu_log: collections.deque = collections.deque(maxlen=1024)

    def _infer_presampled(self, req, batch, stages=None):
        with self._lock:
            self.cpu_log.append((req.client, req.seq, batch))
        return super()._infer_presampled(req, batch, stages)

    def _infer_coalesced(self, reqs, stages=None, log=None):
        log = [] if log is None else log
        outs = super()._infer_coalesced(reqs, stages, log)
        with self._lock:
            self.pass_log.append(([(r.client, r.seq) for r in reqs], log))
        return outs

    def _record_request(self, req, lane, stages, t_dequeue, t_done):
        e2e, full = super()._record_request(req, lane, stages, t_dequeue,
                                            t_done)
        self._hist.observe(e2e)
        with self._lock:
            self._t_first = self._t_first or req.t_enqueue
            self._t_last = req.t_enqueue + e2e
            self._count += 1
            for stage, dt in full.items():
                acc = self._stage_acc.setdefault(stage, [0, 0.0])
                acc[0] += 1
                acc[1] += dt
        return e2e, full

    def stats(self) -> dict:
        with self._lock:
            n = self._count
            if n == 0:
                return dict(count=0)
            span = max((self._t_last or 0) - (self._t_first or 0), 1e-9)
            breakdown = {
                stage: dict(mean_ms=float(t / c * 1e3),
                            total_ms=float(t * 1e3))
                for stage, (c, t) in sorted(self._stage_acc.items())
            }
        return dict(
            count=int(n),
            avg_latency_ms=float(self._hist.mean * 1e3),
            p50_latency_ms=float(self._hist.percentile(50) * 1e3),
            p99_latency_ms=float(self._hist.percentile(99) * 1e3),
            throughput_rps=float(n / span),
            stage_breakdown_ms=breakdown,
        )


def calibrate_threshold(device_sampler: GraphSageSampler,
                        cpu_sampler: GraphSageSampler, feature: Feature,
                        model: torch.nn.Module, neighbour_num: np.ndarray,
                        node_count: int, trials: int = 8,
                        sizes: Sequence[int] = (1, 4, 16, 64),
                        seed: int = 0) -> float:
    """Time both lanes on random requests and return the
    ``neighbour_num``-sum threshold below which the CPU lane is faster,
    for ``RequestBatcher(threshold=...)``: ``trials`` requests of each
    size in ``sizes``, each sampled, gathered and run through ``model``
    once per lane (the answer read back), fitted by :func:`_fit_crossover`
    on each request's ``(load, cpu_s, device_s)``."""
    rng = np.random.default_rng(seed)
    pts = []
    with torch.inference_mode():
        for sz in sizes:
            for _ in range(trials):
                ids = rng.integers(0, node_count, sz)
                load = float(neighbour_num[ids].sum())
                dts = []
                for sampler in (cpu_sampler, device_sampler):
                    t0 = time.perf_counter()
                    b = sampler.sample(ids)
                    model(feature[b.n_id], b.layers).cpu()
                    dts.append(time.perf_counter() - t0)
                pts.append((load, dts[0], dts[1]))
    return _fit_crossover(pts)


def _fit_crossover(points) -> float:
    """Threshold from timing points ``(load, cpu_s, device_s)``: the split
    of the load-sorted points that best separates CPU wins (below) from
    device wins (at and above), so that one lucky CPU time past the
    crossover does not move it.  The midpoint of the split's two loads;
    the largest load if the CPU always wins, 0 if the device does."""
    points = sorted(points)
    if not points:
        return 0.0
    wins = [cpu_dt <= dev_dt for _, cpu_dt, dev_dt in points]
    n = len(points)
    dev_wins_suffix = [0] * (n + 1)
    for i in range(n - 1, -1, -1):
        dev_wins_suffix[i] = dev_wins_suffix[i + 1] + (0 if wins[i] else 1)
    best_s, best_score, cpu_prefix = 0, dev_wins_suffix[0], 0
    for s in range(1, n + 1):
        cpu_prefix += 1 if wins[s - 1] else 0
        score = cpu_prefix + dev_wins_suffix[s]
        if score > best_score:
            best_s, best_score = s, score
    if best_s == 0:
        return 0.0
    if best_s == n:
        return points[-1][0]
    return (points[best_s - 1][0] + points[best_s][0]) / 2.0
