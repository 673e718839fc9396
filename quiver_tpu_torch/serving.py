"""GNN serving on the card (counterpart of ``quiver_tpu/serving.py``).

Stages are threads in one process sharing ``queue.Queue``s: a
:class:`RequestBatcher` routes client streams onto the device lane, and an
:class:`InferenceServer` thread drains it, coalesces queued requests into
one pass, pads the pass to a bucketed batch size and runs it through one
of two lanes:

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

Ported here: the device lane.  The CPU lane (``HybridSampler``), ``Auto``
routing, deadlines, shedding lanes, breakers, chaos points, QoS, the
flight recorder and the timeline are later slices (ROADMAP A11).
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

__all__ = ["RequestBatcher", "InferenceServer", "InferenceServer_Debug",
           "ServingRequest"]

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


class RequestBatcher:
    """Route per-client request streams onto the device lane.

    Args:
      stream_queues: input queues, one per client; items are
        :class:`ServingRequest`s or bare id arrays.
      mode: ``"Device"``.  ``"CPU"``, ``"Auto"`` and ``"Preparation"`` need
        the host sampler lane, which is not ported yet (ROADMAP A11).
      result_queue: where a payload that cannot be routed is answered,
        as ``(request, exception)``.
    """

    def __init__(self, stream_queues: List["queue.Queue"],
                 mode: str = "Device",
                 result_queue: Optional["queue.Queue"] = None):
        if mode != "Device":
            raise NotImplementedError(
                f"mode={mode!r} needs the CPU lane, not ported yet "
                "(ROADMAP A11); use 'Device'")
        self.stream_queues = stream_queues
        self.mode = mode
        self.result_queue = result_queue
        self.device_batched_queue: "queue.Queue" = queue.Queue()
        self._threads: List[threading.Thread] = []

    def _worker(self, q: "queue.Queue"):
        while True:
            item = q.get()
            if item is _STOP:
                break
            try:
                if not isinstance(item, ServingRequest):
                    item = ServingRequest(ids=np.asarray(item), client=-1,
                                          seq=-1)
                self.device_batched_queue.put(item)
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
        for t in self._threads:
            t.join(timeout=5.0)
        self.device_batched_queue.put(_STOP)
        return [t for t in self._threads if t.is_alive()]


class InferenceServer:
    """Device lane: coalesce -> pad to a bucket -> forward -> answer.

    Args:
      sampler: a :class:`GraphSageSampler` on the card.
      feature: a :class:`Feature` on the same device.
      model: an ``nn.Module`` called as ``model(x, blocks)``.
      device_batched_queue: the batcher's device lane.
      result_queue: answers go here as ``(request, logits ndarray)`` or
        ``(request, exception)``.
      max_coalesce: most requests one pass may take.
      fused: take the fused lane (``None``: when the feature holds the
        whole table on the device).
      seed: seed of the generator that draws every pass's key words.
    """

    def __init__(self, sampler: GraphSageSampler, feature: Feature,
                 model: torch.nn.Module,
                 device_batched_queue: "queue.Queue",
                 result_queue: Optional["queue.Queue"] = None,
                 max_coalesce: Optional[int] = None,
                 fused: Optional[bool] = None, seed: int = 0):
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
        self.result_queue = result_queue or queue.Queue()
        self.served = Counter("serving_requests_ok")
        self.failed = Counter("serving_requests_error")
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
        b = _next_bucket(len(ids), self.BUCKETS)
        if len(ids) >= b:  # at the top bucket exactly (chunking caps len)
            return ids
        return np.concatenate([ids, np.full(b - len(ids), ids[0] if len(ids)
                                            else 0, dtype=ids.dtype)])

    def draw_key_words(self) -> np.ndarray:
        """``[L, 2]`` uint32 key words for one pass."""
        return self._rng.integers(0, 2**32, size=(len(self.sampler.sizes), 2),
                                  dtype=np.uint32)

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
                self._record_request(r, stages, t_deq, t_done)
                self.result_queue.put((r, o))

    def _record_request(self, req: ServingRequest, stages: dict,
                        t_dequeue: float, t_done: float):
        """Returns ``(e2e_seconds, stages with queue_wait)``."""
        self.served.inc()
        e2e = max(t_done - req.t_enqueue, 0.0)
        full = dict(stages)
        full["queue_wait"] = max(t_dequeue - req.t_enqueue, 0.0)
        return e2e, full

    def start(self):
        t = threading.Thread(target=self._device_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> List[threading.Thread]:
        """Stop the device thread; returns it if it did not exit."""
        self._stopped.set()
        self.device_q.put(_STOP)
        for t in self._threads:
            t.join(timeout=10.0)
        return [t for t in self._threads if t.is_alive()]


class InferenceServer_Debug(InferenceServer):
    """Latency-instrumented server.  ``stats()`` returns avg / p50 / p99
    latency, throughput and ``stage_breakdown_ms`` (queue_wait, and infer
    or sample / gather / infer; mean and total), the JAX package's keys.  ``pass_log`` keeps, for each
    served pass, the ``(client, seq)`` of its requests and each chunk's
    ``(padded_ids, key_words)``, so a pass can be recomputed directly."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._lock = threading.Lock()
        self._hist = Histogram("serving_debug_latency")
        self._stage_acc: dict = {}  # stage -> [count, total_s]
        self._t_first = None
        self._t_last = None
        self._count = 0
        self.pass_log: collections.deque = collections.deque(maxlen=1024)

    def _infer_coalesced(self, reqs, stages=None, log=None):
        log = [] if log is None else log
        outs = super()._infer_coalesced(reqs, stages, log)
        with self._lock:
            self.pass_log.append(([(r.client, r.seq) for r in reqs], log))
        return outs

    def _record_request(self, req, stages, t_dequeue, t_done):
        e2e, full = super()._record_request(req, stages, t_dequeue, t_done)
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
