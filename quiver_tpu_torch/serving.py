"""GNN serving on the card (counterpart of ``quiver_tpu/serving.py``).

Stages are threads in one process sharing queues: a
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

Safeguards, as in the JAX package: requests carry absolute deadlines
checked at every stage boundary; with a ``result_queue`` the batcher's
lanes are :class:`~quiver_tpu_torch.resilience.BoundedLane`\\ s (or, with
QoS, :class:`~quiver_tpu_torch.resilience.WeightedFairLane`\\ s) that
shed under overload; each server lane sits behind a
:class:`~quiver_tpu_torch.resilience.CircuitBreaker` and fails over to
the other lane (device -> CPU through an inline ``cpu_sampler`` pass,
CPU -> device through the bucketed forward); and the named
``chaos.point(...)`` call sites let a seeded plan inject faults.  A
request is always answered, with its result or a typed error; every
answer is counted in the port's metrics registry under the JAX package's
keys and lands in the flight recorder and the timeline.

A fault of a kernel is not a fault of its lane: a kernel that fails to
build or load raises out of :meth:`InferenceServer.warmup` and
:meth:`InferenceServer.start`.  In a pass, a fault of the program or the
card, told by its type (``KernelError``, which a wrapper's refusal of its
arguments also is, torch's out-of-memory and CUDA runtime errors), is
answered as the error itself, counted by no breaker (a half-open probe
it held is handed back) and never served by failover;
:meth:`InferenceServer.stop` raises it again.
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

from . import telemetry
from .analysis.staging import no_sync
from .config import get_config
from .feature import Feature
from .ops.cuda import KERNELS
from .ops.cuda.build import KernelError, load_libraries
from .resilience import chaos
from .resilience.breaker import CircuitBreaker
from .resilience.deadline import deadline_for, deadline_scope, \
    shed_if_expired
from .resilience.errors import LaneUnavailable
from .resilience.lanes import BoundedLane, WeightedFairLane
from .resilience.qos import qos_from_config
from .resilience.shutdown import join_and_reap
from .sampler import GraphSageSampler
from .telemetry import Histogram, flightrec, profile
from .telemetry import timeline as _timeline
from .telemetry.registry import snapshot_delta

__all__ = ["RequestBatcher", "HybridSampler", "InferenceServer",
           "InferenceServer_Debug", "ServingRequest", "calibrate_threshold"]

_LANES = ("Auto", "CPU", "Device", "Preparation")

_log = logging.getLogger(__name__)
_STOP = object()

# named fault-injection call sites (no-ops unless a chaos plan is
# installed: one module-global read and a None check per fire)
_CHAOS_DEVICE = chaos.point("serving.device_lane")
_CHAOS_CPU = chaos.point("serving.cpu_lane")
_CHAOS_SAMPLER = chaos.point("serving.hybrid_sampler")


@dataclass
class ServingRequest:
    ids: np.ndarray
    client: int
    seq: int
    t_enqueue: float = field(default_factory=time.perf_counter)
    # flight-recorder trace context; None when telemetry is off (every
    # consumer guards)
    trace: Optional[object] = None
    # absolute perf_counter deadline; defaults from
    # config.serving_deadline_ms (None: no deadline, checks are free)
    deadline: Optional[float] = None
    # under overload the bounded lanes shed strictly lower priorities
    # first
    priority: int = 0
    # graph version at admission (None without a streaming graph)
    graph_version: Optional[int] = None
    # tenant label as the client sent it (None: untenanted); QoS
    # admission stamps the resolved, allowlisted class on tenant_class
    tenant: Optional[str] = None
    tenant_class: Optional[str] = None

    def __post_init__(self):
        if self.deadline is None:
            self.deadline = deadline_for(self.t_enqueue)
        if self.graph_version is None:
            self.graph_version = flightrec.graph_version()
        if self.trace is None:
            self.trace = flightrec.new_trace()
            if self.trace is not None:
                self.trace.add("enqueue", {"n_ids": int(len(self.ids)),
                                           "client": self.client,
                                           "seq": self.seq})
        if self.trace is not None and self.tenant is not None:
            self.trace.tenant = self.tenant
        if self.trace is not None and _timeline._ON:
            # the admission instant anchors this request's trace id on
            # the timeline; its stage slices and the final "request"
            # slice share it
            _timeline.emit("request.enqueue", cat="serving",
                           attrs={"n_ids": int(len(self.ids)),
                                  "client": self.client},
                           trace=self.trace)

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (now if now is not None else time.perf_counter()) \
            >= self.deadline


def _fail_request(req, exc, lane: str, result_queue) -> None:
    """Shared error answer: a retained flight record (status error) and
    ``(req, exc)`` on the result queue when one is in scope."""
    tr = getattr(req, "trace", None)
    if tr is not None:
        tr.add("error", {"type": type(exc).__name__, "message": str(exc)})
        e2e = max(time.perf_counter() - req.t_enqueue, 0.0)
        flightrec.get_recorder().finish(tr, e2e, status="error", lane=lane)
    if result_queue is not None:
        result_queue.put((req, exc))


# faults of the program or the card, never of a lane, told by type: a
# kernel that fails to build, load or launch or refuses its arguments
# (KernelError and its KernelArgumentError), the card out of memory, and
# torch's CUDA runtime errors
_DEVICE_FAULTS = (KernelError, torch.cuda.OutOfMemoryError) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())


def _is_kernel_fault(exc: BaseException) -> bool:
    """A fault of the program or the card, not of a lane: no breaker
    counts it and no failover serves around it."""
    return isinstance(exc, _DEVICE_FAULTS)


def _host_logits(out: torch.Tensor) -> np.ndarray:
    """An answer read back to numpy.  numpy has no bfloat16, so a bf16
    model's logits come back widened to fp32, which is exact (JAX answers
    a bf16 array)."""
    if out.dtype == torch.bfloat16:
        out = out.float()
    # quiverlint: ignore[QT001] -- the answer's read-back: one per chunk,
    # outside the no-sync region
    return out.cpu().numpy()


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
      result_queue: where shed, rejected and unroutable requests are
        answered, as ``(request, exception)``.  With one, the two lanes
        are :class:`~quiver_tpu_torch.resilience.BoundedLane`\\ s
        (``config.serving_queue_depth``, watermark shedding) and expired
        requests are shed at routing; without one the lanes are plain
        unbounded queues and nothing is shed here.
      qos: a :class:`~quiver_tpu_torch.resilience.QoSController`, or
        ``None`` to take the configured one (``config.qos_enabled``).
        With QoS every request passes token-bucket admission here
        (an over-quota tenant is answered with ``QuotaExceeded``) and the
        bounded lanes are
        :class:`~quiver_tpu_torch.resilience.WeightedFairLane`\\ s over
        the tenant classes.
    """

    def __init__(self, stream_queues: List["queue.Queue"],
                 neighbour_num: Optional[np.ndarray] = None,
                 threshold: float = 0.0, mode: str = "Auto",
                 result_queue: Optional["queue.Queue"] = None, qos=None):
        if mode not in _LANES:
            raise ValueError(f"mode must be one of {_LANES}, got {mode!r}")
        self.stream_queues = stream_queues
        self.neighbour_num = neighbour_num
        self.threshold = threshold
        self.mode = mode
        self.result_queue = result_queue
        self._qos = qos if qos is not None else qos_from_config()
        depth = (get_config().serving_queue_depth
                 if result_queue is not None else 0)
        if depth > 0 and self._qos is not None:
            weights = self._qos.weights()
            default = self._qos.default
            self.cpu_batched_queue = WeightedFairLane(
                "cpu", weights, default_class=default,
                result_queue=result_queue)
            self.device_batched_queue = WeightedFairLane(
                "device", weights, default_class=default,
                result_queue=result_queue)
        elif depth > 0:
            self.cpu_batched_queue = BoundedLane(
                "cpu", result_queue=result_queue)
            self.device_batched_queue = BoundedLane(
                "device", result_queue=result_queue)
        else:
            self.cpu_batched_queue = queue.Queue()
            self.device_batched_queue = queue.Queue()
        self._threads: List[threading.Thread] = []

    def _route(self, req: ServingRequest):
        if shed_if_expired(req, self.result_queue, "batcher"):
            return
        q = self._qos
        if q is not None and not q.admit(req, self.result_queue):
            return
        if (q is not None and q.route_floor_to_cpu and self.mode == "Auto"
                and req.tenant_class == q.floor):
            # degradation ladder level 3: the lowest class rides the CPU
            # lane so the device passes stay clear for the paying classes
            self._put(self.cpu_batched_queue, req, "cpu")
            return
        if self.mode == "CPU":
            self._put(self.cpu_batched_queue, req, "cpu")
        elif self.mode == "Device":
            self._put(self.device_batched_queue, req, "device")
        elif self.mode == "Preparation":
            self._put(self.cpu_batched_queue, req, "both")
            self.device_batched_queue.put(req)
        else:
            load = (float(self.neighbour_num[req.ids].sum())
                    if self.neighbour_num is not None else float("inf"))
            if load <= self.threshold:
                self._put(self.cpu_batched_queue, req, "cpu", load)
            else:
                self._put(self.device_batched_queue, req, "device", load)

    @staticmethod
    def _put(q: "queue.Queue", req: ServingRequest, lane: str,
             load: Optional[float] = None):
        if req.trace is not None:
            attrs = {"lane": lane}
            if load is not None and load != float("inf"):
                attrs["load"] = load
            # quiverlint: ignore[QT008] -- queue handoff orders the
            # accesses: the producer stops touching req.trace once it is
            # enqueued, and q.put/get gives the worker a happens-before
            req.trace.add("route", attrs)
        q.put(req)

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
                self._reject(item, e)

    def _reject(self, item, exc) -> None:
        """Answer and count one unroutable payload:
        ``serving_rejected_total``, a retained ``rejected`` flight record,
        and ``(request, exc)`` on the result queue when the payload became
        a request."""
        req = item if isinstance(item, ServingRequest) else None
        tenant = getattr(req, "tenant_class", None)
        if tenant is not None:  # QoS-admitted: labelled by its class
            telemetry.counter("serving_rejected_total", tenant=tenant).inc()
        else:
            telemetry.counter("serving_rejected_total").inc()
        tr = req.trace if req is not None else flightrec.new_trace()
        if tr is not None:
            tr.add("reject", {"type": type(exc).__name__,
                              "message": str(exc),
                              "payload": type(item).__name__})
            t0 = req.t_enqueue if req is not None else tr.t_start
            flightrec.get_recorder().finish(
                tr, max(time.perf_counter() - t0, 0.0), status="rejected",
                lane="batcher")
        if req is not None and self.result_queue is not None:
            self.result_queue.put((req, exc))

    def start(self):
        for q in self.stream_queues:
            t = threading.Thread(target=self._worker, args=(q,), daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> List[threading.Thread]:
        """Stop the stream threads; returns (and counts in
        ``serving_thread_leak_total``) any that did not exit."""
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
    (``Feature.prefetch``; nothing for a whole-table feature).  An
    expired request is shed here, and a failed sample answered, on
    ``result_queue`` as ``(request, exception)``.
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
        self._threads: List[threading.Thread] = []

    def _pad(self, ids: np.ndarray) -> np.ndarray:
        return _pad_to_bucket(ids, self.buckets)

    def _loop(self):
        while True:
            item = self.inq.get()
            if item is _STOP:
                self.inq.put(_STOP)  # for the sibling workers
                break
            if shed_if_expired(item, self.result_queue, "sampler"):
                continue
            t0 = time.perf_counter()
            try:
                with flightrec.activate(item.trace):
                    _CHAOS_SAMPLER()
                    batch = self.sampler.sample(self._pad(np.asarray(
                        item.ids)))
                    dt = time.perf_counter() - t0
                    if flightrec.tracing():
                        flightrec.event("sample", {
                            "seconds": dt,
                            "n_id": int(batch.n_id.shape[0])})
                    if self.feature is not None:
                        self.feature.prefetch(batch.n_id)
            except Exception as e:  # noqa: BLE001 -- the worker must survive
                _log.exception("CPU-lane sample failed")
                telemetry.counter("serving_requests_total", lane="cpu",
                                  status="error").inc()
                _fail_request(item, e, "sampler", self.result_queue)
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
      cpu_sampler: the failover route of device-lane requests when the
        device lane fails or its breaker is open: an inline sample on
        this ``GraphSageSampler(mode="CPU")``, then the CPU lane's
        forward.  ``None``: such requests are answered with the error.
      qos: a :class:`~quiver_tpu_torch.resilience.QoSController` (``None``:
        the configured one, if ``config.qos_enabled``).  With QoS the
        device lane holds a coalesced pass open for late arrivals for up
        to ``config.qos_admit_window_ms``.

    ``lane_latency`` maps each lane (``"device"``, ``"cpu"``,
    ``"failover"``) to its ``serving_request_seconds`` histogram in the
    registry, counted from :meth:`start`.
    """

    def __init__(self, sampler: GraphSageSampler, feature: Feature,
                 model: torch.nn.Module,
                 device_batched_queue: "queue.Queue",
                 cpu_sampled_queue: Optional["queue.Queue"] = None,
                 result_queue: Optional["queue.Queue"] = None,
                 max_coalesce: Optional[int] = None,
                 fused: Optional[bool] = None, seed: int = 0,
                 cpu_sampler: Optional[GraphSageSampler] = None, qos=None):
        if feature.device != sampler.device:
            raise ValueError(f"feature on {feature.device}, sampler on "
                             f"{sampler.device}")
        if cpu_sampler is not None and cpu_sampler.device != sampler.device:
            raise ValueError(f"cpu_sampler puts its batches on "
                             f"{cpu_sampler.device}, the server runs on "
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
        self._qos = qos if qos is not None else qos_from_config()
        self._admit_window_s = (float(cfg.qos_admit_window_ms) / 1e3
                                if self._qos is not None else 0.0)
        self.cpu_sampler = cpu_sampler
        # one breaker a lane (thresholds from config; tests swap in
        # breakers with scripted clocks)
        self._breakers = {"device": CircuitBreaker("serving.device"),
                          "cpu": CircuitBreaker("serving.cpu")}
        # the first kernel fault met while serving; stop() raises it
        self.kernel_error: Optional[BaseException] = None
        self._rng = np.random.default_rng(seed)
        if fused is None:
            fused = (feature.node_count > 0
                     and feature.cache_count >= feature.node_count
                     and sampler.mode == "GPU")
        self._fused = fused
        if not fused:
            self._maybe_enable_cold_cache(feature)
        self._baseline: dict = {}
        self._threads: List[threading.Thread] = []
        self._stopped = threading.Event()
        self._lock = threading.Lock()

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

    @property
    def lane_latency(self) -> dict:
        """Each lane's ``serving_request_seconds`` since :meth:`start`, read
        from the registry (empty while telemetry is off)."""
        window = snapshot_delta(self._baseline, telemetry.snapshot())
        out = {}
        for lane in ("device", "cpu", "failover"):
            h = Histogram(f"serving_request_seconds{{lane={lane}}}")
            d = window.get("histograms", {}).get(h.key)
            if d is not None:
                h.merge_dict(d)
            out[lane] = h
        return out

    # -- one pass ------------------------------------------------------
    # quiverlint: bucketed[every result length is drawn from BUCKETS]
    def _pad_ids(self, ids: np.ndarray) -> np.ndarray:
        return _pad_to_bucket(ids, self.BUCKETS)

    def draw_key_words(self) -> np.ndarray:
        """``[L, 2]`` uint32 key words for one pass (``[L, 3]`` for a UVA
        sampler: the third word seeds each hop's host tier)."""
        width = 3 if self.sampler.mode == "UVA" else 2
        with self._lock:
            return self._rng.integers(
                0, 2**32, size=(len(self.sampler.sizes), width),
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
            # quiverlint: ignore[QT001] -- the unfused lane reads n_id back by
            # design (the fused lane does not)
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
        ``(padded_ids, key_words)``.  With profiling on, each chunk's
        forward is attributed to ``("fused" or "unfused", bucket)``."""
        top = self.BUCKETS[-1]
        dev = self.sampler.device
        outs = []
        for off in range(0, max(len(ids), 1), top):
            chunk = ids[off: off + top]
            padded = self._pad_ids(chunk)
            kw = self.draw_key_words()
            split: dict = {}
            t0 = time.perf_counter()
            if self._fused:
                # dispatch must stay async: the read-back below is the
                # ONE sanctioned sync point per chunk
                with no_sync("serving device loop"):
                    out = profile.call("serving", ("fused", len(padded)),
                                       dev, self.fused_forward, padded, kw)
            else:
                out = profile.call("serving", ("unfused", len(padded)), dev,
                                   self.unfused_forward, padded, kw, split)
            # the answer's host sync (the fused lane's only one)
            outs.append(_host_logits(out[: len(chunk)]))
            split["infer"] = time.perf_counter() - t0 - sum(split.values())
            if stages is not None:
                for stage, dt in split.items():
                    stages[stage] = stages.get(stage, 0.0) + dt
            if flightrec.tracing():
                for stage, dt in split.items():
                    flightrec.event(stage, {"seconds": dt,
                                            "fused": self._fused})
            if log is not None:
                log.append((padded, kw))
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def _infer_presampled(self, req: ServingRequest, batch,
                          stages: Optional[dict] = None,
                          lane: str = "cpu") -> np.ndarray:
        """The CPU lane's forward (and the device lane's failover):
        ``feature[batch.n_id]`` (the ids stay on the device) -> model,
        sliced to the request's length and read back.  ``stages`` gets
        ``gather`` and ``infer`` wall seconds."""
        with torch.inference_mode():
            t0 = time.perf_counter()
            x = self.feature[batch.n_id]
            t1 = time.perf_counter()
            out = _host_logits(self.model(x, batch.layers)[: len(req.ids)])
        t2 = time.perf_counter()
        if stages is not None:
            stages["gather"] = stages.get("gather", 0.0) + t1 - t0
            stages["infer"] = stages.get("infer", 0.0) + t2 - t1
        if flightrec.tracing():
            flightrec.event("gather", {"seconds": t1 - t0})
            flightrec.event("infer", {"seconds": t2 - t1})
        return out

    def _check_kernels(self):
        """Build and load the kernels when the server runs on the card: a
        kernel that cannot is a fault of the program, raised here."""
        if self.sampler.device.type == "cuda":
            load_libraries(KERNELS)

    def warmup(self, example_node: int = 0):
        """Run every bucket once before traffic: builds the kernels and
        fills the allocator's cache, so no request pays for either.  A
        kernel that fails to build, load or launch raises here."""
        self._check_kernels()
        for b in self.BUCKETS:
            self._run_bucketed(np.full(b, example_node, dtype=np.int64))
        if hasattr(self.feature, "warm_executables"):
            # a mesh feature records its gather ladder, as JAX's builds it
            self.feature.warm_executables()
        return self

    # -- the lanes -----------------------------------------------------
    def _drain_coalesce(self, first: ServingRequest) -> List[ServingRequest]:
        """Pull queued requests (non-blocking) into one pass while the top
        bucket has room.  With QoS the drain waits up to the admit window
        (never past the first request's deadline) for late arrivals once
        the queue runs dry."""
        reqs = [first]
        budget = self.BUCKETS[-1] - len(first.ids)
        window = self._admit_window_s
        t_close = time.perf_counter() + window if window > 0 else 0.0
        while len(reqs) < self.max_coalesce and budget > 0:
            try:
                item = self.device_q.get_nowait()
            except queue.Empty:
                if window <= 0:
                    break
                left = t_close - time.perf_counter()
                if first.deadline is not None:
                    left = min(left, first.deadline - time.perf_counter())
                if left <= 0:
                    break
                try:
                    item = self.device_q.get(timeout=left)
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
            # requests that aged out on the queue are shed before the
            # pass spends device time on them
            reqs = [r for r in reqs
                    if not shed_if_expired(r, self.result_queue, "device")]
            if not reqs:
                continue
            br = self._breakers["device"]
            if not br.allow():
                self._failover(reqs, "device", None)
                continue
            # the dequeue stamp follows the drain, so queue_wait and the
            # stages partition each request's end-to-end latency
            t_deq = time.perf_counter()
            stages: dict = {}
            # a coalesced pass activates every member's trace: all of
            # them wait for it
            act = (flightrec.activate([r.trace for r in reqs])
                   if reqs[0].trace is not None else flightrec.activate(None))
            dls = [r.deadline for r in reqs if r.deadline is not None]
            scope = deadline_scope(min(dls) if dls else None,
                                   min(r.t_enqueue for r in reqs))
            try:
                with act, scope:
                    if flightrec.tracing():
                        flightrec.event("dequeue", {"coalesced": len(reqs)})
                    _CHAOS_DEVICE()
                    outs = self._infer_coalesced(reqs, stages)
            except Exception as e:  # noqa: BLE001 -- the lane must survive
                if _is_kernel_fault(e):
                    br.release_probe()
                    self._kernel_fault(reqs, e, "device")
                    continue
                _log.warning("device pass failed: %r", e)
                br.record_failure()
                self._failover(reqs, "device", e)
                continue
            br.record_success()
            t_done = time.perf_counter()
            for r, o in zip(reqs, outs):
                self._finish(r, o, lane="device", stages=stages,
                             t_dequeue=t_deq, t_done=t_done)

    def _cpu_loop(self):
        while not self._stopped.is_set():
            item = self.cpu_q.get()
            if item is _STOP:
                break
            req, batch, sample_dt = item
            if shed_if_expired(req, self.result_queue, "cpu"):
                continue
            br = self._breakers["cpu"]
            if not br.allow():
                self._failover([req], "cpu", None)
                continue
            stages = {"sample": float(sample_dt)}
            scope = deadline_scope(req.deadline, req.t_enqueue)
            try:
                with flightrec.activate(req.trace), scope:
                    _CHAOS_CPU()
                    out = self._infer_presampled(req, batch, stages)
            except Exception as e:  # noqa: BLE001 -- the lane must survive
                if _is_kernel_fault(e):
                    br.release_probe()
                    self._kernel_fault([req], e, "cpu")
                    continue
                _log.warning("CPU-lane forward failed: %r", e)
                br.record_failure()
                self._failover([req], "cpu", e)
                continue
            br.record_success()
            self._finish(req, out, lane="cpu", stages=stages,
                         t_done=time.perf_counter())

    # -- faults and failover -------------------------------------------
    def _kernel_fault(self, reqs, exc: BaseException, lane: str):
        """A kernel fault: every request is answered with the error
        itself; no breaker counts it and no failover serves around it."""
        _log.error("kernel fault in the %s lane: %r", lane, exc)
        with self._lock:
            if self.kernel_error is None:
                self.kernel_error = exc
        for r in reqs:
            self._answer_error(r, exc, lane)

    def _failover(self, reqs, lane: str, error: Optional[Exception]):
        """Reroute requests off a failed (or breaker-open) lane.  Every
        request is answered: rerouted and finished, or, when no route
        exists or the reroute fails too, with an error.  ``error`` is the
        lane's failure (``None`` when its breaker refused the pass)."""
        for r in reqs:
            if shed_if_expired(r, self.result_queue, lane):
                continue
            try:
                done = (self._failover_via_cpu(r) if lane == "device"
                        else self._failover_via_device(r))
            except Exception as e:  # noqa: BLE001 -- failover can fail too
                if _is_kernel_fault(e):
                    self._kernel_fault([r], e, "failover")
                else:
                    self._answer_error(r, e, "failover")
                continue
            if not done:
                self._answer_error(
                    r, error if error is not None else LaneUnavailable(lane),
                    lane)

    def _failover_via_cpu(self, req: ServingRequest) -> bool:
        """Serve one device-lane request inline: ``cpu_sampler`` samples
        its padded ids, then the CPU lane's forward (kernel B2 for a
        whole-table feature).  False when no ``cpu_sampler`` was given."""
        if self.cpu_sampler is None:
            return False
        stages: dict = {}
        with flightrec.activate(req.trace):
            if flightrec.tracing():
                flightrec.event("failover", {"from": "device", "to": "cpu"})
            ids = np.asarray(req.ids)
            t0 = time.perf_counter()
            padded = (self._pad_ids(ids) if len(ids) <= self.BUCKETS[-1]
                      else ids)
            batch = self.cpu_sampler.sample(padded)
            stages["sample"] = time.perf_counter() - t0
            out = self._infer_presampled(req, batch, stages,
                                         lane="failover")
        telemetry.counter("serving_failover_total",
                          direction="device_to_cpu").inc()
        self._finish(req, out, lane="failover", stages=stages,
                     t_done=time.perf_counter())
        return True

    def _failover_via_device(self, req: ServingRequest) -> bool:
        """Serve one CPU-lane request through the bucketed device forward.
        False when the device breaker refuses it.  The pass's outcome is
        recorded on that breaker, so a probe it was handed is resolved."""
        br = self._breakers["device"]
        if not br.allow():
            return False
        stages: dict = {}
        try:
            with flightrec.activate(req.trace):
                if flightrec.tracing():
                    flightrec.event("failover",
                                    {"from": "cpu", "to": "device"})
                ids = np.asarray(req.ids)
                out = self._run_bucketed(ids, stages)[: len(ids)]
        except Exception as e:
            if _is_kernel_fault(e):
                br.release_probe()
            else:
                br.record_failure()
            raise
        br.record_success()
        telemetry.counter("serving_failover_total",
                          direction="cpu_to_device").inc()
        self._finish(req, out, lane="failover", stages=stages,
                     t_done=time.perf_counter())
        return True

    def _answer_error(self, req, exc, lane: str):
        telemetry.counter("serving_requests_total", lane=lane,
                          status="error").inc()
        _fail_request(req, exc, lane, self.result_queue)

    def _finish(self, req, out, lane: str = "device",
                stages: Optional[dict] = None,
                t_dequeue: Optional[float] = None,
                t_done: Optional[float] = None):
        self._record_request(req, lane, stages or {}, t_dequeue, t_done)
        self.result_queue.put((req, out))

    def _record_request(self, req: ServingRequest, lane: str, stages: dict,
                        t_dequeue: Optional[float],
                        t_done: Optional[float]):
        """Fold one served request into the registry
        (``serving_requests_total{lane,status=ok}``,
        ``serving_request_seconds{lane}``,
        ``serving_stage_seconds{lane,stage}``) and the flight recorder.
        Returns ``(e2e_seconds, stages with queue_wait)``.  Without a
        dequeue stamp (the CPU lane, which sampled before this server saw
        the request) ``queue_wait`` is what the stages leave of e2e."""
        now = t_done if t_done is not None else time.perf_counter()
        e2e = max(now - req.t_enqueue, 0.0)
        full = dict(stages)
        if t_dequeue is not None:
            full["queue_wait"] = max(t_dequeue - req.t_enqueue, 0.0)
        else:
            full["queue_wait"] = max(e2e - sum(full.values()), 0.0)
        telemetry.counter("serving_requests_total", lane=lane,
                          status="ok").inc()
        telemetry.histogram("serving_request_seconds", lane=lane).observe(e2e)
        for stage, dt in full.items():
            telemetry.histogram("serving_stage_seconds", lane=lane,
                                stage=stage).observe(dt)
        tr = getattr(req, "trace", None)
        if tr is not None:
            tr.add("finish", {"lane": lane})
            flightrec.get_recorder().finish(tr, e2e, status="ok", lane=lane,
                                            stages=full)
        return e2e, full

    def expose_metrics(self, port: int = 0, host: str = "127.0.0.1"):
        """Start the HTTP metrics endpoint (``/metrics``,
        ``/metrics.json``, ``/trace.json``, ``/debug/*``) over this
        process' registry; stopped with the server."""
        from .telemetry.export import start_http_server

        self._metrics_server = start_http_server(port=port, host=host)
        return self._metrics_server

    def start_slo_watchdog(self):
        """Start the process-wide SLO watchdog thread (objectives from
        config); stopped with the server."""
        from .telemetry.slo import get_watchdog

        self._slo_watchdog = get_watchdog().start()
        return self._slo_watchdog

    def start(self):
        """Start the lane threads.  On the card the kernels are built and
        loaded first: one that cannot be raises here."""
        self._check_kernels()
        self._baseline = telemetry.snapshot()
        loops = [self._device_loop]
        if self.cpu_q is not None:
            loops.append(self._cpu_loop)
        for loop in loops:
            t = threading.Thread(target=loop, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> List[threading.Thread]:
        """Stop the lane threads, the metrics endpoint and the watchdog;
        returns any thread that did not exit.  Raises the first kernel
        fault met while serving, after everything has stopped."""
        self._stopped.set()
        self.device_q.put(_STOP)
        if self.cpu_q is not None:
            self.cpu_q.put(_STOP)
        leaked = join_and_reap(self._threads, 10.0, component="server")
        srv = getattr(self, "_metrics_server", None)
        if srv is not None:
            srv.close()
            self._metrics_server = None
        wd = getattr(self, "_slo_watchdog", None)
        if wd is not None:
            wd.stop()
            self._slo_watchdog = None
        if self.kernel_error is not None:
            raise self.kernel_error
        return leaked


class InferenceServer_Debug(InferenceServer):
    """Latency-instrumented server.  ``stats()`` returns avg / p50 / p99
    latency, throughput and ``stage_breakdown_ms`` (queue_wait, and infer
    or sample / gather / infer; mean and total), the JAX package's keys.
    ``pass_log`` keeps, for each served device pass, the ``(client, seq)``
    of its requests and each chunk's ``(padded_ids, key_words)``;
    ``cpu_log`` each CPU-lane request's ``(client, seq, batch)`` and
    ``failover_log`` each device-to-CPU failover's, so an answer can be
    recomputed directly."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._hist = Histogram("serving_debug_latency")
        self._stage_acc: dict = {}  # stage -> [count, total_s]
        self._t_first = None
        self._t_last = None
        self._count = 0
        self.pass_log: collections.deque = collections.deque(maxlen=1024)
        self.cpu_log: collections.deque = collections.deque(maxlen=1024)
        self.failover_log: collections.deque = collections.deque(maxlen=1024)

    def _infer_presampled(self, req, batch, stages=None, lane="cpu"):
        with self._lock:
            log = self.failover_log if lane == "failover" else self.cpu_log
            log.append((req.client, req.seq, batch))
        return super()._infer_presampled(req, batch, stages, lane)

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

    def flight_records(self) -> list:
        """Retained flight-recorder records (oldest first): the slow,
        errored or flagged requests."""
        return flightrec.get_recorder().records()

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
                    # quiverlint: ignore[QT001] -- calibration times the whole
                    # pass on purpose
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
