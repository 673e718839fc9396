"""Adaptive device + CPU mixed sampling (counterpart of
``quiver_tpu/mixed.py``).

A :class:`SampleJob` is an indexable list of seed batches.  Each epoch
:class:`MixedGraphSageSampler` splits its tasks between the device sampler,
which runs on the calling thread, and the native host sampler, which runs
on worker threads (the native call releases the GIL).  After each epoch
the measured mean task times set the next epoch's CPU share so that both
lanes finish together, as the reference's ``decide_task_num`` does.

The mode names and the ``"tpu"``/``"cpu"`` source labels are the JAX
package's; ``"tpu"`` names the device lane, here the card.  Each task
ticks ``mixed_tasks_total{lane}`` and ``mixed_task_seconds{lane}``, and
each epoch sets ``mixed_avg_task_seconds{lane}``, in the registry under
the same labels.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Generic, Iterator, List, Sequence, TypeVar

import numpy as np
import torch

from . import telemetry
from .sampler import GraphSageSampler
from .utils.shutdown import join_and_reap
from .utils.topology import CSRTopo

T_co = TypeVar("T_co", covariant=True)

__all__ = ["SampleJob", "RangeSampleJob", "MixedGraphSageSampler"]


class SampleJob(Generic[T_co]):
    """Abstract indexable task list."""

    def __getitem__(self, index) -> T_co:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def shuffle(self) -> None:
        raise NotImplementedError


class RangeSampleJob(SampleJob):
    """Seed ids chunked into fixed-size batches, shuffled by a seeded
    generator."""

    def __init__(self, ids: np.ndarray, batch_size: int, seed: int = 0):
        self.ids = np.asarray(ids)
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return (len(self.ids) + self.batch_size - 1) // self.batch_size

    def __getitem__(self, i):
        return self.ids[i * self.batch_size: (i + 1) * self.batch_size]

    def shuffle(self):
        self._rng.shuffle(self.ids)


class MixedGraphSageSampler:
    """Iterate a :class:`SampleJob`, splitting its tasks between the device
    and the host sampler.

    Modes: ``"TPU_CPU_MIXED"`` (default; ``"UVA_CPU_MIXED"`` and
    ``"GPU_CPU_MIXED"`` are aliases), ``"TPU_ONLY"`` (``"UVA_ONLY"``,
    ``"GPU_ONLY"``) and ``"CPU_ONLY"``.  Iterating yields ``(SampledBatch,
    source)`` once per task, ``source`` ``"tpu"`` (the device lane) or
    ``"cpu"``; both lanes' batches are on ``device`` (the card by
    default).
    """

    _ALIASES = {
        "UVA_CPU_MIXED": "TPU_CPU_MIXED", "GPU_CPU_MIXED": "TPU_CPU_MIXED",
        "UVA_ONLY": "TPU_ONLY", "GPU_ONLY": "TPU_ONLY",
    }

    def __init__(self, csr_topo: CSRTopo, sizes: Sequence[int],
                 sample_job: SampleJob, device=None,
                 mode: str = "TPU_CPU_MIXED", num_workers: int = 4,
                 frontier_caps=None):
        mode = self._ALIASES.get(mode, mode)
        if mode not in ("TPU_CPU_MIXED", "TPU_ONLY", "CPU_ONLY"):
            raise ValueError(f"unknown mode {mode!r}")
        if num_workers < 1 and mode != "TPU_ONLY":
            # without workers the CPU lane cannot run
            if mode == "CPU_ONLY":
                raise ValueError("CPU_ONLY requires num_workers >= 1")
            warnings.warn("TPU_CPU_MIXED with num_workers=0 cannot run a "
                          "CPU lane; falling back to TPU_ONLY", stacklevel=2)
            mode = "TPU_ONLY"
        self.mode = mode
        self.job = sample_job
        self.num_workers = num_workers
        self.device_sampler = (
            GraphSageSampler(csr_topo, sizes, device=device, mode="GPU",
                             frontier_caps=frontier_caps)
            if mode != "CPU_ONLY" else None)
        self.cpu_sampler = (
            GraphSageSampler(csr_topo, sizes, device=device, mode="CPU")
            if mode != "TPU_ONLY" else None)
        # the feedback state of the reference's decide_task_num
        self.avg_tpu_time = None
        self.avg_cpu_time = None

    def _decide_cpu_share(self, n_tasks: int) -> int:
        if self.mode == "CPU_ONLY":
            return n_tasks
        if self.mode == "TPU_ONLY":
            return 0
        if self.avg_tpu_time is None or self.avg_cpu_time is None:
            # a seeding epoch measures both lanes: at least one CPU task
            # whenever there are two or more
            if n_tasks < 2:
                return 0
            return min(self.num_workers, max(1, n_tasks // 4))
        # the share that equalizes the lanes' finish times
        tpu_rate = 1.0 / max(self.avg_tpu_time, 1e-9)
        cpu_rate = self.num_workers / max(self.avg_cpu_time, 1e-9)
        share = n_tasks * cpu_rate / (tpu_rate + cpu_rate)
        return int(min(share, n_tasks))

    def __iter__(self) -> Iterator:
        self.job.shuffle()
        n = len(self.job)
        cpu_share = self._decide_cpu_share(n)
        cpu_tasks = list(range(n - cpu_share, n))
        tpu_tasks = list(range(0, n - cpu_share))
        results: "queue.Queue" = queue.Queue()
        cpu_times: List[float] = []
        stop = threading.Event()

        def cpu_worker(task_ids):
            for t in task_ids:
                if stop.is_set():
                    return
                try:
                    t0 = time.perf_counter()
                    batch = self.cpu_sampler.sample(self.job[t])
                    dt = time.perf_counter() - t0
                    cpu_times.append(dt)
                    telemetry.counter("mixed_tasks_total", lane="cpu").inc()
                    telemetry.histogram("mixed_task_seconds",
                                        lane="cpu").observe(dt)
                    results.put((batch, "cpu"))
                except Exception as e:  # noqa: BLE001 -- the consumer raises it
                    results.put((e, "error"))

        threads = []
        if cpu_tasks and self.cpu_sampler is not None:
            for c in np.array_split(np.asarray(cpu_tasks), self.num_workers):
                if len(c) == 0:
                    continue
                th = threading.Thread(target=cpu_worker, args=(c.tolist(),),
                                      daemon=True)
                th.start()
                threads.append(th)

        tpu_times: List[float] = []
        produced = 0
        dev = (self.device_sampler.device if self.device_sampler is not None
               else None)
        try:
            for t in tpu_tasks:
                t0 = time.perf_counter()
                batch = self.device_sampler.sample(self.job[t])
                # the split needs the device lane's whole time
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
                dt = time.perf_counter() - t0
                tpu_times.append(dt)
                telemetry.counter("mixed_tasks_total", lane="tpu").inc()
                telemetry.histogram("mixed_task_seconds",
                                    lane="tpu").observe(dt)
                yield batch, "tpu"
                produced += 1
                while not results.empty():
                    item = results.get_nowait()
                    if item[1] == "error":
                        raise item[0]
                    yield item
                    produced += 1
            while produced < n:
                item = results.get(timeout=300)
                if item[1] == "error":
                    raise item[0]
                yield item
                produced += 1
        finally:
            stop.set()
            join_and_reap(threads, 5.0, component="mixed.cpu_workers")
        if tpu_times:
            self.avg_tpu_time = float(np.mean(tpu_times))
            telemetry.gauge("mixed_avg_task_seconds", lane="tpu").set(
                self.avg_tpu_time)
        if cpu_times:
            self.avg_cpu_time = float(np.mean(cpu_times))
            telemetry.gauge("mixed_avg_task_seconds", lane="cpu").set(
                self.avg_cpu_time)
