"""Host-side slot bookkeeping of the cold-row overlay (copy of
``quiver_tpu/ops/coldcache.py``, which the port may not import).

The budgeted feature store keeps a degree-ordered hot prefix on the card
and the cold tail in host memory.  The overlay is a second device tier, a
fixed-capacity ``[C, dim]`` table holding whichever cold rows the traffic
keeps touching; this module is its pure-numpy metadata: id -> slot map,
per-slot hit counts, second-touch admission, CLOCK or min-frequency
eviction.  ``feature.py`` owns the device table.

The paged store (``ops/paged.py``) reuses the class as its page table: the
"rows" become host pages and the slots overlay frames
(``admit_threshold=1``: a touched host page must fault in to be served).

Instances are externally synchronized: every caller holds the owning
feature's ``_plock`` across probe and admit.

Policy:
  * second-touch admission (``admit_threshold=2`` by default): a row
    enters on its N-th miss, so one-shot scans cannot flush rows the
    recurring traffic needs.  Duplicates inside one batch each count.
  * CLOCK: one ref bit per slot, set on a hit and cleared as the hand
    sweeps; the sweep is vectorized over the whole admission batch.
  * ``"minfreq"``: evict the resident slots with the fewest hits.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["ColdRowCache", "COLD_CACHE_POLICIES"]

COLD_CACHE_POLICIES = ("clock", "minfreq")


class ColdRowCache:
    """Fixed-capacity slot table and frequency tracker over a cold-id space.

    Args:
      capacity: number of overlay slots (rows of the device table).
      n_rows: size of the cold-id space; ids given to :meth:`probe` and
        :meth:`admit` lie in ``[0, n_rows)``.
      policy: ``"clock"`` or ``"minfreq"`` eviction.
      admit_threshold: a row is admitted on its N-th observed miss.
    """

    def __init__(self, capacity: int, n_rows: int, policy: str = "clock",
                 admit_threshold: int = 2):
        capacity = int(capacity)
        n_rows = int(n_rows)
        if capacity <= 0:
            raise ValueError(f"overlay capacity must be > 0, got {capacity}")
        if policy not in COLD_CACHE_POLICIES:
            raise ValueError(f"cold-cache policy must be one of "
                             f"{COLD_CACHE_POLICIES}, got {policy!r}")
        if admit_threshold < 1:
            raise ValueError("admit_threshold must be >= 1")
        self.capacity = capacity
        self.n_rows = n_rows
        self.policy = policy
        self.admit_threshold = int(admit_threshold)
        self.slot_of = np.full(n_rows, -1, dtype=np.int32)
        self.node_of = np.full(capacity, -1, dtype=np.int64)
        self.freq = np.zeros(capacity, dtype=np.int64)   # per-slot hits
        self.ref = np.zeros(capacity, dtype=np.uint8)    # CLOCK ref bits
        self.touches = np.zeros(n_rows, dtype=np.int32)  # misses per row
        self.hand = 0
        self.next_free = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # the QoS ladder's second step: while True, admit() takes no new
        # rows (probes and hits still serve; no slot churn, no row writes)
        self.admission_paused = False

    def probe(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``(hit_mask, slots)`` aligned with ``ids``; ``slots`` means
        something only where ``hit_mask``.  Bumps per-slot frequency and
        ref bits for hits, and per-row touch counts for misses (the
        evidence :meth:`admit` reads)."""
        ids = np.asarray(ids, dtype=np.int64)
        slots = self.slot_of[ids]
        hit = slots >= 0
        hs = slots[hit]
        if hs.size:
            np.add.at(self.freq, hs, 1)
            self.ref[hs] = 1
            self.hits += int(hs.size)
        miss_ids = ids[~hit]
        if miss_ids.size:
            np.add.at(self.touches, miss_ids, 1)
            self.misses += int(miss_ids.size)
        return hit, slots

    def admit(self, ids: np.ndarray,
              protect_slots=None) -> Tuple[np.ndarray, int]:
        """Give slots to the missed rows of one batch that earned
        admission.  Returns ``(slots, n_evicted)``, ``slots`` aligned with
        ``ids`` (-1: not admitted; duplicates share a slot).  At most
        ``capacity`` rows admit per call.

        ``protect_slots`` pins resident slots against this call's
        eviction sweep: the paged store passes the batch's own hit pages,
        which the gather about to run reads.  The candidates are clipped
        so that protection never asks for more victims than the
        unprotected slots hold.
        """
        ids = np.asarray(ids, dtype=np.int64)
        out = np.full(len(ids), -1, dtype=np.int32)
        if not len(ids) or self.admission_paused:
            return out, 0
        cand = np.unique(ids[self.touches[ids] >= self.admit_threshold])
        n_prot = (len(np.unique(protect_slots))
                  if protect_slots is not None and len(protect_slots)
                  else 0)
        cand = cand[: self.capacity - n_prot]
        k = len(cand)
        if k == 0:
            return out, 0
        slots = np.empty(k, dtype=np.int32)
        n_new = min(self.capacity - self.next_free, k)
        if n_new:
            slots[:n_new] = np.arange(self.next_free, self.next_free + n_new,
                                      dtype=np.int32)
            self.next_free += n_new
        n_evicted = 0
        if k > n_new:
            # the slots just taken from the free list still have ref and
            # freq 0: protect them, or the sweep hands them out twice
            prot = slots[:n_new]
            if n_prot:
                prot = np.concatenate(
                    [prot, np.asarray(protect_slots, dtype=np.int32)])
            victims = self._evict(k - n_new, protect=prot)
            slots[n_new:] = victims
            old = self.node_of[victims]
            live = old >= 0
            self.slot_of[old[live]] = -1
            n_evicted = int(live.sum())
            self.evictions += n_evicted
        self.node_of[slots] = cand
        self.slot_of[cand] = slots
        self.freq[slots] = 1
        # ref 0 on insert: the touches are spent, the ref bit tracks reuse
        # after admission
        self.ref[slots] = 0
        self.touches[cand] = 0
        return self.slot_of[ids], n_evicted

    def _evict(self, need: int, protect=None) -> np.ndarray:
        prot = np.zeros(self.capacity, dtype=bool)
        if protect is not None and len(protect):
            prot[protect] = True
        if self.policy == "minfreq":
            f = self.freq.copy()
            f[prot] = np.iinfo(f.dtype).max
            return np.argpartition(f, need - 1)[:need].astype(np.int32)
        # batched CLOCK: from the hand, ref-0 slots are victims and every
        # slot passed on the way loses its ref bit (second chance)
        cap = self.capacity
        order = np.concatenate(
            [np.arange(self.hand, cap), np.arange(0, self.hand)]
        ).astype(np.int32)
        order = order[~prot[order]]
        zero_pos = np.nonzero(self.ref[order] == 0)[0]
        if len(zero_pos) >= need:
            last = int(zero_pos[need - 1])
            self.ref[order[: last + 1]] = 0
            self.hand = int(order[last] + 1) % cap
            return order[zero_pos[:need]]
        # one sweep found too few: every bit is now clear, the rest come
        # from the second sweep in order
        victims = order[zero_pos]
        taken = np.zeros(cap, dtype=bool)
        taken[victims] = True
        rest = order[~taken[order]][: need - len(victims)]
        self.ref[order] = 0
        out = np.concatenate([victims, rest]).astype(np.int32)
        self.hand = int(out[-1] + 1) % cap
        return out

    def invalidate_rows(self, rows: np.ndarray) -> int:
        """Drop the given cold-space rows (their values changed).  Freed
        slots keep ref and freq 0, so the next sweep hands them out
        first; touch counts reset, so a row re-earns admission.  Returns
        the resident rows dropped."""
        rows = np.asarray(rows, dtype=np.int64)
        rows = rows[(rows >= 0) & (rows < self.n_rows)]
        if rows.size == 0:
            return 0
        slots = self.slot_of[rows]
        live = slots >= 0
        freed = slots[live]
        if freed.size:
            self.node_of[freed] = -1
            self.freq[freed] = 0
            self.ref[freed] = 0
            self.slot_of[rows[live]] = -1
        self.touches[rows] = 0
        return int(freed.size)

    def export_state(self) -> dict:
        """Residency and frequency state for a recovery checkpoint: numpy
        copies and Python scalars (the checkpoint pins the arrays' dtypes
        on disk).  Caller holds the owning store's ``_plock``."""
        return {
            "capacity": self.capacity, "n_rows": self.n_rows,
            "policy": self.policy, "admit_threshold": self.admit_threshold,
            "hand": int(self.hand), "next_free": int(self.next_free),
            "hits": int(self.hits), "misses": int(self.misses),
            "evictions": int(self.evictions),
            "slot_of": self.slot_of.copy(), "node_of": self.node_of.copy(),
            "freq": self.freq.copy(), "ref": self.ref.copy(),
            "touches": self.touches.copy(),
        }

    def restore_state(self, state: dict) -> None:
        """Adopt an exported state.  The geometry (capacity, cold-row
        space) must match this instance: a warm restart with a re-sized
        overlay starts cold instead (the caller treats the
        ``ValueError`` as "no restore", not as a boot failure)."""
        if int(state["capacity"]) != self.capacity:
            raise ValueError(
                f"overlay capacity changed: snapshot has "
                f"{state['capacity']}, this cache has {self.capacity}")
        if int(state["n_rows"]) != self.n_rows:
            raise ValueError(
                f"cold-row space changed: snapshot has {state['n_rows']} "
                f"rows, this cache has {self.n_rows}")
        self.slot_of = np.array(state["slot_of"], dtype=np.int32)
        self.node_of = np.array(state["node_of"], dtype=np.int64)
        self.freq = np.array(state["freq"], dtype=np.int64)
        self.ref = np.array(state["ref"], dtype=np.uint8)
        self.touches = np.array(state["touches"], dtype=np.int32)
        self.hand = int(state["hand"])
        self.next_free = int(state["next_free"])
        self.hits = int(state["hits"])
        self.misses = int(state["misses"])
        self.evictions = int(state["evictions"])

    @property
    def resident(self) -> int:
        return int((self.node_of >= 0).sum())

    def resident_bytes(self, row_bytes: int) -> int:
        """Device bytes the resident entries pin, given the bytes of one
        cached unit (a feature row; a whole page in the paged store)."""
        return self.resident * int(row_bytes)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return dict(
            capacity=self.capacity, resident=self.resident,
            hits=self.hits, misses=self.misses, evictions=self.evictions,
            hit_rate=(self.hits / total) if total else 0.0,
            policy=self.policy, admit_threshold=self.admit_threshold,
        )

    def __repr__(self):
        return (f"ColdRowCache(capacity={self.capacity}, "
                f"resident={self.resident}, policy={self.policy!r}, "
                f"hit_rate={self.stats()['hit_rate']:.3f})")
