"""Two-tier feature store over a hybrid ``[dcn, ici]`` mesh (counterpart
of ``quiver_tpu/dist/hier.py``; the reference's NVLink clique in front of
its NCCL tier).

  * hot tier: rows ``[0, hot_count)`` (degree order), sharded over the
    ``ici`` axis and replicated on every ``dcn`` row: a hot query never
    leaves its host group;
  * cold tier: the other rows partitioned by owner host (``dcn``) and
    sub-sharded over that host's chips (``ici``).

A lookup routes each query to its owner host (the ``dcn`` all-to-all),
then to the owner chip (the ``ici`` all-to-all), gathers locally with
kernel B2 (the hot slice and the cold slice, selected per row, as JAX
reads both), and returns through the two reversed exchanges.  Every
exchange uses fixed-capacity buckets: an overflowed query returns a zero
row and is counted in :meth:`traffic_stats`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.cuda.gather_rows import gather_rows
from ..utils.mesh import host_tensor
from .buckets import bucket, pack_ids
from .comm import all_to_all

__all__ = ["HierFeature"]


def _rows_back(back: torch.Tensor, dest: torch.Tensor,
               n_slots: int) -> torch.Tensor:
    """Each query's returned row out of the exchange's slots; a dropped
    query (``dest == n_slots``) reads the appended zero row."""
    flat = torch.cat([back.reshape(n_slots, -1),
                      torch.zeros((1, back.shape[-1]), dtype=back.dtype,
                                  device=back.device)])
    return gather_rows(flat, torch.clamp(dest, 0, n_slots))


class HierFeature:
    """Hierarchical (host group x chip) sharded feature store.

    Args:
      mesh: 2-axis mesh, ``dcn`` major, ``ici`` minor
        (:func:`~quiver_tpu_torch.dist.make_hybrid_mesh`).
      hot_count: rows ``[0, hot_count)`` are the hot tier.
      global2host: ``[N]`` owner host a node (cold rows); default: a
        contiguous range partition of the cold tail.
      dcn_cap / ici_cap: bucket capacities of the two exchanges (default:
        the exact worst case, nothing dropped).
    """

    def __init__(self, mesh, hot_count: int, global2host=None,
                 dcn_axis: str = "dcn", ici_axis: str = "ici",
                 dcn_cap: Optional[int] = None,
                 ici_cap: Optional[int] = None):
        self.mesh = mesh
        self.dcn_axis, self.ici_axis = dcn_axis, ici_axis
        self.H = int(mesh.shape[dcn_axis])
        self.C = int(mesh.shape[ici_axis])
        if mesh.axis_names.index(dcn_axis) != 0:
            raise ValueError("HierFeature needs the dcn axis major")
        self.hot_count = hot_count
        self.global2host = global2host
        self.dcn_cap, self.ici_cap = dcn_cap, ici_cap
        self.last_dcn_cross = None
        self.last_drops = None

    @classmethod
    def from_global_feature(cls, feature, mesh, hot_count: int,
                            global2host=None, **kw):
        self = cls(mesh, hot_count, global2host, **kw)
        src = host_tensor(feature)
        N, D = src.shape
        H, C = self.H, self.C
        hot_count = min(hot_count, N)
        self.hot_count = hot_count = hot_count - hot_count % C
        self.node_count, self.dim = N, D
        self.dtype = src.dtype
        devs = mesh.devices
        # hot tier: [hot_count, D] sharded over ici, replicated over dcn
        if hot_count:
            self.hot_shard = hot_count // C
            hot = src[:hot_count]
        else:
            self.hot_shard = 1
            hot = torch.zeros((C, D), dtype=src.dtype)
        n_cold = N - hot_count
        if global2host is None:
            g2h = np.minimum(
                (np.arange(N, dtype=np.int64) - hot_count)
                // max(1, -(-n_cold // H)), H - 1).astype(np.int32)
            g2h[:hot_count] = 0
        else:
            g2h = np.asarray(global2host, dtype=np.int32).copy()
        g2l = np.zeros(N, dtype=np.int32)
        counts = np.zeros(H, dtype=np.int64)
        cold_ids = np.arange(hot_count, N)
        for h in range(H):
            ids = cold_ids[g2h[cold_ids] == h]
            g2l[ids] = np.arange(len(ids), dtype=np.int32)
            counts[h] = len(ids)
        m = int(counts.max()) if n_cold else 1
        self.m_c = m_c = -(-m // C)  # cold rows a chip
        m = m_c * C
        cold = torch.zeros((H * m, D), dtype=src.dtype)
        for h in range(H):
            ids = cold_ids[g2h[cold_ids] == h]
            cold[torch.from_numpy(h * m + g2l[ids].astype(np.int64))] = \
                src[torch.from_numpy(ids)]
        hs = self.hot_shard
        self.hot = [[hot[c * hs:(c + 1) * hs].contiguous().to(devs[h, c])
                     for c in range(C)] for h in range(H)]
        self.cold = [[cold[(h * C + c) * m_c:(h * C + c + 1) * m_c]
                      .contiguous().to(devs[h, c]) for c in range(C)]
                     for h in range(H)]
        self._g2h_np = g2h
        self._maps = [[dict(g2h=torch.from_numpy(g2h.astype(np.int64)).to(
            devs[h, c]), g2l=torch.from_numpy(g2l.astype(np.int64)).to(
                devs[h, c])) for c in range(C)] for h in range(H)]
        return self

    def lookup(self, ids, valid=None) -> torch.Tensor:
        """``ids``: ``[H, C, B]`` (one batch a chip).  Returns ``[H, C, B,
        D]`` on the first chip's device; :meth:`traffic_stats` then has
        the cross-``dcn`` counts."""
        ids = torch.as_tensor(ids).to(torch.int64)
        H, C, B = ids.shape
        if (H, C) != (self.H, self.C):
            raise ValueError(f"ids {tuple(ids.shape)} for a [{self.H}, "
                             f"{self.C}] mesh")
        if valid is None:
            valid = torch.ones((H, C, B), dtype=torch.bool)
        valid = torch.as_tensor(valid).to(torch.bool)
        dcap = self.dcn_cap or B            # exact: one host owns all B
        icap = self.ici_cap or H * dcap     # exact: one chip owns all
        devs = self.mesh.devices
        hc, hs, m_c = self.hot_count, self.hot_shard, self.m_c
        grid = [(h, c) for h in range(H) for c in range(C)]
        st1 = {}
        for h, c in grid:
            q = ids[h, c].to(devs[h, c])
            v = valid[h, c].to(devs[h, c])
            qc = q.clamp(0, self.node_count - 1)
            dest_h = torch.where(q < hc, torch.full_like(q, h),
                                 self._maps[h][c]["g2h"][qc])
            d1, ovf1 = bucket(dest_h, v, H, dcap)
            st1[h, c] = dict(q=q, v=v, dest_h=dest_h, d1=d1, ovf1=ovf1,
                             reqs=pack_ids(q, d1, H * dcap).view(H, dcap))
        # stage 1: to the owner host, over dcn (chips with the same c)
        for c in range(C):
            recv = all_to_all([st1[h, c]["reqs"] for h in range(H)])
            for h in range(H):
                st1[h, c]["recv"] = recv[h]
        st2 = {}
        for h, c in grid:
            r1 = st1[h, c]["recv"].reshape(-1).to(torch.int64) - 1
            v1 = r1 >= 0
            r1s = torch.clamp_min(r1, 0)
            dest_c = torch.where(r1s < hc, torch.div(r1s, hs,
                                                     rounding_mode="floor"),
                                 torch.div(self._maps[h][c]["g2l"][r1s], m_c,
                                           rounding_mode="floor"))
            d2, ovf2 = bucket(dest_c, v1, C, icap)
            st2[h, c] = dict(v1=v1, d2=d2, ovf2=ovf2,
                             reqs=pack_ids(r1s, d2, C * icap).view(C, icap))
        # stage 2: to the owner chip, over ici (chips with the same h)
        for h in range(H):
            recv = all_to_all([st2[h, c]["reqs"] for c in range(C)])
            for c in range(C):
                st2[h, c]["recv"] = recv[c]
        rows2 = {}
        for h, c in grid:
            r2 = st2[h, c]["recv"].reshape(-1).to(torch.int64) - 1
            v2 = r2 >= 0
            r2s = torch.clamp_min(r2, 0)
            hot = gather_rows(self.hot[h][c], torch.remainder(r2s, hs))
            cold = gather_rows(self.cold[h][c], torch.remainder(
                self._maps[h][c]["g2l"][r2s], m_c))
            rows = torch.where((r2s < hc)[:, None], hot, cold)
            rows = torch.where(v2[:, None], rows,
                               torch.zeros((), dtype=rows.dtype,
                                           device=rows.device))
            rows2[h, c] = rows.view(C, icap, -1)
        # reverse stage 2 (ici) to the in-host requester slot
        for h in range(H):
            back = all_to_all([rows2[h, c] for c in range(C)])
            for c in range(C):
                s2 = st2[h, c]
                r1 = _rows_back(back[c], s2["d2"], C * icap)
                r1 = torch.where(s2["v1"][:, None], r1,
                                 torch.zeros((), dtype=r1.dtype,
                                             device=r1.device))
                st1[h, c]["rows1"] = r1.view(H, dcap, -1)
        # reverse stage 1 (dcn) home to the querying chip
        outs, cross, drops = {}, {}, {}
        for c in range(C):
            back = all_to_all([st1[h, c]["rows1"] for h in range(H)])
            for h in range(H):
                s1 = st1[h, c]
                out = _rows_back(back[h], s1["d1"], H * dcap)
                ok = s1["v"] & ~s1["ovf1"]
                outs[h, c] = torch.where(ok[:, None], out,
                                         torch.zeros((), dtype=out.dtype,
                                                     device=out.device))
                cross[h, c] = (s1["v"] & (s1["dest_h"] != h)).sum()
                drops[h, c] = (s1["ovf1"].sum()
                               + (st2[h, c]["v1"] & st2[h, c]["ovf2"]).sum())
        dev0 = devs[0, 0]
        out = torch.stack([torch.stack([outs[h, c].to(dev0)
                                        for c in range(C)])
                           for h in range(H)])
        self.last_dcn_cross = torch.stack([torch.stack(
            [cross[h, c].to(dev0) for c in range(C)]) for h in range(H)]
        ).to(torch.int32)
        self.last_drops = torch.stack([torch.stack(
            [drops[h, c].to(dev0) for c in range(C)]) for h in range(H)]
        ).to(torch.int32)
        return out

    def traffic_stats(self):
        """Per-chip ``[H, C]`` counts of the last lookup: queries that
        crossed ``dcn``, and bucket-overflow drops (0 at default caps);
        ``dcn_bytes_est`` counts 4-byte elements, as JAX does."""
        if self.last_dcn_cross is None:
            return None
        cross = self.last_dcn_cross.cpu().numpy()
        return dict(
            dcn_crossings=cross,
            drops=self.last_drops.cpu().numpy(),
            dcn_bytes_est=int(cross.sum() * self.dim
                              * np.dtype(np.float32).itemsize))
