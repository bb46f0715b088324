"""AnnSearcher: the device-resident query-time face of the ANN index.

Counterpart of the JAX package's `ann/search.py`: probe (`centroid_topk`)
-> ONE batched `ann_gather_scan` over the probed cluster tiles -> f32
rescore of the survivors -> exact (score desc, docid asc) order, with one
device-to-host copy per batch.

The tail tier: vectors appended after the index was built are in no
cluster tile; they are scanned exactly (`scan_topk` in matmul mode) and
merged into the candidates before the rescore, so a stale partition index
costs speed, never recall, until the next rebuild.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import scan_topk
from ..utils.torch_env import host_tensor, resolve_device
from .index import ann_to_device
from .kernels import SCAN_TIERS, ann_gather_scan, centroid_topk, slot_live

# survivors carried into the f32 rescore per requested k
OVERSAMPLE = 4


def default_nprobe(nlist: int, tile: int, num_candidates: int) -> int:
    """Probes sized so the scanned slots cover ~num_candidates vectors,
    floor 1, plus one for partition-boundary slop."""
    if nlist <= 0:
        return 1
    return min(nlist, max(1, -(-num_candidates // max(tile, 1)) + 1))


class AnnSearcher:
    """ANN over one vector corpus on `device` (the CUDA card by default).

    vectors/sq_norms are the FULL current corpus (the f32 rescore and the
    exact tail read them); the cluster tiles cover only the first
    `built_n` rows, everything beyond is tail."""

    def __init__(self, ann: dict, vectors, sq_norms, similarity: str, live=None,
                 tier: str = "int8", device=None):
        if tier not in SCAN_TIERS:
            raise ValueError(f"unknown ANN scan tier [{tier}]")
        self.device = resolve_device(device)
        self.similarity = similarity
        self.tier = tier
        self.vectors = host_tensor(vectors, np.float32, self.device)  # [N, D]
        self.sq_norms = host_tensor(sq_norms, np.float32, self.device)
        N = self.vectors.shape[0]
        self.live = (torch.ones(N, dtype=torch.bool, device=self.device) if live is None
                     else host_tensor(live, np.bool_, self.device))
        self.nlist = int(ann["nlist"])
        self.tile = int(ann["tile"])
        self.built_n = int(ann["built_n"])
        self.dev = ann_to_device(ann, self.vectors, self.device)
        # the exact tail's [D, tail] operand
        self._tail_t = self.vectors[self.built_n:].T.contiguous() if N > self.built_n else None
        self._live_slots = None  # derived; invalidated by set_live

    def set_live(self, live) -> None:
        """Deletes: replace the live mask (the slot mask is derived again at
        the next search)."""
        self.live = host_tensor(live, np.bool_, self.device)
        self._live_slots = None

    def _slot_live(self) -> torch.Tensor:
        if self._live_slots is None:
            self._live_slots = slot_live(self.dev["order"], self.live)
        return self._live_slots

    def search(self, qvecs, k: int, *, nprobe: int | None = None,
               num_candidates: int | None = None, tier: str | None = None):
        """-> (scores [B, k], ids [B, k], totals [B]) numpy. Scores are exact
        f32 (rescored); the candidate SET is approximate, its recall governed
        by nprobe. Empty lanes: -inf score, id -1."""
        from ..ops.vector import _aux_for, _exact_rows, _fetch_rows, _rescore_knn

        tier = tier or self.tier
        q = host_tensor(qvecs, np.float32, self.device).contiguous()
        B = q.shape[0]
        nc = num_candidates or max(k * OVERSAMPLE, k)
        if nprobe is None:
            nprobe = default_nprobe(self.nlist, self.tile, nc)
        nprobe = max(1, min(nprobe, self.nlist))
        kb = min(max(k, min(nc, 128)), nprobe * self.tile)
        probes = centroid_topk(self.dev["centroids"], q, nprobe=nprobe)
        sel_v, sel_i, totals = ann_gather_scan(q, probes, self.dev, self._slot_live(), kb,
                                               tier=tier, similarity=self.similarity)
        sel_ok = torch.isfinite(sel_v)
        if self._tail_t is not None:
            tail_n = self._tail_t.shape[1]
            taux_d, taux_q = _aux_for(self.similarity, self.sq_norms[self.built_n:], q)
            tv, ti, tt = scan_topk(q, self._tail_t, self.live[self.built_n:], min(k, tail_n),
                                   transform=self.similarity, aux_doc=taux_d, aux_q=taux_q,
                                   count_positive=False)
            sel_i = torch.cat([sel_i, ti + self.built_n], dim=1)
            sel_ok = torch.cat([sel_ok, torch.isfinite(tv)], dim=1)
            totals = totals + tt
        k_eff = min(k, sel_i.shape[1])
        aux_doc, aux_q = _aux_for(self.similarity, self.sq_norms, q)
        resc = _rescore_knn(q, self.vectors, sel_i, sel_ok, aux_doc, aux_q, self.similarity)
        v, i = _exact_rows(resc, sel_i, sel_ok, k_eff)
        i = torch.where(torch.isfinite(v), i, torch.full_like(i, -1))
        v, i, totals = _fetch_rows(v, i, totals)
        if k > k_eff:
            pad = ((0, 0), (0, k - k_eff))
            v = np.pad(v, pad, constant_values=-np.inf)
            i = np.pad(i, pad, constant_values=-1)
        return v, i, totals
