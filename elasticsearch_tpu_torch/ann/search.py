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
from ..telemetry import device_window, time_kernel
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
        self._windows: list = []  # the last selection's device windows

    def set_live(self, live) -> None:
        """Deletes: replace the live mask (the slot mask is derived again at
        the next search)."""
        self.live = host_tensor(live, np.bool_, self.device)
        self._live_slots = None

    def _slot_live(self) -> torch.Tensor:
        if self._live_slots is None:
            self._live_slots = slot_live(self.dev["order"], self.live)
        return self._live_slots

    def selection(self, q: torch.Tensor, k: int, *, nprobe: int | None = None,
                  num_candidates: int | None = None, tier: str | None = None):
        """The tile scan of `search` for query rows q [B, D] f32 on the
        device: the probe, then one `ann_gather_scan`. -> (sel_v [B, kb],
        sel_i [B, kb], totals [B]): the kb best SELECTION scores of the
        probed tiles by (score desc, docid asc), kb = min(max(k,
        min(num_candidates, 128)), nprobe * tile)."""
        nc = num_candidates or max(k * OVERSAMPLE, k)
        if nprobe is None:
            nprobe = default_nprobe(self.nlist, self.tile, nc)
        nprobe = max(1, min(nprobe, self.nlist))
        kb = min(max(k, min(nc, 128)), nprobe * self.tile)
        tier = tier or self.tier
        B, D = q.shape
        # the probe and the scan as device windows, accounted once `search`
        # has copied the rows back (no synchronization of their own)
        probe = device_window("ann.centroid_probe", self.device, tier="ann", queries=B, dims=D,
                              nlist=self.nlist, nprobe=nprobe)
        with probe:
            probes = centroid_topk(self.dev["centroids"], q, nprobe=nprobe)
        scan = device_window("ann.gather_scan", self.device, tier=f"ann_{tier}", queries=B,
                             dims=D, nprobe=nprobe, tile=self.tile, kb=kb, scan_tier=tier,
                             num_docs=self.built_n)
        with scan:
            out = ann_gather_scan(q, probes, self.dev, self._slot_live(), kb,
                                  tier=tier, similarity=self.similarity)
        self._windows = [probe, scan]
        return out

    def search(self, qvecs, k: int, *, nprobe: int | None = None,
               num_candidates: int | None = None, tier: str | None = None):
        """-> (scores [B, k], ids [B, k], totals [B]) numpy. Scores are exact
        f32 (rescored); the candidate SET is approximate, its recall governed
        by nprobe. Empty lanes: -inf score, id -1."""
        from ..ops.vector import _aux_for, _exact_rows, _fetch_rows, _rescore_knn

        q = host_tensor(qvecs, np.float32, self.device).contiguous()
        sel_v, sel_i, totals = self.selection(q, k, nprobe=nprobe,
                                              num_candidates=num_candidates, tier=tier)
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
        with time_kernel("ann.rescore", self.device, tier="ann", queries=q.shape[0],
                         dims=q.shape[1], kb=int(sel_i.shape[1]), k=k_eff):
            aux_doc, aux_q = _aux_for(self.similarity, self.sq_norms, q)
            resc = _rescore_knn(q, self.vectors, sel_i, sel_ok, aux_doc, aux_q, self.similarity)
            v, i = _exact_rows(resc, sel_i, sel_ok, k_eff)
            i = torch.where(torch.isfinite(v), i, torch.full_like(i, -1))
            v, i, totals = _fetch_rows(v, i, totals)
        for w in self._windows:
            w.close()
        self._windows = []
        if k > k_eff:
            pad = ((0, 0), (0, k - k_eff))
            v = np.pad(v, pad, constant_values=-np.inf)
            i = np.pad(i, pad, constant_values=-1)
        return v, i, totals

    def selection_bound(self, q: torch.Tensor, ids: torch.Tensor, tier: str | None = None):
        """A bound on |the tier's selection score - the exact score| of each
        (query row, doc) pair, in score space. q [B, D] f32, ids [B, m] doc
        ids of the built tiles -> [B, m] f64 numpy: the tier's quantisation
        error (int8: sum_d |q_d| * scale / 2, the per-vector scale of
        `ann/quantize.py`; bf16: q cut to bf16 against x, and the cut q
        against x - hi - lo), the f32 rounding of the selection's and the
        exact scan's sums (2 (D + 2) 2^-24 per term, the bf16 selection's
        2D terms twice that), times the transform's slope at the pair
        (cosine: |q|^-1 |x|^-1 / 2), plus 2^-21 (1 + |score|) for the
        transforms' own rounding."""
        from ..ops.kernels import _mask_hi

        tier = tier or self.tier
        D = q.shape[1]
        dev = self.device
        order = self.dev["order"]
        flat = torch.full((self.vectors.shape[0],), -1, dtype=torch.long, device=dev)
        pos = torch.nonzero(order.reshape(-1) >= 0)[:, 0]
        flat[order.reshape(-1)[pos].long()] = pos
        slot = flat[ids.long()]
        if (slot < 0).any():
            raise ValueError("selection_bound: an id outside the built tiles")
        L = order.shape[1]
        c, l_ = slot // L, slot % L
        q64 = q.double()[:, None, :]  # [B, 1, D]
        x = self.vectors[ids.long()].double()  # [B, m, D]
        eps = 2.0 * (D + 2) * 2.0 ** -24
        exact = eps * (q64.abs() * x.abs()).sum(-1)
        if tier == "int8":
            scale = self.dev["scale"][c, l_].double()
            offset = self.dev["offset"][c, l_].double()
            codes = self.dev["codes"][c, l_].double()  # [B, m, D]
            qa = q64.abs()
            dot = (scale / 2.0 * qa.sum(-1)
                   + eps * (qa * (scale[..., None] * codes.abs() + offset.abs()[..., None])).sum(-1))
        else:
            qh = _mask_hi(q).double()[:, None, :]
            hi = self.dev["hi"][c, l_].double()
            lo = self.dev["lo"][c, l_].double()
            dot = (((q64 - qh).abs() * x.abs()).sum(-1) + (qh.abs() * (x - hi - lo).abs()).sum(-1)
                   + 2.0 * eps * (qh.abs() * (hi.abs() + lo.abs())).sum(-1))
        dots = (q64 * x).sum(-1)
        if self.similarity == "cosine":
            slope = 1.0 / (2.0 * torch.sqrt((x * x).sum(-1)) * torch.sqrt((q64 * q64).sum(-1)))
            score = 0.5 + dots * slope
        else:
            slope = {"dot_product": 0.5, "l2_norm": 2.0}.get(self.similarity, 1.0)
            score = dots
        bound = slope * (dot + exact) + 2.0 ** -21 * (1.0 + score.abs())
        return bound.cpu().numpy()


def check_ann_rows(got, exact, sel_kb, bound, what: str) -> tuple[int, int]:
    """Hold ANN rows to the exact scan's by the selection's stated error
    (`AnnSearcher.selection_bound`), as `ops/kernels.check_tiered_selection`
    holds a selection to its twin. got, exact: (values [B, k], ids [B, k])
    numpy, rows in (score desc, id asc) order; sel_kb [B]: each row's kb-th
    selection score (-inf: the selection kept every live candidate);
    bound [B, k]: the bound at the exact rows' ids. Raises AssertionError
    unless, in every row:
      - the finite lanes are as many;
      - an id in both rows has scores within 1e-6 relative;
      - an exact id missing from the row either ties the exact k-th score
        within 1e-5 relative (fp-ties), or could have lost the selection by
        the tier's error: exact score - bound <= the kb-th selection score;
      - a returned id missing from the exact row scores at most the exact
        k-th score (plus 1e-5 relative): it displaces a neighbour only
        where one was dropped;
      - the row is ordered by (score desc, id asc).
    -> (neighbours dropped by the selection error, ids swapped among
    fp-ties)."""
    gv, gi = got
    ev, ei = exact
    dropped = swapped = 0
    for r in range(ev.shape[0]):
        fin = np.isfinite(ev[r])
        if int(np.isfinite(gv[r]).sum()) != int(fin.sum()):
            raise AssertionError(f"{what}: row {r} has another number of hits")
        n = int(fin.sum())
        if n == 0:
            continue
        want = {int(i): (float(v), float(b)) for i, v, b in zip(ei[r, :n], ev[r, :n], bound[r, :n])}
        have = {int(i): float(v) for i, v in zip(gi[r, :n], gv[r, :n])}
        kth = float(ev[r, n - 1])
        for i, v in have.items():
            if i in want:
                w = want[i][0]
                if abs(v - w) > 1e-6 * abs(w):
                    raise AssertionError(f"{what}: row {r} id {i} scores {v}, the exact scan {w}")
            elif v > kth + 1e-5 * abs(kth):
                raise AssertionError(f"{what}: row {r} returns id {i} at {v} above the exact "
                                     f"k-th score {kth}")
        for i, (w, b) in want.items():
            if i in have:
                continue
            if abs(w - kth) <= 1e-5 * abs(kth):
                swapped += 1
            elif w - b <= float(sel_kb[r]):
                dropped += 1
            else:
                raise AssertionError(
                    f"{what}: row {r} drops id {i} (exact score {w}, bound {b:.3g}) above the "
                    f"kb-th selection score {float(sel_kb[r])}")
        v, i_ = gv[r, :n], gi[r, :n]
        if not ((v[:-1] > v[1:]) | ((v[:-1] == v[1:]) & (i_[:-1] < i_[1:]))).all():
            raise AssertionError(f"{what}: row {r} is not ordered by (score desc, id asc)")
    return dropped, swapped
