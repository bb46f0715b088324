#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (elasticsearch_tpu_torch) on one card.

    python3 chip_smoke.py [--docs 1000000] [--seed 0] [--phases ...]

Phases, each printing one line with its seconds; any failure raises and the
script exits non-zero with no result line:

  build    nvcc builds every kernel of the package from csrc/ (sm_90a), one
           process per source, all started together.
  kernels  each kernel against its plain PyTorch twin on the card, at the
           main paths' shapes and beyond: scan_topk streamed (B=1, N=1M,
           k in {10, 25, 128}, with ties, count_positive on and off; and
           B=512, k=10 as msearch calls it) and matmul (B=64, D=384, N=1M,
           every transform); tiered_candidates (B=512 and B=37, D=896,
           N=1M, kb=64, identity, count_positive; every transform at
           N=100k, count_positive off); split_bf16 against its run on the
           host (uint16 views equal); impact_gather (Q=512, R=64, uint16
           and int8 codes, padding rows); fused_tile_candidates (Qc=512,
           N=1M on the tiered check's [896, 1M] hi/lo tier, Td=4, C1-sized
           sparse windows with duplicate (query, doc) entries, dead lanes,
           the tail tile and a tile with fewer than t live lanes). Values
           equal, ids equal on finite lanes, totals equal.
  index    the bench corpus (1M docs, 100k-term Zipf vocabulary, Poisson(40)
           lengths clipped at 4, one long field) through EsIndex.index_doc
           and refresh, uploaded to the card.
  traffic  300 queries (200 `or` matches, 50 `and`, 50 bool with a range
           filter and a must_not term) through EsIndex.search, first with
           size=10, then with from=5, size=20. The launch counts are reset
           just before and read just after: one scan_topk launch per request.
  cpu      20 of those requests again on the same pack with device="cpu":
           totals equal, scores within 1e-6 relative, ids equal up to fp-ties
           (scores within 1e-5 relative).
  msearch  the headline `_msearch` traffic (bench.py config C1): warm-up
           batches, then 4 timed batches of 4,096 queries of up to 4 terms
           through ShardSearcher.msearch("body", queries, 10), which take
           the fused arm, and 2 timed batches of the same queries at k=25
           (the from=5, size=20 page), which take the impact and tiered
           arms; per batch wall, QPS, queries per arm, first-pass exact
           share, escalation rounds and kernel launches (counts reset just
           before the timed batches and read just after:
           fused_tile_candidates >= 1 launch per fused chunk,
           impact_gather >= 1 per chunk of every sparse group,
           tiered_candidates >= 1 per chunk of every dense-only group).
           Then one EsIndex.msearch call of 512 match bodies (half with
           from=5, size=20) and 32 bool bodies with a range filter, which
           must take the per-query route; all four kernels must launch.
  msearch_check  64 queries of one batch again as bool.should of terms
           through EsIndex.search: the fused k=10 rows with totals equal,
           scores within 1e-5 relative and ids equal up to fp-ties; the
           k=25 rows with totals equal below 10,000 (else msearch's in
           [10,000, exact]), scores and ids within the impact tier's
           quantization tie class (2 * sum of boost*idf*ubf/QMAX over the
           impact-served terms + 1e-7, rtol 1e-6).
  msearch_cpu  32 of those queries (at least 4 dense-only) through
           device="cpu" on the same pack, at k=10 (the fused arm, its
           kernel's twin on the host) and at k=25: totals equal, scores
           within 1e-5 relative, ids equal up to ties within 1e-5.
  profile  100 of the requests again, then one 4,096-query msearch batch at
           k=10 and one at k=25, under torch.profiler: the device's busy
           share of the wall time, each kernel's share of device time and
           the top device ops.
  knn_index  bench.py C4's ANN corpus (1M x 384, 750 clusters, nlist 750)
           through build_ann on the card twice (the builds byte-equal) and
           AnnSearcher(..., "cosine"); then 100k documents with an
           int8_hnsw vector field and a long field through EsIndex.index_doc
           and refresh. The text index of the phases above is released
           first.
  knn_kernels  ann_gather_scan against its twin: the C4 batch (B=1024, P=2,
           D=384, kb=100, on the knn_index tiles, or synthetic L=1536 tiles
           when run alone), both tiers, every transform, kb 1 and 128; the
           `_search` shape on the knn_index EsIndex's tiles (B=1, the
           probes and kcand of KnnNode.prepare), and (B=1, P=2, L=512) and
           an L above 4,096 on synthetic tiles with pad slots, dead docs and
           exact ties. Values equal, ids equal on finite lanes, totals
           equal; times of the kernel, its twin, the gather + bmm + topk
           composition and the bound (counted on the probed tiles: each
           distinct tile once, a pad slot by its order entry alone), with
           the reference cost model's count beside it.
  knn      C4 ANN batches (1 warm-up, 4 timed int8 and 2 bf16 batches of
           1,024 queries, k=10, num_candidates=100: one ann_gather_scan
           launch each), one int8 batch under torch.profiler, recall@10 of
           64 near-data queries against the exact scan_topk matmul scan
           (>= 0.9), the same rows at nprobe = nlist equal to the exact
           scan's; C4's exact arm (TieredKnnScanner over 1M x 384 standard
           normal, 2 timed batches, flag rate); 200 kNN `_search` requests
           (50 with a range filter, which take the kb > 128 route) at size=10
           and at from=5, size=5: p50/p99, one ann_gather_scan launch per
           unfiltered request, at least one scan_topk launch per request.
  knn_check  32 of those requests at nprobe = nlist against the same
           documents indexed without index_options (the exact scan), and 16
           on the same pack with device="cpu": totals equal, scores within
           1e-6 relative, ids equal up to fp-ties.
  report   the card's name and power limit, then one line per kernel at
           its main path's shape and one JSON line with every measured
           kernel's launches on its main path, time, bound, plain twin's
           time and the library call's time.

The last line is {"ok": true, "device": {...}}. Without a CUDA card, or
without the package beside the script, it exits non-zero first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PHASES = ("build", "kernels", "index", "traffic", "cpu", "msearch", "msearch_check",
          "msearch_cpu", "profile", "knn_index", "knn_kernels", "knn", "knn_check", "report")
C1_BATCH = 4096  # queries per msearch batch (bench.py config C1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, device, warm: bool = True) -> float:
    """Mean device ms per call of fn over `iters` calls, after one warm-up
    call unless `warm` is False. On a card: CUDA events around the calls,
    queued behind a ~0.1 s spin kernel so that the host's time to issue them
    is hidden and the events time the device work back to back. Otherwise
    the host clock."""
    import torch

    if warm:
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1000 / iters


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def compare(got, want, what: str) -> float:
    """Kernel vs twin: values equal, ids equal on finite lanes, totals
    equal. -> max |value difference| over finite lanes (0.0)."""
    gv, gi, gt = [x.cpu().numpy() for x in got]
    wv, wi, wt = [x.cpu().numpy() for x in want]
    finite = np.isfinite(wv)
    if not np.array_equal(np.isfinite(gv), finite):
        raise AssertionError(f"{what}: finite lanes differ")
    err = float(np.max(np.abs(gv[finite] - wv[finite]), initial=0.0))
    if not np.array_equal(gv, wv):
        raise AssertionError(f"{what}: values differ (max abs {err})")
    if not np.array_equal(gi[finite], wi[finite]):
        raise AssertionError(f"{what}: ids differ")
    if not np.array_equal(gt, wt):
        raise AssertionError(f"{what}: totals differ {gt[:4]} vs {wt[:4]}")
    return err


def phase_kernels(device, rng, n_docs: int, state: dict) -> None:
    import torch

    from elasticsearch_tpu_torch.ops.kernels import TRANSFORMS, scan_topk, scan_topk_reference

    N = n_docs
    live = torch.from_numpy(rng.random(N) > 0.05).to(device)
    scores = torch.from_numpy(rng.normal(size=(1, N)).astype(np.float32)).to(device)
    ties = torch.from_numpy(np.round(rng.normal(size=(1, N)), 2).astype(np.float32)).to(device)
    err = 0.0
    checks = 0
    for k in (10, 25, 128):
        for cp in (False, True):
            for name, s in (("normal", scores), ("ties", ties)):
                err = max(err, compare(
                    scan_topk(None, s, live, k, count_positive=cp),
                    scan_topk_reference(None, s, live, k, aux_doc=torch.zeros(N, device=device),
                                        aux_q=torch.zeros(1, device=device), count_positive=cp),
                    f"streamed {name} k={k} count_positive={cp}"))
                checks += 1
    B, D = 64, 384
    q = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).to(device)
    mat = torch.from_numpy(rng.normal(size=(D, N)).astype(np.float32)).to(device)
    sq = (mat * mat).sum(0)
    qsq = (q * q).sum(1)
    aux = {"cosine": (1.0 / torch.sqrt(sq), 1.0 / torch.sqrt(qsq)),
           "l2_norm": (sq, qsq)}
    for i, transform in enumerate(TRANSFORMS):
        aux_doc, aux_q = aux.get(transform, (torch.zeros(N, device=device),
                                             torch.zeros(B, device=device)))
        for cp in ((False, True) if transform == "identity" else (bool(i % 2),)):
            err = max(err, compare(
                scan_topk(q, mat, live, 10, transform=transform, aux_doc=aux_doc,
                          aux_q=aux_q, count_positive=cp),
                scan_topk_reference(q, mat, live, 10, transform=transform, aux_doc=aux_doc,
                                    aux_q=aux_q, count_positive=cp),
                f"matmul {transform} count_positive={cp}"))
            checks += 1
    state["max_abs_err"] = err

    # times at the main path's shape: streamed, B=1, N docs, k=10, the
    # per-query `ok` mask, count_positive off (top_k_with_total's call)
    z1, zn = torch.zeros(1, device=device), torch.zeros(N, device=device)
    t_kernel = time_ms(lambda: scan_topk(None, scores, live, 10, count_positive=False), 200, device)
    t_plain = time_ms(lambda: scan_topk_reference(None, scores, live, 10, aux_doc=zn, aux_q=z1,
                                                  count_positive=False), 20, device)
    t_lib = time_ms(lambda: torch.topk(scores, 10, dim=1), 200, device)
    out_bytes = 10 * 8 + 4
    state["streamed"] = {
        "ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
        "bound_ms": (N * 4 + N * 1 + out_bytes) / HBM_BYTES_PER_S * 1e3,
    }
    t25 = time_ms(lambda: scan_topk(None, scores, live, 25, count_positive=False), 200, device)
    tm = time_ms(lambda: scan_topk(q, mat, live, 10), 5, device)
    tm_plain = time_ms(lambda: scan_topk_reference(q, mat, live, 10, aux_doc=zn,
                                                   aux_q=torch.zeros(B, device=device)), 1, device)
    tm_lib = time_ms(lambda: torch.topk(q @ mat, 10, dim=1), 5, device)
    f32_ops = 2 * B * D * N
    state["shapes"] = {
        "streamed_k25_ms": t25,
        "matmul_B64_D384": {"ms": tm, "plain_ms": tm_plain, "matmul_topk_ms": tm_lib,
                            "bound_ms": f32_ops / 67e12 * 1e3, "bound_by": "operations"},
    }
    log(f"kernels: {checks} checks equal, streamed k=10 {t_kernel:.4f} ms "
        f"(twin {t_plain:.3f} ms, torch.topk {t_lib:.4f} ms), k=25 {t25:.4f} ms, "
        f"matmul B={B} D={D} {tm:.3f} ms")
    del q, mat, scores, ties
    scan_topk_msearch_shape(device, n_docs, state)
    sm = state["scan_msearch"]
    log(f"kernels: scan_topk streamed B=512 k=10 equal; {sm['ms']:.3f} ms (twin "
        f"{sm['plain_ms']:.1f} ms, torch.topk {sm['library_ms']:.3f} ms, bound {sm['bound_ms']:.3f} ms)")
    phase_kernels_tiered(device, rng, n_docs, state)
    phase_kernels_fused(device, rng, state)
    phase_kernels_impact(device, rng, n_docs, state)


def scan_topk_msearch_shape(device, n_docs: int, state: dict) -> None:
    """scan_topk streamed as the batched arms call it: B=512 rows of dense
    scores, N docs, k=10, count_positive."""
    import torch

    from elasticsearch_tpu_torch.ops.kernels import scan_topk, scan_topk_reference

    B, N = 512, n_docs
    gen = torch.Generator(device=device).manual_seed(1)
    scores = torch.rand((B, N), generator=gen, device=device)
    scores.mul_(torch.rand((B, N), generator=gen, device=device) < 0.3)
    live = torch.rand(N, generator=gen, device=device) > 0.05
    zn, zb = torch.zeros(N, device=device), torch.zeros(B, device=device)
    compare(scan_topk(None, scores, live, 10),
            scan_topk_reference(None, scores, live, 10, aux_doc=zn, aux_q=zb),
            "streamed B=512 k=10 count_positive")
    state["scan_msearch"] = {
        "ms": time_ms(lambda: scan_topk(None, scores, live, 10), 5, device),
        "plain_ms": time_ms(lambda: scan_topk_reference(None, scores, live, 10, aux_doc=zn,
                                                        aux_q=zb), 2, device),
        "library_ms": time_ms(lambda: torch.topk(torch.where(live & (scores > 0), scores,
                                                             float("-inf")), 10, dim=1),
                              5, device),
        "bound_ms": (B * N * 4 + N + B * (10 * 8 + 4)) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }


def phase_kernels_tiered(device, rng, n_docs: int, state: dict) -> None:
    """tiered_candidates and split_bf16 against their twins."""
    import torch

    from elasticsearch_tpu_torch.ops.kernels import (
        TRANSFORMS, _mask_hi, split_bf16, tiered_candidates, tiered_candidates_reference)

    D, N, kb = 896, n_docs, 64
    gen = torch.Generator(device=device).manual_seed(2)
    # a BM25-shaped dense tier: ~5% of lanes hold a tf/(tf+K) in (0, 1)
    mat = torch.rand((D, N), generator=gen, device=device)
    mat.mul_(torch.rand((D, N), generator=gen, device=device) < 0.05)
    hi, lo = split_bf16(mat)
    del mat
    live = torch.rand(N, generator=gen, device=device) > 0.05
    zn = torch.zeros(N, device=device)
    checks = 0
    timing = {}
    for B in (512, 37):
        # BM25 weights: up to 4 dense terms per query, idf-sized
        q = np.zeros((B, D), np.float32)
        for r in range(B):
            q[r, rng.choice(D, int(rng.integers(1, 5)), replace=False)] = rng.uniform(0.5, 8, 1)
        q = torch.from_numpy(q).to(device)
        zb = torch.zeros(B, device=device)
        got = tiered_candidates(q, hi, lo, live, kb)
        sync(device)
        t0 = time.perf_counter()
        want = tiered_candidates_reference(q, hi, lo, live, kb, aux_doc=zn, aux_q=zb)
        sync(device)
        plain_ms = (time.perf_counter() - t0) * 1e3
        compare(got, want, f"tiered B={B} identity count_positive")
        checks += 1
        if B == 512:
            qh = _mask_hi(q).to(torch.bfloat16)
            timing = {
                "ms": time_ms(lambda: tiered_candidates(q, hi, lo, live, kb), 3, device),
                "plain_ms": plain_ms,
                "library_ms": time_ms(lambda: torch.topk(
                    (qh @ hi).float() + (qh @ lo).float(), kb, dim=1), 3, device),
                "bound_ms": max(4 * B * D * N / 989e12, 2 * D * N * 2 / HBM_BYTES_PER_S) * 1e3,
                "bound_by": "operations",
            }
        del want, got
    state["tier_hilo"] = (hi, lo, live)  # the fused check's tier
    del hi, lo
    torch.cuda.empty_cache()

    # every transform, count_positive off, on a signed matrix
    B, D, N = 16, 128, 100_000
    qn = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).to(device)
    matn = torch.from_numpy(rng.normal(size=(D, N)).astype(np.float32)).to(device)
    hi, lo = split_bf16(matn)
    hc, lc = split_bf16(matn.cpu())
    for name, a, b in (("hi", hi, hc), ("lo", lo, lc)):
        if not torch.equal(a.cpu().view(torch.int16), b.view(torch.int16)):
            raise AssertionError(f"split_bf16 {name} differs between the card and the host")
    livn = torch.from_numpy(rng.random(N) > 0.1).to(device)
    sq = (matn * matn).sum(0)
    qsq = (qn * qn).sum(1)
    aux = {"cosine": (1.0 / torch.sqrt(sq), 1.0 / torch.sqrt(qsq)), "l2_norm": (sq, qsq)}
    for transform in TRANSFORMS:
        aux_doc, aux_q = aux.get(transform, (torch.zeros(N, device=device),
                                             torch.zeros(B, device=device)))
        compare(tiered_candidates(qn, hi, lo, livn, kb, transform=transform, aux_doc=aux_doc,
                                  aux_q=aux_q, count_positive=False),
                tiered_candidates_reference(qn, hi, lo, livn, kb, transform=transform,
                                            aux_doc=aux_doc, aux_q=aux_q,
                                            count_positive=False),
                f"tiered {transform} count_positive=False")
        checks += 1
    state["tiered"] = {**timing, "max_abs_err": 0.0, "checks": checks}
    log(f"kernels: tiered_candidates {checks} checks equal, split_bf16 equal to the host's; "
        f"B=512 D=896 N={n_docs} kb={kb}: {timing['ms']:.3f} ms (twin {timing['plain_ms']:.1f} ms, "
        f"topk over bf16 cuBLAS {timing['library_ms']:.3f} ms, bound {timing['bound_ms']:.3f} ms)")


def phase_kernels_fused(device, rng, state: dict) -> None:
    """fused_tile_candidates against its twin at the C1 chunk: Qc=512, the
    [896, N] split-bf16 tier of the tiered check, up to Td=4 dense rows per
    query, 0-3 sparse terms of 100-3,900 postings per query (a dense tier
    holds the terms of df >= N/256), duplicate (query, doc) entries, the
    tail tile, and tile 3 with 3 live lanes (fewer than t)."""
    import torch

    from elasticsearch_tpu_torch.ops.fused import (
        SENTINEL, TILE_N, _key_bits, fused_tile_candidates, fused_tile_candidates_reference,
        tile_t_for)

    hi, lo, live = state.pop("tier_hilo")
    V, N = hi.shape
    Qc, Td = 512, 4
    njc = -(-N // TILE_N)
    t = tile_t_for(njc)
    _, db, _ = _key_bits(njc * TILE_N, 1, Qc)
    live = live.clone()
    live[3 * TILE_N: 4 * TILE_N] = False
    live[3 * TILE_N + torch.tensor([1, 700, 4095], device=device)] = True
    drows = np.zeros((Qc, Td), np.int32)
    dwh = np.zeros((Qc, Td), np.float32)
    qs, docs = [], []
    for q in range(Qc):
        nd = int(rng.integers(0, Td + 1))
        drows[q, :nd] = np.sort(rng.choice(V, nd, replace=False))
        dwh[q, :nd] = rng.uniform(0.5, 8, nd)
        for _ in range(int(rng.integers(0, 4))):
            df = int(rng.integers(100, 3900))
            docs.append(rng.integers(0, N, df))
            qs.append(np.full(df, q))
    dwh = (dwh.view(np.int32) & -65536).view(np.float32)  # bf16-cut, as the pipeline's
    q_all, d_all = np.concatenate(qs), np.concatenate(docs)
    dup = rng.random(q_all.shape[0]) < 0.05  # a doc in two of a query's terms
    q_all = np.concatenate([q_all, q_all[dup]])
    d_all = np.concatenate([d_all, d_all[dup]])
    keys = ((q_all << db) | d_all).astype(np.int32)
    keys = np.concatenate([keys[np.argsort(keys, kind="stable")],
                           np.full(-keys.shape[0] % 128, SENTINEL, np.int32)])
    vals = rng.uniform(0.01, 6, keys.shape[0]).astype(np.float32)
    bounds = (np.arange(Qc)[:, None] << db) | (np.arange(njc + 1) * TILE_N)[None, :]
    ptr = np.searchsorted(keys, bounds.reshape(-1)).astype(np.int32).reshape(Qc, njc + 1)
    args = (hi, lo, live, *(torch.from_numpy(a).to(device) for a in (drows, dwh, keys, vals, ptr)))
    got = fused_tile_candidates(*args, t=t, db=db)
    t0 = time.perf_counter()
    want = fused_tile_candidates_reference(*args, t=t, db=db)
    sync(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare(got[:3], want[:3], f"fused_tile_candidates Qc={Qc} N={N} t={t}")
    if not torch.equal(got[1], want[1]) or got[3].any():
        raise AssertionError("fused_tile_candidates: ids or window flags differ")
    if int(torch.isfinite(got[0].view(Qc, njc, t)[:, 3]).sum(1).max()) > 3:
        raise AssertionError("fused_tile_candidates: dead lanes among the candidates")
    del want

    # the composition the JAX package's out-of-kernel mode stands for:
    # the bf16 cuBLAS product [Wh | Wh] @ [hi; lo], the sparse entries
    # accumulated in, masks, and torch.topk of every tile row
    W = torch.zeros((Qc, V), dtype=torch.float32, device=device)
    W.scatter_add_(1, args[3].long(), args[4])
    W2 = torch.cat([W, W], dim=1).to(torch.bfloat16)
    tstack = torch.cat([hi, lo], dim=0)
    ent = int(ptr[-1, -1])
    d_keys, d_vals = args[5][:ent].long(), args[6][:ent]
    flat = (d_keys >> db) * N + (d_keys & ((1 << db) - 1))
    pad = njc * TILE_N - N

    def library():
        sc = (W2 @ tstack).float()
        sc.view(-1).index_put_((flat,), d_vals, accumulate=True)
        sc = torch.where(live & (sc > 0), sc, float("-inf"))
        sc = torch.nn.functional.pad(sc, (0, pad), value=float("-inf"))
        return torch.topk(sc.view(Qc * njc, TILE_N), t, dim=1)

    nnz = int((args[4] != 0).sum())
    rows_touched = int(torch.unique(args[3][args[4] != 0]).numel())
    out_bytes = Qc * njc * (t * 8 + 4)
    bytes_ = rows_touched * N * 4 + ent * 8 + N + out_bytes
    state["fused"] = {
        "ms": time_ms(lambda: fused_tile_candidates(*args, t=t, db=db), 3, device),
        "plain_ms": plain_ms,
        "library_ms": time_ms(library, 3, device),
        "bound_ms": max(bytes_ / HBM_BYTES_PER_S, 4 * N * nnz / 67e12) * 1e3,
        "bound_by": "bytes" if bytes_ / HBM_BYTES_PER_S >= 4 * N * nnz / 67e12 else "operations",
        "max_abs_err": err,
        "shape": f"Qc={Qc} N={N} Td={Td} ({nnz} weights, {rows_touched} rows) "
                 f"{ent} entries t={t}",
    }
    del W2, tstack, got, args, hi, lo
    torch.cuda.empty_cache()
    f = state["fused"]
    log(f"kernels: fused_tile_candidates equal to its twin at {f['shape']}: {f['ms']:.3f} ms "
        f"(twin {f['plain_ms']:.1f} ms, bf16 cuBLAS + index_put_ + topk {f['library_ms']:.3f} ms, "
        f"bound {f['bound_ms']:.3f} ms, {f['bound_by']})")


def phase_kernels_impact(device, rng, n_docs: int, state: dict) -> None:
    """impact_gather against its twin, uint16 and int8 codes."""
    import torch

    from elasticsearch_tpu_torch.ops.kernels import impact_gather, impact_gather_reference

    nb, Q, R = 200_000, 512, 64
    docids = rng.integers(0, n_docs, (nb, 128)).astype(np.int32)
    docids[0] = n_docs  # row 0: the all-padding block
    rows = rng.integers(1, nb, (Q, R)).astype(np.int32)
    pad = rng.random((Q, R)) < 0.1
    rows[pad] = 0
    w = rng.uniform(0, 1e-3, (Q, R)).astype(np.float32)
    w[pad] = 0.0
    d_docids, d_rows, d_w = (torch.from_numpy(a).to(device) for a in (docids, rows, w))
    timing = {}
    for dtype, high in ((np.uint16, 65536), (np.int8, 128)):
        codes = rng.integers(1, high, (nb, 128)).astype(dtype)
        codes[0] = 0
        d_codes = torch.from_numpy(codes).to(device)
        got = impact_gather(d_codes, d_docids, d_rows, d_w)
        want = impact_gather_reference(d_codes, d_docids, d_rows, d_w)
        for g, x, what in zip(got, want, ("ids", "scores")):
            if not torch.equal(g, x):
                raise AssertionError(f"impact_gather {np.dtype(dtype).name}: {what} differ")
        if dtype == np.uint16:
            lanes = Q * R * 128
            timing = {
                "ms": time_ms(lambda: impact_gather(d_codes, d_docids, d_rows, d_w), 200, device),
                "plain_ms": time_ms(lambda: impact_gather_reference(d_codes, d_docids, d_rows,
                                                                    d_w), 20, device),
                "library_ms": None,  # no single PyTorch call gathers and scales
                "bound_ms": (lanes * (2 + 4 + 8) + Q * R * 8) / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
            }
    state["impact"] = {**timing, "max_abs_err": 0.0}
    log(f"kernels: impact_gather uint16 and int8 equal; Q={Q} R={R} uint16: "
        f"{timing['ms']:.4f} ms (twin {timing['plain_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms)")


def phase_index(device, rng, n_docs: int, state: dict):
    import torch

    from elasticsearch_tpu_torch import EsIndex
    from elasticsearch_tpu_torch.corpus import MAPPINGS, corpus_docs, make_corpus

    t0 = time.perf_counter()
    lens, tok, nums = make_corpus(rng, n_docs)
    docs = corpus_docs(lens, tok, nums)
    t_gen = time.perf_counter() - t0
    idx = EsIndex("corpus", MAPPINGS, device=device)
    t1 = time.perf_counter()
    for i, d in enumerate(docs):
        idx.index_doc(str(i), d)
    del docs
    t2 = time.perf_counter()
    idx.refresh()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    pack = idx.searcher.pack
    dense_rows = len(pack.dense_dict)
    on_card = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    state.update(corpus=(lens, tok), index=idx)
    log(f"index: {pack.num_docs} docs, {pack.num_terms} terms, {dense_rows} dense rows "
        f"(tier {pack.dense_tfn.shape[0]} x {pack.num_docs}), {pack.nbytes()} pack bytes, "
        f"{on_card} bytes allocated on the card; generate {t_gen:.1f} s, "
        f"index_doc {t2 - t1:.1f} s, refresh {t3 - t2:.1f} s")


def phase_traffic(device, rng, state: dict) -> None:
    from elasticsearch_tpu_torch.corpus import traffic
    from elasticsearch_tpu_torch.ops import kernels

    idx = state["index"]
    lens, tok = state["corpus"]
    queries = traffic(rng, lens, tok, 200, 50, 50)
    requests = [(q, 10, 0) for q in queries] + [(q, 20, 5) for q in queries]
    for q, size, from_ in requests[:5]:  # warm-up: first loads and allocations
        idx.search(q, size=size, from_=from_)
    kernels.reset_launch_counts()
    lat = {(10, 0): [], (20, 5): []}
    results = []
    for q, size, from_ in requests:
        t0 = time.perf_counter()
        out = idx.search(q, size=size, from_=from_)  # ends in a device-to-host copy
        lat[(size, from_)].append((time.perf_counter() - t0) * 1000)
        results.append(out)
    launches = dict(kernels.launch_counts)
    if launches["scan_topk"] != len(requests):
        raise AssertionError(f"scan_topk launched {launches['scan_topk']} times for "
                             f"{len(requests)} requests")
    for (q, size, from_), out in zip(requests, results):
        hits = out["hits"]["hits"]
        scores = [h["_score"] for h in hits]
        if len(hits) > size or not all(np.isfinite(scores)) or scores != sorted(scores, reverse=True):
            raise AssertionError(f"malformed hits for {q}")
    n_hits = sum(len(o["hits"]["hits"]) for o in results)
    if n_hits == 0:
        raise AssertionError("the traffic returned no hits")
    state.update(requests=requests, results=results, launches=launches)
    parts = []
    for (size, from_), ms in lat.items():
        parts.append(f"size={size} from={from_}: p50 {np.percentile(ms, 50):.3f} ms "
                     f"p99 {np.percentile(ms, 99):.3f} ms")
    log(f"traffic: {len(requests)} requests, {n_hits} hits, scan_topk launches "
        f"{launches['scan_topk']}; " + "; ".join(parts))


def phase_cpu(state: dict) -> None:
    from elasticsearch_tpu_torch.query.executor import ShardSearcher

    idx = state["index"]
    cpu = ShardSearcher(idx.searcher.pack, device="cpu", mappings=idx.mappings)
    requests, results = state["requests"], state["results"]
    picks = list(range(0, len(requests), len(requests) // 20))[:20]
    worst = 0.0
    for i in picks:
        q, size, from_ = requests[i]
        want = cpu.search(q, size=size, from_=from_)
        got = results[i]["hits"]
        if got["total"]["value"] != want.total:
            raise AssertionError(f"total {got['total']['value']} vs cpu {want.total} for {q}")
        gs = np.array([h["_score"] for h in got["hits"]], np.float64)
        ws = want.scores.astype(np.float64)
        if gs.shape != ws.shape:
            raise AssertionError(f"hit count differs for {q}")
        rel = np.abs(gs - ws) / np.maximum(np.abs(ws), 1e-30) if len(ws) else np.zeros(0)
        worst = max(worst, float(rel.max(initial=0.0)))
        if worst > 1e-6:
            raise AssertionError(f"scores differ by {worst} relative for {q}")
        for h, d, w in zip(got["hits"], want.doc_ids, ws):
            if int(h["_id"]) != int(d) and abs(h["_score"] - w) > 1e-5 * max(abs(w), 1.0):
                raise AssertionError(f"ids differ beyond fp-ties for {q}")
    log(f"cpu: {len(picks)} requests match the device=cpu run "
        f"(max relative score difference {worst:.3g})")


def _msearch_batches(searcher, batches, k: int, need: dict) -> tuple[list, list]:
    """Time each batch through ShardSearcher.msearch at k and check its rows
    and its launches: need maps a kernel to the arm whose chunks it must
    cover. -> (per-batch outputs, per-batch rows of numbers)."""
    from elasticsearch_tpu_torch.ops import kernels

    bs = searcher.batched()
    results, rows = [], []
    for qs in batches:
        before = dict(kernels.launch_counts)
        t0 = time.perf_counter()
        out = searcher.msearch("body", qs, k)  # ends in the host copy of every row
        wall = time.perf_counter() - t0
        st = bs.last_stats
        launched = {n: kernels.launch_counts[n] - before[n] for n in before}
        for name, arm in need.items():
            n = st["chunks"].get(arm, 0)
            if n == 0 or launched[name] < n:
                raise AssertionError(f"{name} launched {launched[name]} times for {n} {arm} chunks")
        v, i, t, ex = out
        if v.shape != (len(qs), k) or np.isnan(v).any():
            raise AssertionError("malformed msearch rows")
        fin = np.isfinite(v)
        if (v[:, 1:] > v[:, :-1]).any() or (t < fin.sum(1)).any():
            raise AssertionError("msearch rows out of order or totals below the hit count")
        results.append(out)
        rows.append({"k": k, "wall_ms": wall * 1e3, "qps": len(qs) / wall, "arms": st["queries"],
                     "chunks": st["chunks"], "first_pass_exact": float(ex.mean()),
                     "rounds": st["rounds"], "escalated": st["escalated"], "launches": launched})
        log(f"msearch batch k={k}: {wall * 1e3:.1f} ms, {len(qs) / wall:.0f} QPS, arms "
            f"{st['queries']}, chunks {st['chunks']}, first-pass exact {ex.mean():.4f}, "
            f"{st['rounds']} rounds ({st['escalated']} reruns), launches {launched}")
    if sum(int(np.isfinite(r[0]).sum()) for r in results) == 0:
        raise AssertionError("msearch returned no hits")
    return results, rows


def phase_msearch(device, rng, state: dict) -> None:
    from elasticsearch_tpu_torch.corpus import sample_queries, traffic
    from elasticsearch_tpu_torch.ops import kernels

    idx = state["index"]
    lens, tok = state["corpus"]
    searcher = idx.searcher
    # warm-up batches: the split-bf16 tier copies, pinned buffers, allocations
    warm = sample_queries(rng, lens, tok, C1_BATCH)
    searcher.msearch("body", warm, 10)
    searcher.msearch("body", warm, 25)
    sync(device)
    batches = [sample_queries(rng, lens, tok, C1_BATCH) for _ in range(4)]
    kernels.reset_launch_counts()
    results, rows = _msearch_batches(searcher, batches, 10,
                                     {"fused_tile_candidates": "fused"})
    results25, rows25 = _msearch_batches(
        searcher, batches[:2], 25, {"impact_gather": "impact", "tiered_candidates": "tiered"})
    launches = dict(kernels.launch_counts)

    # EsIndex.msearch: match bodies ride the term lane, bool bodies the
    # per-query route (spied on, so the route is shown, not assumed)
    bodies = []
    for j, qs in enumerate(sample_queries(rng, lens, tok, 512)):
        body = {"query": {"match": {"body": " ".join(t for t, _ in qs)}}}
        bodies.append({**body, "from": 5, "size": 20} if j % 2 else body)
    bools = [{"query": q} for q in traffic(rng, lens, tok, 0, 0, 32)]
    per_query, batched = [0], [0]
    search, msearch = idx.search, searcher.msearch

    def spy_search(*a, **kw):
        per_query[0] += 1
        return search(*a, **kw)

    def spy_msearch(fld, queries, k=10, **kw):
        batched[0] += len(queries)
        return msearch(fld, queries, k, **kw)

    idx.search, searcher.msearch = spy_search, spy_msearch
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        resp = idx.msearch(bodies + bools)
        wall = time.perf_counter() - t0
        es_launches = dict(kernels.launch_counts)
    finally:
        del idx.search, searcher.msearch
    statuses = {r["status"] for r in resp["responses"]}
    if statuses != {200} or len(resp["responses"]) != len(bodies) + len(bools):
        raise AssertionError(f"EsIndex.msearch statuses {statuses}")
    if per_query[0] != len(bools) or batched[0] != len(bodies):
        raise AssertionError(f"routes: {per_query[0]} per-query, {batched[0]} batched")
    for name in ("fused_tile_candidates", "impact_gather", "tiered_candidates", "scan_topk"):
        if es_launches[name] == 0:
            raise AssertionError(f"EsIndex.msearch launched no {name}")
    for r, body in zip(resp["responses"], bodies):
        if len(r["hits"]["hits"]) > body.get("size", 10):
            raise AssertionError("EsIndex.msearch returned too many hits")
    state.update(msearch_batches=batches, msearch_results=results,
                 msearch_results25=results25, msearch_rows=rows + rows25,
                 msearch_launches=launches)
    parts = []
    for k, rr in ((10, rows), (25, rows25)):
        walls = [r["wall_ms"] for r in rr]
        parts.append(f"k={k}: {len(rr)} x {C1_BATCH} queries, wall p50 "
                     f"{np.percentile(walls, 50):.1f} ms, "
                     f"{len(rr) * C1_BATCH / (sum(walls) / 1e3):.0f} QPS")
    log(f"msearch: {'; '.join(parts)}; launches {launches}; "
        f"EsIndex.msearch {len(bodies)} match + {len(bools)} bool bodies in {wall * 1e3:.1f} ms: "
        f"{batched[0]} batched, {per_query[0]} per-query, launches {es_launches}")


def _disjunction(terms) -> dict:
    return {"bool": {"should": [{"term": {"body": {"value": t, "boost": b}}} for t, b in terms]}}


def phase_msearch_check(state: dict) -> None:
    """64 msearch rows against per-query `_search`: the fused k=10 rows
    exactly (up to fp-ties), the impact k=25 rows in the impact tier's
    quantization tie class."""
    from elasticsearch_tpu_torch.ops.scoring import bm25_idf

    idx = state["index"]
    pack = idx.searcher.pack
    queries = state["msearch_batches"][0][:64]

    v, ids, tt, _ = state["msearch_results"][0]
    worst, ties = 0.0, 0
    for row, terms in enumerate(queries):
        want = idx.search(_disjunction(terms), size=10)["hits"]
        if tt[row] != want["total"]["value"]:
            raise AssertionError(f"fused total {tt[row]} vs {want['total']['value']} for {terms}")
        ws = np.array([h["_score"] for h in want["hits"]])
        gs = v[row][np.isfinite(v[row])]
        if gs.shape != ws.shape:
            raise AssertionError(f"{len(gs)} fused hits vs {len(ws)} for {terms}")
        rel = np.abs(gs - ws) / np.maximum(np.abs(ws), 1e-30)
        worst = max(worst, float(rel.max(initial=0.0)))
        if worst > 1e-5:
            raise AssertionError(f"fused scores differ by {worst} relative for {terms}")
        for j, h in enumerate(want["hits"]):
            if int(h["_id"]) != int(ids[row][j]):
                ties += 1
                if abs(gs[j] - ws[j]) > 1e-5 * max(abs(ws[j]), 1.0):
                    raise AssertionError(f"fused ids differ beyond fp-ties for {terms}")
    fused_line = (f"{len(queries)} fused k=10 rows equal per-query _search (max relative "
                  f"score difference {worst:.3g}, {ties} positions swapped among fp-ties)")

    qmax = pack.impact_meta["qmax"]
    doc_count = pack.field_stats["body"]["doc_count"]
    v, ids, tt, _ = state["msearch_results25"][0]
    worst_gap, ties = 0.0, 0
    for row, terms in enumerate(queries):
        want = idx.search(_disjunction(terms), size=25)["hits"]
        exact_total = want["total"]["value"]
        if exact_total < 10_000:
            if tt[row] != exact_total:
                raise AssertionError(f"total {tt[row]} vs {exact_total} for {terms}")
        elif not 10_000 <= tt[row] <= exact_total:
            raise AssertionError(f"total {tt[row]} outside [10000, {exact_total}] for {terms}")
        bound = 0.0
        for t, boost in terms:
            s0, nb, df = pack.term_blocks("body", t)
            if df > 0 and pack.dense_row_of("body", t) is None:
                ubf = float(pack.impact_ubf[pack.term_dict[("body", t)]])
                bound += boost * bm25_idf(doc_count, df) * ubf / qmax
        tol = 2 * bound + 1e-7
        ws = np.array([h["_score"] for h in want["hits"]])
        gs = v[row][np.isfinite(v[row])]
        if gs.shape != ws.shape:
            raise AssertionError(f"{len(gs)} hits vs {len(ws)} for {terms}")
        gap = np.abs(gs - ws)
        if (gap > tol + 1e-6 * np.abs(ws)).any():
            raise AssertionError(f"scores differ by {gap.max()} (bound {tol}) for {terms}")
        worst_gap = max(worst_gap, float(gap.max(initial=0.0)))
        for j, h in enumerate(want["hits"]):
            if int(h["_id"]) != int(ids[row][j]):
                ties += 1
                if gap[j] > tol:
                    raise AssertionError(f"ids differ beyond the tie class for {terms}")
    log(f"msearch_check: {fused_line}; {len(queries)} impact k=25 rows match within the tie "
        f"class (max score gap {worst_gap:.3g}, {ties} positions swapped within it)")


def phase_msearch_cpu(state: dict) -> None:
    """msearch rows of the card against the same queries on the host, at
    k=10 (fused arm) and k=25 (impact and tiered arms)."""
    from elasticsearch_tpu_torch.query.executor import ShardSearcher

    idx = state["index"]
    pack = idx.searcher.pack
    queries = state["msearch_batches"][0]
    dense_only = [i for i, q in enumerate(queries)
                  if q and all(pack.dense_row_of("body", t) is not None for t, _ in q)]
    picks = dense_only[:4] + [i for i in range(len(queries)) if i not in dense_only[:4]][:28]
    if len(dense_only) < 4:
        raise AssertionError(f"only {len(dense_only)} dense-only queries in the batch")
    t0 = time.perf_counter()
    cpu = ShardSearcher(pack, device="cpu", mappings=idx.mappings)
    worst = 0.0
    arms = {}
    for k, results in ((10, state["msearch_results"]), (25, state["msearch_results25"])):
        v, ids, tt, _ = results[0]
        cv, ci, ct, _ = cpu.msearch("body", [queries[i] for i in picks], k)
        arms[k] = sorted(cpu.batched().last_stats["queries"])
        for j, i in enumerate(picks):
            if ct[j] != tt[i]:
                raise AssertionError(f"k={k}: total {tt[i]} vs cpu {ct[j]} for {queries[i]}")
            fin = np.isfinite(cv[j])
            if not np.array_equal(fin, np.isfinite(v[i])):
                raise AssertionError(f"k={k}: hit count differs for {queries[i]}")
            rel = np.abs(v[i][fin] - cv[j][fin]) / np.maximum(np.abs(cv[j][fin]), 1e-30)
            worst = max(worst, float(rel.max(initial=0.0)))
            if worst > 1e-5:
                raise AssertionError(f"k={k}: scores differ by {worst} relative for {queries[i]}")
            for a, b, sa, sb in zip(ids[i][fin], ci[j][fin], v[i][fin], cv[j][fin]):
                if a != b and abs(sa - sb) > 1e-5 * max(abs(sb), 1.0):
                    raise AssertionError(f"k={k}: ids differ beyond fp-ties for {queries[i]}")
    if arms[10] != ["fused"]:
        raise AssertionError(f"the host run took arms {arms[10]} at k=10")
    log(f"msearch_cpu: {len(picks)} rows ({len(dense_only[:4])} dense-only) at k=10 (arms "
        f"{arms[10]}) and k=25 (arms {arms[25]}) match the device=cpu run (max relative score "
        f"difference {worst:.3g}) in {time.perf_counter() - t0:.1f} s")


KNN_BATCH = 1024  # queries per C4 batch (bench.py config C4)
KNN_K, KNN_NC = 10, 100  # C4's k and num_candidates
KNN_VECTORS = 1_000_000  # C4's ANN corpus
KNN_DOCS = 100_000  # documents of the kNN EsIndex


def _synthetic_ann(gen, device, C: int, L: int, D: int, n_docs: int):
    """ANN tiles of random content on the card: about 1/8 pad slots at the
    tile ends, and in every tile the rows of slots 1-4 copied onto slots
    5-8 (the same codes, halves, norms and scale/offset: exactly tied
    scores under distinct docids)."""
    import torch

    from elasticsearch_tpu_torch.ops.kernels import split_bf16

    vals = torch.randn((C, L, D), generator=gen, device=device)
    vals[:, 5:9] = vals[:, 1:5]
    hi, lo = split_bf16(vals)
    codes = torch.randint(-127, 128, (C, L, D), generator=gen, device=device).to(torch.int8)
    codes[:, 5:9] = codes[:, 1:5]
    scale = torch.rand((C, L), generator=gen, device=device) * 0.05
    offset = torch.randn((C, L), generator=gen, device=device) * 0.1
    sq = (vals * vals).sum(-1)
    for t in (scale, offset, sq):
        t[:, 5:9] = t[:, 1:5]
    order = torch.randperm(C * L, generator=gen, device=device).remainder(n_docs).to(torch.int32)
    order = order.view(C, L)
    fill = torch.randint(L - L // 4, L + 1, (C, 1), generator=gen, device=device)
    order = torch.where(torch.arange(L, device=device)[None, :] < fill, order,
                        torch.full_like(order, -1))
    cents = torch.randn((C, D), generator=gen, device=device)
    return {"centroids": cents, "order": order.contiguous(), "codes": codes, "scale": scale,
            "offset": offset, "hi": hi, "lo": lo, "sq": sq}


def _ann_library(q, probes, dev, live_slots, kb: int, similarity: str):
    """The PyTorch composition of the scan (no single call computes it), in
    query steps that keep the gathered f32 tiles under 2 GB: the tiles
    indexed by probes, a batched f32 product, the transform and masks,
    torch.topk."""
    import torch

    from elasticsearch_tpu_torch.ann.kernels import query_aux, slot_aux
    from elasticsearch_tpu_torch.ops.kernels import _apply_transform

    B, P = probes.shape
    C, L, D = dev["codes"].shape
    auxd, auxq = slot_aux(dev["sq"], similarity), query_aux(q, similarity)
    step = max(1, (2 << 30) // (P * L * D * 4))
    out = []
    for s in range(0, B, step):
        pl, qc = probes[s: s + step].long(), q[s: s + step]
        b = pl.shape[0]
        dots = torch.bmm(dev["codes"][pl].flatten(1, 2).float(), qc[:, :, None])[:, :, 0]
        dots = (dev["scale"][pl].reshape(b, -1) * dots
                + dev["offset"][pl].reshape(b, -1) * qc.sum(1, keepdim=True))
        sc = _apply_transform(dots, similarity, auxd[pl].reshape(b, -1), auxq[s: s + step, None])
        ok = (dev["order"][pl] >= 0).reshape(b, -1) & (live_slots[pl].reshape(b, -1) != 0)
        out.append(torch.topk(torch.where(ok, sc, float("-inf")), kb, dim=1))
    return out


def _ann_bounds(dev, probes, kb: int) -> dict:
    """The least work of one ann_gather_scan over `probes`, counted on this
    run's tiles: each distinct probed tile read once, a pad slot (order < 0)
    by its 4-byte order entry alone, a real slot by its codes (int8: D
    bytes; bf16: hi and lo, 4D), its order, norm (and int8: scale, offset)
    at 4 bytes each and its live byte; the queries (4D + 8 bytes each) and
    probes read, the outputs written. Operations: 2D per real slot of each
    (query, probe) for int8, 4D for bf16 (two products), at the card's f32
    rate. -> {"int8"|"bf16": (bound_ms, bound_by)}, the reference cost
    model's bound ("costmodel": slots (D+8) + 12 slots + 4BD bytes with
    slots = B P L, pads and repeated tiles included) and the real share of
    the probed slots."""
    import torch

    B, P = probes.shape
    C, L, D = dev["codes"].shape
    real = (dev["order"] >= 0).sum(1)
    tiles = torch.unique(probes.long())
    n_real = int(real[tiles].sum())
    n_pad = tiles.numel() * L - n_real
    pair_real = int(real[probes.long()].sum())
    io = B * (4 * D + 8) + 4 * B * P + B * (8 * kb + 4)
    out = {}
    for tier, per_slot, ops_per_dim in (("int8", D + 17, 2), ("bf16", 4 * D + 9, 4)):
        bytes_ms = (n_real * per_slot + 4 * n_pad + io) / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_per_dim * D * pair_real / 67e12 * 1e3
        out[tier] = (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations")
    slots = B * P * L
    out["costmodel"] = {"int8": (slots * (D + 8) + 12 * slots + 4 * B * D) / HBM_BYTES_PER_S * 1e3,
                        "bf16": (4 * D * slots + 12 * slots + 4 * B * D) / HBM_BYTES_PER_S * 1e3}
    out["real_share"] = pair_real / slots
    out["distinct_tiles"] = tiles.numel()
    return out


def phase_knn_kernels(device, rng, state: dict) -> None:
    """ann_gather_scan against its twin: the C4 batch (B=1024, P=2, D=384,
    kb=100, on the knn_index build's tiles, or synthetic tiles of L=1536
    when run alone) for both tiers and every transform, with kb = 1 and 128
    too; the `_search` shape on the knn_index EsIndex's own tiles (B=1, the
    probes and kcand of KnnNode.prepare, 8 requests); the `_search` shape
    on synthetic tiles (B=1, P=2, L=512, kb=100) and an L above 4,096, with
    pad slots, dead docs and exactly tied scores."""
    import torch

    from elasticsearch_tpu_torch.ann.kernels import (
        ann_gather_scan, ann_gather_scan_reference, centroid_topk, slot_live)
    from elasticsearch_tpu_torch.ops.kernels import TRANSFORMS
    from elasticsearch_tpu_torch.query.dsl import parse_knn

    gen = torch.Generator(device=device).manual_seed(4)
    B, P, D, kb = KNN_BATCH, 2, 384, KNN_NC
    searcher = state.get("ann_searcher")
    if searcher is not None:
        dev, live_slots = searcher.dev, searcher._slot_live()
        q = torch.randn((B, D), generator=gen, device=device)
        probes = centroid_topk(dev["centroids"], q, nprobe=P)
        c4_src = f"the knn_index build, C={dev['order'].shape[0]}"
    else:
        dev = _synthetic_ann(gen, device, 750, 1536, D, 1_000_000)
        live_slots = (torch.rand(dev["order"].shape, generator=gen, device=device) > 0.05
                      ).to(torch.uint8)
        q = torch.randn((B, D), generator=gen, device=device)
        probes = torch.randint(0, 750, (B, P), generator=gen, device=device).to(torch.int32)
        c4_src = "synthetic tiles, C=750"
    L = dev["order"].shape[1]
    err, checks = 0.0, 0

    def check(qq, pp, d, ls, k, tier, sim, what):
        nonlocal err, checks
        err = max(err, compare(ann_gather_scan(qq, pp, d, ls, k, tier=tier, similarity=sim),
                               ann_gather_scan_reference(qq, pp, d, ls, k, tier=tier,
                                                         similarity=sim), what))
        checks += 1

    for tier in ("int8", "bf16"):
        for sim in TRANSFORMS:
            check(q, probes, dev, live_slots, kb, tier, sim, f"C4 {tier} {sim}")
        for k in (1, 128):
            check(q, probes, dev, live_slots, k, tier, "cosine", f"C4 {tier} kb={k}")
    for C_, L_, B_, P_, what in ((316, 512, 1, 2, "_search"), (6, 4096 + 640, 16, 3, "L>4096")):
        d = _synthetic_ann(gen, device, C_, L_, D, 100_000)
        ls = (torch.rand((C_, L_), generator=gen, device=device) > 0.1).to(torch.uint8)
        qq = torch.randn((B_, D), generator=gen, device=device)
        pp = torch.stack([torch.randperm(C_, generator=gen, device=device)[:P_]
                          for _ in range(B_)]).to(torch.int32)
        for tier in ("int8", "bf16"):
            for sim in TRANSFORMS:
                for k in (1, 100, 128):
                    check(qq, pp, d, ls, k, tier, sim, f"{what} {tier} {sim} kb={k}")
        if what == "_search":
            search_ms = time_ms(lambda: ann_gather_scan(qq, pp, d, ls, kb), 200, device)
            search_shape = f"B=1 P=2 L=512 kb={kb} int8 cosine (synthetic tiles)"
        del d
    idx = state.get("knn_index")
    if idx is not None:  # the tiles and probes that `_search` scans
        ann_dev = idx.searcher.dev["vec_ann"]["vec"]
        ls = slot_live(ann_dev["order"], idx.searcher.dev["live"])
        for qv in state["knn_index_near"][:8]:
            node = parse_knn(_knn_body(qv), idx.mappings)
            qv32 = node.prepare(idx.searcher.pack)[0]
            nprobe, kcand, itier = node._ann
            qq = torch.from_numpy(qv32)[None].to(device)
            pp = centroid_topk(ann_dev["centroids"], qq, nprobe=nprobe)
            for tier in ("int8", "bf16"):
                for sim in TRANSFORMS:
                    check(qq, pp, ann_dev, ls, kcand, tier, sim, f"knn_index {tier} {sim}")
        search_ms = time_ms(lambda: ann_gather_scan(qq, pp, ann_dev, ls, kcand, tier=itier), 200,
                            device)
        search_shape = (f"B=1 P={nprobe} L={ann_dev['order'].shape[1]} kb={kcand} {itier} "
                        f"cosine (the knn_index EsIndex's tiles)")
    t_int8 = time_ms(lambda: ann_gather_scan(q, probes, dev, live_slots, kb), 20, device)
    t_bf16 = time_ms(lambda: ann_gather_scan(q, probes, dev, live_slots, kb, tier="bf16"), 10,
                     device)
    t_plain = time_ms(lambda: ann_gather_scan_reference(q, probes, dev, live_slots, kb), 2, device)
    t_lib = time_ms(lambda: _ann_library(q, probes, dev, live_slots, kb, "cosine"), 5, device)
    bounds = _ann_bounds(dev, probes, kb)
    state["ann"] = {
        "ms": t_int8, "plain_ms": t_plain, "library_ms": t_lib,
        "bound_ms": bounds["int8"][0], "bound_by": bounds["int8"][1],
        "costmodel_bound_ms": bounds["costmodel"]["int8"],
        "max_abs_err": err,
        "shape": f"B={B} P={P} L={L} D={D} kb={kb} int8 cosine ({c4_src})",
        "real_slot_share": bounds["real_share"], "distinct_tiles": bounds["distinct_tiles"],
        "bf16_ms": t_bf16, "bf16_bound_ms": bounds["bf16"][0],
        "bf16_costmodel_bound_ms": bounds["costmodel"]["bf16"],
        "search_shape": search_shape, "search_shape_ms": search_ms,
    }
    if searcher is None:
        del dev
    sync(device)
    a = state["ann"]
    log(f"knn_kernels: ann_gather_scan {checks} checks equal to its twin; {a['shape']}: "
        f"{a['ms']:.4f} ms (twin {a['plain_ms']:.1f} ms, gather + bmm + topk {a['library_ms']:.3f} ms, "
        f"bound {a['bound_ms']:.4f} ms, {a['bound_by']}, over {a['distinct_tiles']} distinct tiles "
        f"with {100 * a['real_slot_share']:.1f}% of the probed slots real; the cost model's count "
        f"{a['costmodel_bound_ms']:.4f} ms); bf16 {t_bf16:.4f} ms (bound {a['bf16_bound_ms']:.4f} ms, "
        f"cost model {a['bf16_costmodel_bound_ms']:.4f} ms); {search_shape}: {search_ms:.4f} ms")


def _on_card(device) -> int:
    import torch

    return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0


def phase_knn_index(device, rng, n_vec: int, n_docs: int, state: dict) -> None:
    """(a) bench.py C4's ANN corpus (n_vec x 384 clustered, nlist =
    0.75 sqrt(n)) through build_ann (k-means and tile packing on the card)
    twice, the builds byte-equal, and AnnSearcher(..., "cosine"); (b) n_docs
    documents through EsIndex.index_doc / refresh with an int8_hnsw vector
    field and a long field. The 1M-vector corpus does not go through
    index_doc: each document keeps a JSON snapshot and a parsed copy of 384
    Python floats (~25 KB), so 1M documents would need ~25 GB of host RAM."""
    import gc

    import torch

    from elasticsearch_tpu_torch import EsIndex
    from elasticsearch_tpu_torch.ann import AnnSearcher, build_ann
    from elasticsearch_tpu_torch.corpus import N_MAX, vector_corpus

    state.pop("index", None)  # the text phases are done: release their pack
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    D = 384
    nlist = max(16, int(n_vec ** 0.5 * 0.75))
    t0 = time.perf_counter()
    vecs, near = vector_corpus(rng, n_vec, D, nlist, 64)
    t_gen = time.perf_counter() - t0
    times = [{}, {}]
    ann = build_ann(vecs, np.ones(n_vec, bool), nlist, device=device, timings=times[0])
    again = build_ann(vecs, np.ones(n_vec, bool), nlist, device=device, timings=times[1])
    for key in ("centroids", "order", "codes", "scale", "offset", "tile", "nlist"):
        a, b = ann[key], again[key]
        if not (np.array_equal(a, b) and np.asarray(a).tobytes() == np.asarray(b).tobytes()):
            raise AssertionError(f"two builds of the same corpus differ in [{key}]")
    del again
    before = _on_card(device)
    t1 = time.perf_counter()
    searcher = AnnSearcher(ann, vecs, (vecs * vecs).sum(1), "cosine", device=device)
    sync(device)
    t_up = time.perf_counter() - t1
    state.update(ann_searcher=searcher, ann_host=ann, knn_vecs=vecs, knn_near=near)
    state["knn_build"] = {"kmeans_s": [t["kmeans_s"] for t in times],
                          "tiles_s": [t["tiles_s"] for t in times], "upload_s": t_up,
                          "L": ann["tile"], "nlist": ann["nlist"],
                          "bytes_on_card": _on_card(device) - before}
    kb_ = state["knn_build"]
    log(f"knn_index: {n_vec} x {D} clustered, nlist {ann['nlist']}, L {ann['tile']}; generate "
        f"{t_gen:.1f} s; k-means {kb_['kmeans_s'][0]:.2f} / {kb_['kmeans_s'][1]:.2f} s, tiles "
        f"{kb_['tiles_s'][0]:.2f} / {kb_['tiles_s'][1]:.2f} s (two builds, byte-equal); upload "
        f"{t_up:.2f} s, {kb_['bytes_on_card']} bytes on the card")

    ncl = max(16, int(n_docs ** 0.5 * 0.75))
    dvecs, dnear = vector_corpus(rng, n_docs, D, ncl, 200)
    nums = rng.integers(0, N_MAX, size=n_docs)
    mapping = {"properties": {
        "vec": {"type": "dense_vector", "dims": D, "similarity": "cosine",
                "index_options": {"type": "int8_hnsw"}},
        "n": {"type": "long"}}}
    idx = EsIndex("vectors", mapping, device=device)
    t2 = time.perf_counter()
    rows = dvecs.tolist()
    for i in range(n_docs):
        idx.index_doc(str(i), {"vec": rows[i], "n": int(nums[i])})
    del rows
    t3 = time.perf_counter()
    idx.refresh()
    sync(device)
    t4 = time.perf_counter()
    vc = idx.searcher.pack.vectors["vec"]
    if vc.ann is None:
        raise AssertionError("the int8_hnsw field built no ANN index")
    state.update(knn_index=idx, knn_index_near=dnear, knn_index_mapping=mapping)
    state["knn_build"].update(index_doc_s=t3 - t2, refresh_s=t4 - t3,
                              index_nlist=vc.ann["nlist"], index_L=vc.ann["tile"])
    log(f"knn_index: {n_docs} docs through EsIndex ({ncl} generator clusters): index_doc "
        f"{t3 - t2:.1f} s, refresh {t4 - t3:.1f} s (nlist {vc.ann['nlist']}, L {vc.ann['tile']}), "
        f"{idx.searcher.pack.nbytes()} pack bytes")


def _knn_body(q, filt=None, **extra) -> dict:
    body = {"field": "vec", "query_vector": [float(x) for x in q], "k": KNN_K,
            "num_candidates": KNN_NC, **extra}
    if filt is not None:
        body["filter"] = filt
    return body


def phase_knn(device, rng, state: dict) -> None:
    """C4 ANN batches (int8 and bf16) with recall@10 and the full-probe
    exactness check, C4's exact arm (TieredKnnScanner), and 200 kNN
    `_search` requests on the EsIndex, each path between resets of the
    launch counts."""
    import gc

    import torch

    from elasticsearch_tpu_torch.ops import kernels
    from elasticsearch_tpu_torch.ops.vector import TieredKnnScanner

    searcher = state["ann_searcher"]
    vecs = state["knn_vecs"]
    n, D = vecs.shape
    searcher.search(rng.standard_normal((KNN_BATCH, D)).astype(np.float32), KNN_K,
                    num_candidates=KNN_NC)  # warm-up
    sync(device)
    rows = {}
    kernels.reset_launch_counts()
    for tier, nb in (("int8", 4), ("bf16", 2)):
        walls = []
        for _ in range(nb):
            q = rng.standard_normal((KNN_BATCH, D)).astype(np.float32)
            before = kernels.launch_counts["ann_gather_scan"]
            t0 = time.perf_counter()
            v, i, t = searcher.search(q, KNN_K, num_candidates=KNN_NC, tier=tier)
            walls.append((time.perf_counter() - t0) * 1e3)
            if kernels.launch_counts["ann_gather_scan"] - before != 1:
                raise AssertionError("ann_gather_scan did not launch once per C4 batch")
            if v.shape != (KNN_BATCH, KNN_K) or not np.isfinite(v).all():
                raise AssertionError("malformed C4 ANN rows")
        rows[tier] = walls
    batch_launches = dict(kernels.launch_counts)

    def profiled_batch():
        searcher.search(q, KNN_K, num_candidates=KNN_NC)
        sync(device)

    prof = None
    if device.type == "cuda":
        wall_us, ops = _profiled(profiled_batch)
        busy_us = sum(us for _, us in ops)
        prof = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
                "ann_gather_scan_ms": _kernel_us(ops)["ann_gather_scan"] / 1e3,
                "top_ops": [(k[:80], us / 1e3) for k, us in ops[:6]]}

    # recall@10 of near-data queries against the exact scan_topk matmul scan
    near = state["knn_near"]
    qn = torch.from_numpy(near).to(device)
    mat_t = searcher.vectors.T.contiguous()
    aux_doc = 1.0 / torch.clamp(torch.sqrt(searcher.sq_norms), min=1e-30)
    aux_q = 1.0 / torch.clamp(torch.sqrt((qn * qn).sum(1)), min=1e-30)
    ev, ei, _ = kernels.scan_topk(qn, mat_t, searcher.live, KNN_K, transform="cosine",
                                  aux_doc=aux_doc, aux_q=aux_q, count_positive=False)
    ev, ei = ev.cpu().numpy(), ei.cpu().numpy()
    del mat_t
    recall = {}
    for tier in ("int8", "bf16"):
        _, ai, _ = searcher.search(near, KNN_K, num_candidates=KNN_NC, tier=tier)
        recall[tier] = float(np.mean([len(set(ai[b]) & set(ei[b])) / KNN_K
                                      for b in range(len(near))]))
    if recall["int8"] < 0.9:
        raise AssertionError(f"recall@10 {recall['int8']} below 0.9")
    fv, fi, _ = searcher.search(near, KNN_K, num_candidates=KNN_NC, nprobe=searcher.nlist)
    swapped = _rows_match(fv, fi, ev, ei, "nprobe = nlist vs the exact scan")
    del qn

    # C4's default exact arm: TieredKnnScanner on a standard-normal corpus
    corpus = rng.standard_normal((n, D)).astype(np.float32)
    scanner = TieredKnnScanner(corpus, (corpus * corpus).sum(1), "cosine", device=device)
    del corpus
    scanner.search(rng.standard_normal((KNN_BATCH, D)).astype(np.float32), KNN_K)
    sync(device)
    kernels.reset_launch_counts()
    exact_walls, flags = [], []
    for _ in range(2):
        q = rng.standard_normal((KNN_BATCH, D)).astype(np.float32)
        t0 = time.perf_counter()
        v, i, t, first = scanner.search(q, KNN_K)
        exact_walls.append((time.perf_counter() - t0) * 1e3)
        flags.append(float(1.0 - first.mean()))
        if not np.isfinite(v).all():
            raise AssertionError("malformed exact-arm rows")
    exact_launches = dict(kernels.launch_counts)
    if exact_launches["tiered_candidates"] != 2:
        raise AssertionError(f"tiered_candidates launched {exact_launches['tiered_candidates']} times")
    del scanner
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # 200 kNN `_search` requests, 50 with a range filter (kcand 400: kb > 128)
    idx = state["knn_index"]
    qs = state["knn_index_near"]
    bodies = []
    for j, q in enumerate(qs[:200]):
        lo = int(rng.integers(0, 600_000))
        filt = {"range": {"n": {"gte": lo, "lt": lo + 400_000}}} if j % 4 == 3 else None
        bodies.append(_knn_body(q, filt))
    requests = [(b, 10, 0) for b in bodies] + [(b, 5, 5) for b in bodies]
    for b, size, from_ in requests[:5]:
        idx.search(knn=b, size=size, from_=from_)
    kernels.reset_launch_counts()
    lat = {(10, 0): [], (5, 5): []}
    results = []
    for b, size, from_ in requests:
        t0 = time.perf_counter()
        out = idx.search(knn=b, size=size, from_=from_)
        lat[(size, from_)].append((time.perf_counter() - t0) * 1e3)
        results.append(out)
    search_launches = dict(kernels.launch_counts)
    unfiltered = sum(1 for b, _, _ in requests if "filter" not in b)
    if search_launches["ann_gather_scan"] != unfiltered:
        raise AssertionError(f"ann_gather_scan launched {search_launches['ann_gather_scan']} "
                             f"times for {unfiltered} unfiltered requests")
    if search_launches["scan_topk"] < len(requests):
        raise AssertionError(f"scan_topk launched {search_launches['scan_topk']} times for "
                             f"{len(requests)} requests")
    for (b, size, from_), out in zip(requests, results):
        hits = out["hits"]["hits"]
        sc = [h["_score"] for h in hits]
        if (len(hits) != min(size, KNN_K - from_) or sc != sorted(sc, reverse=True)
                or out["hits"]["total"]["value"] != KNN_K):
            raise AssertionError(f"malformed kNN hits for request {b.get('filter')}")
    state.update(knn_requests=requests, knn_results=results)
    state["knn"] = {
        "c4_ann_walls_ms": rows, "c4_ann_qps": {t: len(w) * KNN_BATCH / (sum(w) / 1e3)
                                                for t, w in rows.items()},
        "c4_launches": batch_launches, "recall_at_10": recall, "profile": prof,
        "nprobe_all_swapped": swapped,
        "exact_walls_ms": exact_walls, "exact_qps": 2 * KNN_BATCH / (sum(exact_walls) / 1e3),
        "exact_flag_rate": flags, "exact_launches": exact_launches,
        "search_p50_ms": {f"size={s} from={f}": float(np.percentile(v, 50))
                          for (s, f), v in lat.items()},
        "search_p99_ms": {f"size={s} from={f}": float(np.percentile(v, 99))
                          for (s, f), v in lat.items()},
        "search_launches": search_launches,
    }
    k = state["knn"]
    log(f"knn: C4 ANN batches of {KNN_BATCH}: int8 " + ", ".join(f"{w:.1f}" for w in rows["int8"])
        + f" ms ({k['c4_ann_qps']['int8']:.0f} QPS), bf16 "
        + ", ".join(f"{w:.1f}" for w in rows["bf16"]) + f" ms ({k['c4_ann_qps']['bf16']:.0f} QPS); "
        f"launches {batch_launches['ann_gather_scan']} for 6 batches; recall@10 int8 "
        f"{recall['int8']:.4f} bf16 {recall['bf16']:.4f}; nprobe = nlist rows equal the exact "
        f"scan's ({swapped} positions swapped among fp-ties)")
    if prof is not None:
        log(f"knn: one profiled int8 C4 batch: wall {prof['wall_ms']:.2f} ms, device busy "
            f"{prof['device_busy_ms']:.2f} ms ({100 * prof['device_busy_ms'] / prof['wall_ms']:.1f}%), "
            f"ann_gather_scan {prof['ann_gather_scan_ms']:.3f} ms; top ops {prof['top_ops']}")
    log(f"knn: C4 exact arm (TieredKnnScanner, {n} x {D} standard normal): "
        + ", ".join(f"{w:.1f}" for w in exact_walls) + f" ms ({k['exact_qps']:.0f} QPS), flag rate "
        f"{flags}, launches {exact_launches}")
    log(f"knn: {len(requests)} _search requests ({unfiltered} unfiltered): "
        + "; ".join(f"{key}: p50 {k['search_p50_ms'][key]:.3f} ms p99 {k['search_p99_ms'][key]:.3f} ms"
                    for key in k["search_p50_ms"]) + f"; launches {search_launches}")


def _rows_match(gv, gi, wv, wi, what: str) -> int:
    """Scores within 1e-6 relative; where ids differ, the two scores agree
    within 1e-5 relative (the repo's fp-tie contract). -> positions swapped."""
    fin = np.isfinite(wv)
    if not np.array_equal(np.isfinite(gv), fin):
        raise AssertionError(f"{what}: hit counts differ")
    rel = np.abs(gv[fin] - wv[fin]) / np.maximum(np.abs(wv[fin]), 1e-30)
    if rel.max(initial=0.0) > 1e-6:
        raise AssertionError(f"{what}: scores differ by {rel.max()} relative")
    swapped = 0
    for a, b, sa, sb in zip(gi[fin], wi[fin], gv[fin], wv[fin]):
        if a != b:
            swapped += 1
            if abs(sa - sb) > 1e-5 * max(abs(sb), 1.0):
                raise AssertionError(f"{what}: ids differ beyond fp-ties")
    return swapped


def _hits_arrays(out: dict):
    hits = out["hits"]["hits"]
    return (np.array([h["_score"] for h in hits], np.float64),
            np.array([int(h["_id"]) for h in hits]), out["hits"]["total"]["value"])


def phase_knn_check(device, state: dict) -> None:
    """32 kNN requests with nprobe = nlist against an index of the same
    documents without index_options (the exact scan), and 16 on the same
    pack searched with device="cpu" (the kernel's twin on the host)."""
    from elasticsearch_tpu_torch import EsIndex
    from elasticsearch_tpu_torch.query.executor import ShardSearcher

    idx = state["knn_index"]
    nlist = idx.searcher.pack.vectors["vec"].ann["nlist"]
    mapping = {"properties": {"vec": {k: v for k, v in
                                      state["knn_index_mapping"]["properties"]["vec"].items()
                                      if k != "index_options"}, "n": {"type": "long"}}}
    exact = EsIndex("vectors-exact", mapping, device=device)
    exact._docs = dict(idx._docs)  # the same parsed documents, packed without the ANN index
    t0 = time.perf_counter()
    exact.refresh()
    if exact.searcher.pack.vectors["vec"].ann is not None:
        raise AssertionError("the exact index built an ANN index")
    requests = state["knn_requests"]
    picks = requests[:: max(1, len(requests) // 32)][:32]
    swapped = 0
    for b, size, from_ in picks:
        full = {**b, "nprobe": nlist}
        gs, gi, gt = _hits_arrays(idx.search(knn=full, size=size, from_=from_))
        ws, wi, wt = _hits_arrays(exact.search(knn=b, size=size, from_=from_))
        if gt != wt:
            raise AssertionError(f"total {gt} vs exact {wt}")
        swapped += _rows_match(gs[None], gi[None], ws[None], wi[None], "nprobe = nlist _search")
    del exact
    cpu = EsIndex("vectors-cpu", state["knn_index_mapping"], device="cpu")
    cpu._searcher = ShardSearcher(idx.searcher.pack, device="cpu", mappings=idx.mappings)
    cpu._hits_src = idx._hits_src
    results = state["knn_results"]
    worst = 0.0
    for j in range(0, len(requests), len(requests) // 16)[:16]:
        b, size, from_ = requests[j]
        gs, gi, gt = _hits_arrays(results[j])
        ws, wi, wt = _hits_arrays(cpu.search(knn=b, size=size, from_=from_))
        if gt != wt:
            raise AssertionError(f"total {gt} vs the cpu run's {wt}")
        _rows_match(gs[None], gi[None], ws[None], wi[None], "device=cpu _search")
        if len(ws):
            worst = max(worst, float((np.abs(gs - ws) / np.abs(ws)).max()))
    log(f"knn_check: 32 requests at nprobe = nlist equal the exact index's ({swapped} positions "
        f"swapped among fp-ties); 16 requests match the device=cpu run (max relative score "
        f"difference {worst:.3g}) in {time.perf_counter() - t0:.1f} s")


KERNEL_OPS = {  # the __global__ functions each kernel's launches run
    "scan_topk": ("scan_streamed_kernel", "scan_matmul_kernel", "scan_merge_kernel"),
    "tiered_candidates": ("tiered_scan_kernel", "tiered_merge_kernel"),
    "impact_gather": ("impact_gather_kernel",),
    "fused_tile_candidates": ("fused_tile_kernel",),
    "ann_gather_scan": ("ann_scan_kernel", "ann_merge_kernel"),
}


def _profiled(fn) -> tuple[float, list]:
    """Run fn under torch.profiler -> (wall us, [(device op, self device us)])."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    ops = [(e.key, e.self_device_time_total) for e in prof.key_averages()
           if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    if not ops:
        raise AssertionError("the profiler recorded no device time")
    return wall_us, sorted(ops, key=lambda o: -o[1])


def _kernel_us(ops) -> dict:
    return {name: sum(us for key, us in ops if any(f"::{f}(" in key or f"::{f}<" in key
                                                  for f in fns))
            for name, fns in KERNEL_OPS.items()}


def phase_profile(state: dict) -> None:
    import torch

    idx = state["index"]
    sample = state["requests"][:: max(1, len(state["requests"]) // 100)][:100]

    def searches():
        for q, size, from_ in sample:
            idx.search(q, size=size, from_=from_)

    wall_us, ops = _profiled(searches)
    busy_us = sum(us for _, us in ops)
    scan_us = _kernel_us(ops)["scan_topk"]
    state["profile"] = {"requests": len(sample), "wall_ms": wall_us / 1e3,
                        "device_busy_ms": busy_us / 1e3,
                        "scan_topk_ms": scan_us / 1e3}
    log(f"profile: {len(sample)} requests, wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), scan_topk kernels "
        f"{scan_us / 1e3:.2f} ms ({100 * scan_us / busy_us:.1f}% of device time)")
    if "msearch_batches" not in state:
        return
    queries = state["msearch_batches"][-1]
    for k in (10, 25):
        def batch():
            idx.searcher.msearch("body", queries, k)
            torch.cuda.synchronize()

        wall_us, ops = _profiled(batch)
        busy_us = sum(us for _, us in ops)
        per_kernel = _kernel_us(ops)
        state[f"profile_msearch_k{k}"] = {
            "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            **{f"{n}_ms": us / 1e3 for n, us in per_kernel.items()}}
        log(f"profile: one {len(queries)}-query msearch batch at k={k}, wall "
            f"{wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
            f"({100 * busy_us / wall_us:.1f}%); "
            + ", ".join(f"{n} {us / 1e3:.2f} ms ({100 * us / busy_us:.1f}%)"
                        for n, us in per_kernel.items()))
        for key, us in ops[:10]:
            log(f"  device op {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f}%  {key[:100]}")


def phase_report(device, state: dict) -> None:
    """The card, then a line and a JSON entry for each kernel this run
    measured (all five in a full run)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    if "shapes" in state:
        log("shapes: " + json.dumps(state["shapes"]))
    if "knn_build" in state:
        log("knn_build: " + json.dumps(state["knn_build"]))
    if "knn" in state:
        log("knn: " + json.dumps(state["knn"]))
    rows = state.get("msearch_rows", [])
    per_batch = {n: [(r["k"], r["launches"][n]) for r in rows] for n in KERNEL_OPS}
    measured = {"scan_topk": ("B=512 N=1M k=10 streamed", state.get("scan_msearch")),
                "tiered_candidates": ("B=512 D=896 N=1M kb=64", state.get("tiered")),
                "impact_gather": ("Q=512 R=64 uint16", state.get("impact")),
                "fused_tile_candidates": (state.get("fused", {}).get("shape"), state.get("fused")),
                "ann_gather_scan": (state.get("ann", {}).get("shape"), state.get("ann"))}
    for name, (shape, m) in measured.items():
        if m is None:
            continue
        log(f"kernel {name}: launches per {C1_BATCH}-query batch (k, n) {per_batch[name]}; at {shape}: "
            f"{m['ms']:.4f} ms, bound {m['bound_ms']:.4f} ms ({m['bound_by']}), plain "
            f"{m['plain_ms']:.3f} ms, library "
            + ("none" if m["library_ms"] is None else f"{m['library_ms']:.4f} ms"))
    launches = state.get("msearch_launches", {})  # None below: a count this run did not take
    kernels = []
    if "streamed" in state:
        st = state["streamed"]
        kernels.append({
            "name": "scan_topk",
            "route": "cuda",
            "source": "elasticsearch_tpu_torch/csrc/scan_topk.cu",
            "replaces": "elasticsearch_tpu/ops/kernels.py:114",
            "launches": state["launches"]["scan_topk"] if "launches" in state else None,
            "max_abs_err": state["max_abs_err"],
            "ms": st["ms"],
            "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"],
            "bound_by": "bytes",
            "library_ms": st["library_ms"],
        })
    knn = state.get("knn", {})
    ann_launches = (knn["c4_launches"]["ann_gather_scan"]
                    + knn["search_launches"]["ann_gather_scan"]) if knn else None
    for name, key, replaces, n_launch in (
            ("tiered_candidates", "tiered", "elasticsearch_tpu/ops/kernels.py:301",
             launches.get("tiered_candidates")),
            ("impact_gather", "impact", "elasticsearch_tpu/ops/kernels.py:494",
             launches.get("impact_gather")),
            ("fused_tile_candidates", "fused", "elasticsearch_tpu/ops/fused.py:217",
             launches.get("fused_tile_candidates")),
            ("ann_gather_scan", "ann", "elasticsearch_tpu/ann/kernels.py:139", ann_launches)):
        m = state.get(key)
        if m is None:
            continue
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"elasticsearch_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": n_launch,
            "max_abs_err": m["max_abs_err"],
            "ms": m["ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
        })
    log(json.dumps({"kernels": kernels}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    try:
        from elasticsearch_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the elasticsearch_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    state: dict = {}
    for phase in PHASES:
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        if phase == "build":
            built = _build.build_all()
            for name in built:
                for line in _build.build_log(name).splitlines():
                    if "registers" in line or "Compiling entry" in line:
                        log(f"  ptxas {name}: {line.strip()}")
        elif phase == "kernels":
            phase_kernels(device, rng, args.docs, state)
        elif phase == "index":
            phase_index(device, rng, args.docs, state)
        elif phase == "traffic":
            phase_traffic(device, rng, state)
        elif phase == "cpu":
            phase_cpu(state)
        elif phase == "msearch":
            phase_msearch(device, rng, state)
        elif phase == "msearch_check":
            phase_msearch_check(state)
        elif phase == "msearch_cpu":
            phase_msearch_cpu(state)
        elif phase == "profile":
            phase_profile(state)
        elif phase == "knn_index":
            phase_knn_index(device, rng, KNN_VECTORS, KNN_DOCS, state)
        elif phase == "knn_kernels":
            phase_knn_kernels(device, rng, state)
        elif phase == "knn":
            phase_knn(device, rng, state)
        elif phase == "knn_check":
            phase_knn_check(device, state)
        elif phase == "report":
            phase_report(device, state)
        log(f"phase {phase}: {time.perf_counter() - t0:.2f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
