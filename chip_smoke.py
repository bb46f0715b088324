#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (elasticsearch_tpu_torch) on one card.

    python3 chip_smoke.py [--docs 1000000] [--seed 0] [--phases ...]

Phases, each printing one line with its seconds; any failure raises and the
script exits non-zero with no result line:

  build    nvcc builds every kernel of the package from csrc/ (sm_90a), one
           process per source, all started together.
  kernels  each kernel against its plain PyTorch twin on the card, at the
           main path's shapes and beyond: scan_topk streamed (B=1, N=1M,
           k in {10, 25, 128}, with ties, count_positive on and off) and
           matmul (B=64, D=384, N=1M, every transform). Values equal, ids
           equal on finite lanes, totals equal.
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
  profile  100 of the requests again under torch.profiler: the device's
           busy share of the wall time and scan_topk's share of device time.
  report   the card's name and power limit, then one JSON line per kernel
           with its launches on the main path, time, bound, plain twin's
           time and torch.topk's time on the same input.

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
PHASES = ("build", "kernels", "index", "traffic", "cpu", "profile", "report")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, device) -> float:
    """Mean device ms per call of fn over `iters` calls, after one warm-up
    call. On a card: CUDA events around the calls, queued behind a ~0.1 s
    spin kernel so that the host's time to issue them is hidden and the
    events time the device work back to back. Otherwise the host clock."""
    import torch

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


def phase_profile(state: dict) -> None:
    from torch.profiler import ProfilerActivity, profile

    idx = state["index"]
    sample = state["requests"][:: max(1, len(state["requests"]) // 100)][:100]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q, size, from_ in sample:
            idx.search(q, size=size, from_=from_)
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = 0.0
    scan_us = 0.0
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        us = e.self_device_time_total
        busy_us += us
        if "scan_" in e.key or "merge_kernel" in e.key:
            scan_us += us
    if busy_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    state["profile"] = {"requests": len(sample), "wall_ms": wall_us / 1e3,
                        "device_busy_ms": busy_us / 1e3,
                        "scan_topk_ms": scan_us / 1e3}
    log(f"profile: {len(sample)} requests, wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), scan_topk kernels "
        f"{scan_us / 1e3:.2f} ms ({100 * scan_us / busy_us:.1f}% of device time)")


def phase_report(device, state: dict) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    st = state["streamed"]
    log("shapes: " + json.dumps(state["shapes"]))
    log(json.dumps({"kernels": [{
        "name": "scan_topk",
        "route": "cuda",
        "source": "elasticsearch_tpu_torch/csrc/scan_topk.cu",
        "replaces": "elasticsearch_tpu/ops/kernels.py:114",
        "launches": state["launches"]["scan_topk"],
        "max_abs_err": state["max_abs_err"],
        "ms": st["ms"],
        "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"],
        "bound_by": "bytes",
        "library_ms": st["library_ms"],
    }]}))


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
        elif phase == "profile":
            phase_profile(state)
        elif phase == "report":
            phase_report(device, state)
        log(f"phase {phase}: {time.perf_counter() - t0:.2f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
